"""The port's ``parallel/`` on the CPU: collectives, sharding and BatchNorm
over a 2-rank ``gloo`` group.

- Without a process group every function of ``parallel/`` is the identity
  (``all_reduce_sum`` and the other collectives give back their input,
  ``shard_train_step`` the step, ``replicate`` the state), and a step run
  under an inactive group is the plain step bit for bit.
- ``shard_batch``: rank r's rows ``[L_r; U_r]`` of an SSL batch, label-only
  keys at ``L_r``; JAX's error on an indivisible batch, naming
  "per-device" (``tests/test_train.py:211-221`` is the spec).
- In a group of 2 ranks spawned once for the module
  (``tests/torch_parallel_ranks.py``): ``all_reduce_sum``'s gradient is
  the sum over ranks of the shares' gradients, ``global_sum``,
  ``global_mean``, ``all_reduce_grads``, ``all_reduce_metrics``,
  ``replicate`` (rank 0's weights and buffers on both ranks),
  ``shard_batch`` on each rank, a group of the first rank alone
  (``make_mesh(1)``) and the collectives counted.
- Train-mode ``BatchNorm`` under the group against one process on all the
  rows, in float64 (rtol 1e-12) and float32 (rtol 1e-5, atol 1e-6): output,
  running statistics and the gradients of input, weight and bias, with
  equal and unequal rows per rank.
"""
import numpy as np
import pytest
import torch

from iou3dmatch_tpu_torch.models.mlp import BatchNorm
from iou3dmatch_tpu_torch.parallel import (DataGroup, collectives, host_local_batch_to_global,
                                           make_global_mesh, make_mesh, replicate, shard_batch,
                                           shard_train_step, take_rows)
from iou3dmatch_tpu_torch.parallel import distributed

from torch_parallel_ranks import start

torch.set_num_threads(1)


def ssl_batch(bl=4, bu=8, g=5):
    """An SSL batch's shapes: keys of every row, and a label-only key."""
    n = bl + bu
    rng = np.random.RandomState(0)
    return {"point_clouds": torch.from_numpy(rng.randn(n, 16, 4).astype(np.float32)),
            "flip_x_axis": torch.arange(n),
            "center_label": torch.from_numpy(rng.randn(n, g, 3).astype(np.float32)),
            "vote_label": torch.arange(bl * 2.0).reshape(bl, 2),
            "supervised_mask": np.r_[np.ones(bl), np.zeros(bu)]}


def test_without_a_group_every_function_is_the_identity():
    x = torch.randn(3, requires_grad=True)
    assert collectives.current() is None and collectives.world() == 1
    assert collectives.all_reduce_sum(x) is x
    assert collectives.global_sum(x) is x
    assert collectives.global_mean(x, 5) is x
    metrics = {"loss": torch.tensor(1.0)}
    assert collectives.all_reduce_metrics(metrics) is metrics
    x.grad = torch.ones(3)
    collectives.all_reduce_grads([x])
    assert torch.equal(x.grad, torch.ones(3))
    single = make_global_mesh()
    assert single == DataGroup() and make_mesh() == DataGroup()
    with collectives.active(single):  # no process group: nothing activates
        assert collectives.current() is None

    def step(*a, **k):
        return a

    assert shard_train_step(step, single) is step
    state = object()
    assert replicate(state, single) is state
    batch = {"a": torch.ones(2)}
    assert host_local_batch_to_global(batch, single) is batch
    distributed.barrier(single)  # returns at once


def test_a_step_under_an_inactive_group_is_the_plain_step_bit_for_bit():
    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.models.factory import build_votenet
    from iou3dmatch_tpu_torch.train.state import create_train_state
    from iou3dmatch_tpu_torch.train.steps import make_pretrain_step

    from test_torch_train import labels_near, scenes

    cfg = get_config("scannet")
    pc = scenes(7, 2, 1024)
    batch = {k: torch.from_numpy(v) for k, v in labels_near(8, pc[:, :64, :3], cfg).items()}
    batch["vote_label"] = batch["vote_label"][:, :1024]
    batch["vote_label_mask"] = batch["vote_label_mask"][:, :1024]
    batch["point_clouds"] = torch.from_numpy(pc)
    runs = []
    for wrap in (False, True):
        model, _ = build_votenet("scannet", tiny=True, device="cpu")
        state = create_train_state(model, seed=3)
        step = make_pretrain_step(cfg)
        if wrap:
            step = shard_train_step(step, DataGroup())
        metrics = [step(state, batch, 1e-3, 0.5) for _ in range(2)]
        runs.append((metrics, model.state_dict()))
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_shard_batch_gives_each_rank_its_labeled_and_unlabeled_rows():
    batch = ssl_batch()
    for r, (l_rows, u_rows) in enumerate((([0, 1], [4, 5, 6, 7]), ([2, 3], [8, 9, 10, 11]))):
        got = shard_batch(batch, DataGroup(rank=r, world=2), num_labeled=4)
        rows = l_rows + u_rows
        assert torch.equal(got["point_clouds"], batch["point_clouds"][rows])
        assert torch.equal(got["flip_x_axis"], torch.tensor(rows))
        assert torch.equal(got["center_label"], batch["center_label"][rows])
        assert torch.equal(got["vote_label"], batch["vote_label"][l_rows])
        assert np.array_equal(got["supervised_mask"], [1, 1, 0, 0, 0, 0])
        assert take_rows(np.arange(12), r, 2, 4, 8).tolist() == rows
    # a pretrain batch: contiguous rows
    got = shard_batch({"point_clouds": torch.arange(8)}, DataGroup(rank=1, world=4))
    assert got["point_clouds"].tolist() == [2, 3]


def test_shard_batch_rejects_indivisible():
    """As tests/test_train.py::test_shard_batch_rejects_indivisible: 12 rows
    on 8 ranks fail fast with a message about per-device batch sizes."""
    with pytest.raises(ValueError, match="per-device"):
        shard_batch(ssl_batch(4, 8), DataGroup(rank=0, world=8), num_labeled=4)
    with pytest.raises(ValueError, match="per-device"):  # 3 labeled rows on 2 ranks
        shard_batch({"point_clouds": torch.zeros(8)}, DataGroup(rank=0, world=2), num_labeled=3)


@pytest.fixture(scope="module")
def collective_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    inputs = {"weights": [0.25, 1.5], "batch": ssl_batch(), "num_labeled": 4}
    torch.save(inputs, d / "collectives.pt")
    return inputs, start("collectives", d).join()


def test_all_reduce_sum_backward_sums_the_shares_gradients(collective_ranks):
    inputs, ranks = collective_ranks
    w = sum(inputs["weights"])
    for out in ranks:
        assert out["outside_is_input"]
        assert torch.equal(out["y"], torch.full((3,), 2.0 * (1 + 2), dtype=torch.float64))
        assert torch.equal(out["x_grad"], torch.full((3,), 2.0 * w, dtype=torch.float64))
        assert out["world"] == 2


def test_global_sum_mean_grads_and_metrics(collective_ranks):
    _, ranks = collective_ranks
    for out in ranks:
        assert out["global_sum"].tolist() == [3.0, 10.0]
        # means 1 of 2 items and 2 of 3: (2 + 6) / 5
        assert torch.equal(out["global_mean"], torch.tensor([8.0]) / 5.0)
        assert out["grads"][0].tolist() == [[3.0, 3.0], [3.0, 3.0]]
        assert out["grads"][1].tolist() == [30.0] * 3
        assert float(out["metrics"]["a"]) == 2.0 and float(out["metrics"]["b"]) == 2.0
        assert out["metrics"]["a"].dtype == torch.float32
        assert out["metrics"]["b"].dtype == torch.float64
    # all_reduce_sum's forward and backward, the four others once each, and
    # rank 0's sum in the group of one rank; one broadcast of float32 tensors
    assert [out["counts"] for out in ranks] == [{"all_reduce": 7, "broadcast": 1},
                                                {"all_reduce": 6, "broadcast": 1}]


def test_replicate_gives_every_rank_rank_0s_models(collective_ranks):
    _, (r0, r1) = collective_ranks
    assert r0["replicated"].keys() == r1["replicated"].keys()
    for k, v in r0["replicated"].items():
        assert torch.equal(v, r1["replicated"][k]), k


def test_shard_batch_and_a_group_of_one_rank_in_the_group(collective_ranks):
    inputs, ranks = collective_ranks
    for r, out in enumerate(ranks):
        want = shard_batch(inputs["batch"], DataGroup(rank=r, world=2), num_labeled=4)
        for k, v in want.items():
            assert np.array_equal(np.asarray(out["shard"][k]), np.asarray(v)), k
    assert ranks[0]["sub"] == (0, 1) and ranks[1]["sub"] is None
    assert ranks[0]["sub_sum"].tolist() == [5.0]


BN_ROWS = {"equal": ((0, 2), (2, 4)), "unequal": ((0, 1), (1, 4))}  # scenes of each rank


def bn_case(dtype, rows, seed):
    rng = np.random.RandomState(seed)
    c = 24
    x = torch.from_numpy(rng.randn(4, 50, c) * 3.0 + rng.randn(c) * 5.0).to(dtype)
    return {"x": x, "g": torch.from_numpy(rng.randn(4, 50, c)).to(dtype), "rows": rows,
            "momentum": 0.3, "dtype": dtype,
            "state": {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, c)).to(dtype),
                      "bias": torch.from_numpy(rng.randn(c)).to(dtype),
                      "running_mean": torch.from_numpy(rng.randn(c)).to(dtype),
                      "running_var": torch.from_numpy(rng.uniform(0.5, 2, c)).to(dtype)}}


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("bn")
    cases = [bn_case(dtype, rows, i) for i, (dtype, rows) in enumerate(
        (dt, r) for dt in (torch.float64, torch.float32) for r in BN_ROWS.values())]
    torch.save({"cases": cases}, d / "bn.pt")
    return cases, start("bn", d).join()


@pytest.mark.parametrize("i,what", [(0, "float64 equal"), (1, "float64 unequal"),
                                    (2, "float32 equal"), (3, "float32 unequal")])
def test_batchnorm_under_a_group_is_one_process_on_all_rows(bn_ranks, i, what):
    cases, ranks = bn_ranks
    case = cases[i]
    bn = BatchNorm(case["x"].shape[-1]).to(case["dtype"])
    bn.load_state_dict(case["state"])
    bn.momentum = case["momentum"]
    x = case["x"].clone().requires_grad_(True)
    y = bn(x)
    y.backward(case["g"])
    rtol, atol = (1e-12, 1e-12) if case["dtype"] == torch.float64 else (1e-5, 1e-6)

    def close(got, want, what):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=what)

    close(torch.cat([r[i]["y"] for r in ranks]), y, "output")
    close(torch.cat([r[i]["x_grad"] for r in ranks]), x.grad, "input gradient")
    for out in ranks:
        close(out[i]["weight_grad"], bn.weight.grad, "weight gradient")
        close(out[i]["bias_grad"], bn.bias.grad, "bias gradient")
        close(out[i]["running_mean"], bn.running_mean, "running mean")
        close(out[i]["running_var"], bn.running_var, "running variance")
    for k in ("running_mean", "running_var", "weight_grad"):
        assert torch.equal(ranks[0][i][k], ranks[1][i][k]), k
