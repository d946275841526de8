"""The model knobs the drivers' flags reach, against the flax modules.

For each setting one tiny JAX VoteNet (ScanNet config, ``tiny=True``: 64
seeds, 16 proposals) is initialised, its BN running statistics perturbed
away from (0, 1), and its weights carried into the port's model built with
the same knobs by ``state_dict_from_jax``:

- ``sampling="vote_fps"`` with ``vote_factor`` 1 and 2 (FPS over 64 and 128
  votes);
- ``sampling="random"``: the port is fed the indices JAX's
  ``jax.random.randint`` draws from the key the JAX forward is given;
- ``fps_prefix=False``: FPS in SA2-SA4 and ``seed_fps``;
- ``query_feats`` ``"vote"`` and ``"seed+vote"``: GridConv on the votes'
  xyz and features, or the seeds' xyz with the votes' features.

JAX's drivers set neither ``query_feats`` nor ``fps_prefix``; both reach
``build_votenet``.

Checked: the eval forward (indices exactly; floats within atol 1e-4, the
tolerance of ``tests/test_torch_models.py``: the same f32 math summed in
another order), and for every setting but ``random`` ``forward_onlyiou``'s
IoU logits (atol 1e-4) and the gradient of their sum at the argmax classes
with respect to center and size, within 2e-3 of the largest gradient entry
(``tests/test_torch_iou_opt.py``'s tolerance: JAX interpolates by one-hot
matmuls, the port by a gather). ``random`` without a generator or indices
raises, and draws from the generator it is given. ``fps_prefix`` False and
True give equal outputs in the port, as in JAX. The pretrain step of each
new setting is held to JAX's in ``tests/test_torch_knob_steps.py``.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
KEYS = ("center", "objectness_scores", "heading_scores", "size_scores", "size_residuals",
        "sem_cls_scores", "vote_xyz", "vote_features", "aggregated_vote_xyz", "iou_scores")
KNOBS = {
    "vote_fps": dict(sampling="vote_fps"),
    "vote_fps_vf2": dict(sampling="vote_fps", vote_factor=2),
    "random": dict(sampling="random"),
    "no_fps_prefix": dict(fps_prefix=False),
    "query_vote": dict(query_feats="vote"),
    "query_seed_vote": dict(query_feats="seed+vote"),
}


def _scenes(seed, b=2, n=2048):
    rng = np.random.RandomState(seed)
    pc = np.zeros((b, n, 4), np.float32)
    pc[..., 0:3] = rng.uniform(-3.0, 3.0, (b, n, 3))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    return pc


def _perturb_batch_stats(variables, seed=5):
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        names = [p.key for p in path]
        if names[0] != "batch_stats":
            return x
        if names[-1] == "mean":
            return (rng.randn(*x.shape) * 0.05).astype(x.dtype)
        return (1.0 + rng.uniform(-0.2, 0.2, x.shape)).astype(x.dtype)

    return jtu.tree_map_with_path(perturb, variables)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(name, JAX model, variables, port model, clouds, JAX end points,
    the key the JAX forward drew its random indices from)."""
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    kw = KNOBS[name]
    jm, _ = build_jax("scannet", tiny=True, **kw)
    pc = _scenes(11)
    key = jax.random.PRNGKey(9)
    # the JAX drivers never pass the sampling key (ROADMAP Queue 3); the
    # module takes it when it is given
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(4)}, x, train=False,
                                          rng=key))(jnp.asarray(pc))
    variables = _perturb_batch_stats(jax.tree.map(np.asarray, variables))
    pm, _ = build_votenet("scannet", tiny=True, device="cpu", **kw)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    ep = jax.jit(lambda v, x: jm.apply(v, x, train=False, rng=key))(variables, jnp.asarray(pc))
    return name, jm, variables, pm, pc, {k: np.asarray(v) for k, v in ep.items()}, key


def _port_forward(pm, pc, name, key):
    kw = {}
    if name == "random":
        kw["sample_inds"] = torch.from_numpy(np.array(
            jax.random.randint(key, (pc.shape[0], pm.pnet.num_proposal), 0, 64, dtype=jnp.int32)))
    with torch.no_grad():
        return pm(torch.from_numpy(pc), **kw)


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_forward_matches_flax(name):
    _, _, _, pm, pc, want, key = _case(name)
    got = _port_forward(pm, pc, name, key)
    for k in ("sa1_inds", "sa2_inds", "aggregated_vote_inds"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=ATOL, err_msg=k)
    n_vote = 64 * KNOBS[name].get("vote_factor", 1)
    assert want["vote_xyz"].shape[1] == n_vote
    inds = want["aggregated_vote_inds"]
    if name.startswith("vote_fps"):  # FPS over the votes: its first pick is vote 0
        assert (inds[:, 0] == 0).all() and len(np.unique(inds[0])) == 16 and inds.max() < n_vote


@pytest.mark.parametrize("name", ["vote_fps", "vote_fps_vf2", "no_fps_prefix", "query_vote",
                                  "query_seed_vote"])
def test_forward_onlyiou_gradient_matches_flax(name):
    _, jm, variables, pm, _, ep, _ = _case(name)
    sem = np.argmax(ep["sem_cls_scores"], -1)

    def jax_sum(center, size):
        iou = jm.apply(variables, dict(ep), center, size, jnp.asarray(ep["heading"]),
                       method=jm.forward_onlyiou)["iou_scores"]
        return jnp.sum(jnp.take_along_axis(iou, jnp.asarray(sem)[..., None], axis=2)), iou

    (_, want_iou), want_grads = jax.jit(jax.value_and_grad(jax_sum, argnums=(0, 1), has_aux=True))(
        jnp.asarray(ep["center"]), jnp.asarray(ep["size"]))
    tep = {k: torch.from_numpy(v.copy()) for k, v in ep.items()}
    c = tep["center"].clone().requires_grad_(True)
    s = tep["size"].clone().requires_grad_(True)
    iou = pm.forward_onlyiou(tep, c, s, tep["heading"])["iou_scores"]
    torch.gather(iou, 2, torch.from_numpy(sem)[..., None]).sum().backward()
    np.testing.assert_allclose(iou.detach().numpy(), np.asarray(want_iou), rtol=0, atol=ATOL)
    for got, want in zip((c.grad, s.grad), want_grads):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_random_sampling_draws_from_the_generator_given():
    pm, _ = build_votenet("scannet", tiny=True, device="cpu", sampling="random")
    pc = torch.from_numpy(_scenes(12))
    with torch.no_grad(), pytest.raises(ValueError, match="explicit generator"):
        pm(pc)
    with torch.no_grad():
        a = pm(pc, generator=torch.Generator().manual_seed(3))["aggregated_vote_inds"]
        b = pm(pc, generator=torch.Generator().manual_seed(3))["aggregated_vote_inds"]
        c = pm(pc, generator=torch.Generator().manual_seed(4))["aggregated_vote_inds"]
    want = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    assert torch.equal(a, want) and torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32
    # the jitter comes after the indices, from the same generator
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        ep = pm.forward_with_pred_jitter(pc, generator=g)
    g2 = torch.Generator().manual_seed(5)
    inds = torch.randint(0, 64, (2, 16), generator=g2, dtype=torch.int32)
    noise = tuple(torch.randn((2, 16, 3), generator=g2) for _ in range(2))
    with torch.no_grad():
        again = pm.forward_with_pred_jitter(pc, noise=noise, sample_inds=inds)
    assert torch.equal(ep["aggregated_vote_inds"], inds)
    assert torch.equal(ep["iou_scores_jitter"], again["iou_scores_jitter"])
    # the eval entry points pass their generator on
    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.train.steps import make_eval_forward, make_eval_loss

    out = make_eval_forward(pm, generator=torch.Generator().manual_seed(3))(pc)
    with torch.no_grad():
        want = pm(pc, sample_inds=a)
    assert torch.equal(out["center"], want["center"])
    labels = {"center_label": torch.zeros(2, 64, 3), "box_label_mask": torch.zeros(2, 64),
              "heading_class_label": torch.zeros(2, 64, dtype=torch.int64),
              "heading_residual_label": torch.zeros(2, 64),
              "size_class_label": torch.zeros(2, 64, dtype=torch.int64),
              "size_residual_label": torch.zeros(2, 64, 3),
              "sem_cls_label": torch.zeros(2, 64, dtype=torch.int64),
              "vote_label": torch.zeros(2, 2048, 9),
              "vote_label_mask": torch.zeros(2, 2048, dtype=torch.int64)}
    out, _ = make_eval_loss(pm, get_config("scannet"),
                            generator=torch.Generator().manual_seed(3))(pc, labels)
    assert torch.equal(out["center"], want["center"])


def test_random_sampling_trains_where_the_jax_drivers_cannot():
    """The JAX fault of ROADMAP Queue 3: ``create_train_state`` (as its
    drivers call it) never passes the sampling key, and
    ``jax.random.randint`` refuses ``None``; the port's pretrain step draws
    its indices from ``state.generator``."""
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax
    from iou3dmatch_tpu.train.state import create_train_state as jax_state

    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.train.state import create_train_state
    from iou3dmatch_tpu_torch.train.steps import make_pretrain_step

    jm, _ = build_jax("scannet", tiny=True, sampling="random")
    pc = _scenes(13, b=1, n=512)
    with pytest.raises(TypeError, match="PRNG key"):
        jax_state(jm, jax.random.PRNGKey(0), {"point_clouds": jnp.asarray(pc)})

    from iou3dmatch_tpu_torch.data.synthetic import SyntheticDataset
    from iou3dmatch_tpu_torch.data.loader import collate

    ds = SyntheticDataset("scannet", num_scenes=2, num_points=512, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in collate([ds[0], ds[1]]).items()}
    pm, _ = build_votenet("scannet", tiny=True, device="cpu", sampling="random")
    state = create_train_state(pm, seed=3)
    metrics = make_pretrain_step(get_config("scannet"))(state, batch, 1e-3, 0.5)
    assert torch.isfinite(metrics["loss"]) and state.step == 1


@pytest.mark.parametrize("sampling", ["seed", "random_fps"])
def test_unknown_sampling_raises(sampling):
    with pytest.raises(ValueError):
        build_votenet("scannet", tiny=True, device="cpu", sampling=sampling)


def test_fps_prefix_shortcut_is_exact_in_the_port():
    """fps_prefix False (FPS in SA2-SA4 and seed_fps) and True (their
    prefixes) give equal end points on the CPU: JAX's
    test_fps_prefix_shortcut_is_exact on the port."""
    pc = torch.from_numpy(_scenes(14))
    out = {}
    for prefix in (True, False):
        pm, _ = build_votenet("scannet", tiny=True, device="cpu", fps_prefix=prefix)
        with torch.no_grad():
            out[prefix] = pm(pc)
    for k, v in out[False].items():
        assert torch.equal(v, out[True][k]), k
    assert not torch.equal(out[False]["sa2_inds"][:, 1:],
                           torch.zeros_like(out[False]["sa2_inds"][:, 1:]))


def test_query_feats_reads_the_origins_it_names():
    """GridConv's IoU logits move with the features it reads: "vote" and
    "seed+vote" differ from "seed" and from each other, on one model's
    weights."""
    pc = torch.from_numpy(_scenes(15))
    pm, _ = build_votenet("scannet", tiny=True, device="cpu")
    state = pm.state_dict()
    iou = {}
    for q in ("seed", "vote", "seed+vote"):
        m, _ = build_votenet("scannet", tiny=True, device="cpu", query_feats=q)
        m.load_state_dict(state, strict=True)
        with torch.no_grad():
            iou[q] = m(pc)["iou_scores"]
    assert not torch.equal(iou["seed"], iou["vote"])
    assert not torch.equal(iou["vote"], iou["seed+vote"])
    assert not torch.equal(iou["seed"], iou["seed+vote"])


def test_seed_plus_vote_with_more_than_one_vote_a_seed_raises_in_both():
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    jm, _ = build_jax("scannet", tiny=True, query_feats="seed+vote", vote_factor=2)
    pc = jnp.asarray(_scenes(16, b=1, n=512))
    with pytest.raises(TypeError, match="contracting dimensions"):
        jm.init({"params": jax.random.PRNGKey(0)}, pc, train=False)
    with pytest.raises(ValueError, match="vote_factor 1"):
        build_votenet("scannet", tiny=True, device="cpu", query_feats="seed+vote", vote_factor=2)


@pytest.mark.parametrize("kw", [dict(query_feats="votes"), dict(query_feats=None),
                                dict(fps_prefix="prefix"), dict(fps_prefix=None)])
def test_build_votenet_refuses_values_jax_does_not_take(kw):
    with pytest.raises(ValueError):
        build_votenet("scannet", tiny=True, device="cpu", **kw)
