"""The port's SSL driver under a 2-rank ``gloo`` group on the CPU, and the
pretrain driver's refusal.

``cli/train.main`` runs in two ranks as torchrun starts them
(tests/torch_parallel_ranks.py sets torchrun's environment; the driver
joins the group itself) on ``--synthetic --tiny --device cpu`` with
``--batch_size 1,2``, one epoch of 2 steps and an eval, and in this process
at ``--batch_size 2,4``: the same global batches. The ranks' log (rank 0's
alone) carries the data-parallel line and the group's backend line, only
rank 0 writes files, the first step's logged metrics equal the
one-process run's to the log's 4 decimals, and the checkpoint equals the
one-process run's: the step count, the generator state and the epoch exactly; the change over
the two steps of both models' BN running statistics with cosine > 0.99999
and relative L2 < 5e-3, and of their parameters with cosine > 0.99 and
relative L2 < 0.1. Those last bounds are wide because the driver's Adam
(eps 1e-8) steps by about lr x sign(g): float32 noise in a small gradient
element flips its step, and the flips spread (measured here: 0.998 and
0.061). A rank that normalised with its own BN statistics, or stepped on
its own gradient, would move the running statistics by a share of their
change and flip the sign of a large share of the steps. The step tests
(tests/test_torch_parallel_steps.py) hold the float64 step to rtol 1e-9.
``cli/pretrain.main`` under ``WORLD_SIZE=2``
raises by name.
"""
import os

import numpy as np
import pytest
import torch

from iou3dmatch_tpu_torch.cli import pretrain, train
from iou3dmatch_tpu_torch.data.config import get_config  # noqa: F401
from torch_parallel_ranks import start

torch.set_num_threads(1)
FLAGS = ["--synthetic", "--synthetic_scenes", "4", "--tiny", "--num_point", "512",
         "--num_target", "16", "--num_workers", "2", "--bn_decay_step", "1", "--device", "cpu",
         "--max_epoch", "1", "--eval_interval", "1", "--print_interval", "1", "--view_stats",
         "--reference_exact_step"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("driver")
    ranks_dir, one_dir = d / "ranks", d / "one"
    torch.save({"argv": ["--log_dir", str(ranks_dir), "--batch_size", "1,2"] + FLAGS},
               d / "driver.pt")
    ranks = start("driver", d)
    try:
        train.main(["--log_dir", str(one_dir), "--batch_size", "2,4"] + FLAGS)
    finally:
        ranks.join()
    return ranks_dir, one_dir


def _start_weights():
    from iou3dmatch_tpu_torch.models.factory import build_votenet

    model, _ = build_votenet("scannet", tiny=True, num_proposal=16, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return {k: v for k, v in model.state_dict().items()}


def _update(ckpt, key, start, names):
    sd = ckpt[key]
    return np.concatenate([(sd[k] - start[k]).numpy().ravel().astype(np.float64) for k in names])


def first_step_metrics(log: str) -> dict:
    line = next(x for x in log.splitlines() if x.startswith(" batch 0001 "))
    parts = line.split()[2:]
    return {k.rstrip(":"): float(v) for k, v in zip(parts[::2], parts[1::2])}


def test_two_ranks_train_the_one_process_global_batch(runs):
    ranks_dir, one_dir = runs
    got, want = (first_step_metrics((d / "log_train.txt").read_text()) for d in runs)
    assert got.keys() == want.keys() and len(got) > 40
    for k, v in want.items():  # the log's 4 decimals
        assert abs(got[k] - v) <= 1e-4 + 1e-4 * abs(v), (k, got[k], v)
    got = torch.load(ranks_dir / "checkpoint.tar", weights_only=True)
    want = torch.load(one_dir / "checkpoint.tar", weights_only=True)
    assert got["epoch"] == want["epoch"] == 1 and got["step"] == want["step"] == 2
    assert torch.equal(got["generator_state"], want["generator_state"])
    start_w = _start_weights()
    for key in ("model_state_dict", "ema_model_state_dict"):
        assert got[key].keys() == want[key].keys()
        for part, min_cos, max_rel in (("running", 0.99999, 5e-3), ("param", 0.99, 0.1)):
            names = sorted(k for k in want[key] if ("running" in k) == (part == "running"))
            g, w = _update(got, key, start_w, names), _update(want, key, start_w, names)
            cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
            rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
            assert cos > min_cos and rel < max_rel, (key, part, cos, rel)


def test_rank_0_alone_logs_and_writes(runs):
    ranks_dir, one_dir = runs
    log = (ranks_dir / "log_train.txt").read_text()
    assert "data-parallel over 2 devices: per-device batch 1+2, global 2+4" in log
    assert "distributed: rank 0 of 2, local rank 0 of 2, device cpu, backend gloo (CPU)" in log
    assert "distributed: rank 1" not in log
    assert log.count("**** EPOCH 000 ****") == 1 and "eval mAP@0.25" in log
    one = (one_dir / "log_train.txt").read_text()
    assert "data-parallel" not in one and "distributed:" not in one
    assert sorted(os.listdir(ranks_dir)) == sorted(os.listdir(one_dir))


def test_pretrain_refuses_a_group(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="runs in one process"):
        pretrain.main(["--log_dir", str(tmp_path / "log"), "--device", "cpu"])
    assert not (tmp_path / "log").exists()
