"""The port's drivers with ``--bf16`` and ``--bf16 --f32_gridconv`` on the
CPU, where they were refused before the port had bf16.

- ``--eval`` against the JAX pretrain driver with the same flags, on the
  same port-written checkpoint (JAX's ``checkpoint.load`` reads it) and
  synthetic scenes, JAX's model on its exact ball query, as
  tests/test_torch_cli.py's f32 ``--eval`` parity: mAP and AR at 0.25 and
  0.5 equal, the eval-loss means within rtol 1e-3 (eval mode, where the
  bf16 forwards agree within a few 1e-4, tests/test_torch_bf16_steps.py),
  and nearer JAX's bf16 means than the f32 driver's are.
- The chain: pretrain -> SSL (view stats, reference-exact step) -> resume
  -> ``--eval --opt_step 2``, each logging its compute dtype, each
  checkpoint float32 (one state dict for both dtypes).

Training is not held to the JAX drivers' logs: their first steps differ
from the port's in f32 too (the jitter draws, JAX's PRNG against a torch
generator, and the SSL driver's batch, which tests/conftest.py's 8 virtual
devices multiply), and the bf16 step on a tiny model is chaotic.
tests/test_torch_bf16_steps.py and tests/test_torch_bf16_ssl.py hold the
bf16 pretrain and SSL steps to JAX's on the same draws.
"""
import os

import pytest
import torch

from iou3dmatch_tpu_torch.cli import pretrain, train
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.train import checkpoint
from iou3dmatch_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)
TINY = ["--synthetic", "--synthetic_scenes", "8", "--tiny", "--num_point", "512",
        "--num_target", "16", "--num_workers", "2", "--bn_decay_step", "1"]
CPU = ["--device", "cpu"]
PRECISION = {"bf16": ["--bf16"], "bf16_f32_gridconv": ["--bf16", "--f32_gridconv"]}
LOG_LINE = {"bf16": "compute dtype: bfloat16 (GridConv bfloat16), parameters float32",
            "bf16_f32_gridconv": "compute dtype: bfloat16 (GridConv float32), parameters float32"}
EVAL_RTOL = 1e-3


def log_of(d) -> str:
    return open(os.path.join(d, "log_train.txt")).read()


@pytest.mark.parametrize("flags", sorted(PRECISION))
def test_bf16_eval_matches_the_jax_driver(flags, tmp_path, monkeypatch):
    """tests/test_torch_cli.py's ``--eval`` parity, in bf16: a port-written
    checkpoint of a tiny model, 64 proposals on the 8 eval scenes of 32
    synthetic ones; JAX's model on its exact ball query."""
    import iou3dmatch_tpu.cli.common as jax_common
    import iou3dmatch_tpu.models.pointnet2 as jax_pointnet2
    from iou3dmatch_tpu.cli import pretrain as jax_pretrain

    model, _ = build_votenet("scannet", tiny=True, device="cpu",
                             generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, create_train_state(model), epoch=0)
    argv = ["--eval", "--checkpoint_path", path, "--batch_size", "4", "--use_iou_for_nms",
            "--synthetic", "--synthetic_scenes", "32", "--tiny", "--num_point", "512",
            "--num_target", "64", "--num_workers", "2"] + PRECISION[flags]
    got = pretrain.main(["--log_dir", str(tmp_path / "port")] + argv + CPU)
    assert LOG_LINE[flags] in log_of(tmp_path / "port")
    f32 = pretrain.main(["--log_dir", str(tmp_path / "f32")] + [
        a for a in argv if a not in PRECISION[flags]] + CPU)
    exact = jax_pointnet2.ball_query
    monkeypatch.setattr(jax_pointnet2, "ball_query",
                        lambda *a, exact_query=exact, **k: exact_query(*a, **{**k, "exact": True}))
    want = []
    real = jax_common.evaluate
    monkeypatch.setattr(jax_common, "evaluate",
                        lambda *a, **k: want.append(real(*a, **k)) or want[-1])
    jax_pretrain.main(["--log_dir", str(tmp_path / "jax")] + argv)
    (want_means, want_ap, want_sum), = want
    assert got[1][0.25]["mAP"] > 0 and got[1][0.25]["AR"] > 0
    for t in (0.25, 0.5):
        for key in ("mAP", "AR"):
            assert got[1][t][key] == want_ap[t][key], (t, key)
    assert got[2] == want_sum
    assert set(got[0]) == set(want_means) | {"loss"}
    for k, v in want_means.items():
        assert got[0][k] == pytest.approx(v, rel=EVAL_RTOL, abs=1e-6), k
    # bf16, not f32: the f32 driver's means stand further from JAX's bf16 ones
    assert max(abs(f32[0][k] - v) / max(abs(v), 1e-6) for k, v in want_means.items()) > \
        max(abs(got[0][k] - v) / max(abs(v), 1e-6) for k, v in want_means.items())


@pytest.mark.parametrize("flags", sorted(PRECISION))
def test_bf16_chain_pretrain_ssl_resume_eval(flags, tmp_path):
    pre, ssl = str(tmp_path / "pre"), str(tmp_path / "ssl")
    precision = PRECISION[flags]
    pretrain.main(["--log_dir", pre, "--batch_size", "2", "--max_epoch", "1", "--eval_interval",
                   "1", "--print_interval", "2"] + TINY + CPU + precision)
    train.main(["--log_dir", ssl, "--detector_checkpoint", os.path.join(pre, "checkpoint.tar"),
                "--batch_size", "1,2", "--max_epoch", "1", "--eval_interval", "5",
                "--print_interval", "2", "--view_stats", "--reference_exact_step"]
               + TINY + CPU + precision)
    train.main(["--log_dir", ssl, "--resume", "--batch_size", "1,2", "--max_epoch", "2",
                "--eval_interval", "5", "--print_interval", "8"] + TINY + CPU + precision)
    _, ap, map_sum = train.main(["--log_dir", ssl, "--resume", "--eval", "--use_iou_for_nms",
                                 "--opt_step", "2", "--opt_rate", "0.01", "--batch_size", "1,2"]
                                + TINY + CPU + precision)
    assert set(ap) == {0.25, 0.5} and map_sum == ap[0.25]["mAP"] + ap[0.5]["mAP"]
    for d in (pre, ssl):
        log = log_of(d)
        assert log.count(LOG_LINE[flags]) == (1 if d == pre else 3), d
        assert "compute dtype: float32" not in log
    assert "resumed from" in log_of(ssl) and "unsupervised_loss" in log_of(ssl)
    ckpt = torch.load(os.path.join(ssl, "checkpoint.tar"), weights_only=True)
    assert ckpt["step"] == 16
    for key in ("model_state_dict", "ema_model_state_dict"):
        for k, v in ckpt[key].items():
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), (key, k)
