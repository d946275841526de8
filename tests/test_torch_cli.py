"""The port's drivers on the CPU: flags, startup refusals, the driver chain
and ``--eval`` against the JAX driver.

- Flag parity: ``vars(parse_args(argv))`` of each port driver equals the
  JAX driver's for ``[]`` and for ``tests/test_cli.py``'s argvs, but for
  JAX's ``platform`` and the port's ``device``.
- Startup: with no CUDA and no ``--device`` a driver raises. No flag is
  refused on the card: ``--bf16`` and ``--f32_gridconv`` run
  (tests/test_torch_bf16_cli.py), and so does a ``--num_target`` past the
  1,024 boxes of NMS's cluster path (``ops/nms.py::MAX_BOXES``):
  ``driver_device`` accepts it on a mocked card, and the pretrain driver's
  ``--eval`` at ``--cluster_sampling vote_fps --vote_factor 2`` with 1,025
  and 2,048 proposals gives JAX's mAP and AR.
- The chain ``run_pretrain_torch.sh`` -> ``run_train_torch.sh`` ->
  ``run_eval_opt_torch.sh`` on ``--synthetic --tiny --device cpu`` in
  ``tmp_path`` (``tests/test_cli.py:75``'s recipe): every file the drivers
  write (logs, ``best.txt``, the checkpoints, TensorBoard events, the
  profiler trace, the dumps), the resumed epoch count, ``--eval_use_ema``
  scoring the saved teacher, a SUN RGB-D pretrain and eval, a non-finite
  loss writing ``nan_checkpoint.tar``, and ``--overwrite``'s prompt.
- ``--eval`` parity: the port's pretrain ``--eval`` and JAX's (its model on
  its exact ball query, see the test), on the same port-written checkpoint
  and synthetic scenes, give equal mAP and AR at 0.25 and 0.5, and
  eval-loss means within rtol 1e-4 (the pretrain driver: its batch is not
  scaled by the 8 virtual JAX devices of ``tests/conftest.py``).
"""
import argparse
import glob
import os

import pytest
import torch

from iou3dmatch_tpu.cli import pretrain as jax_pretrain
from iou3dmatch_tpu.cli import train as jax_train

from iou3dmatch_tpu_torch.cli import common
from iou3dmatch_tpu_torch.cli import pretrain, train

torch.set_num_threads(1)
TINY = ["--synthetic", "--synthetic_scenes", "8", "--tiny", "--num_point", "512",
        "--num_target", "16", "--num_workers", "2", "--bn_decay_step", "1"]
CPU = ["--device", "cpu"]
ARGVS = {  # tests/test_cli.py's
    "pretrain": [[], ["--vote_factor", "2", "--use_sunrgbd_v2", "--iou_weight", "0.5",
                      "--dump_dir", "/tmp/d", "--overwrite", "--ap_iou_thresh", "0.5"]],
    "train": [[], ["--conf_thresh", "0.1", "--model", "votenet", "--vote_factor", "3",
                   "--ap_iou_thresh", "0.5"],
              ["--eval", "--use_iou_for_nms", "--opt_step", "10", "--opt_rate", "0.05"]],
}


@pytest.mark.parametrize("driver,i", [(d, i) for d, argvs in ARGVS.items()
                                      for i in range(len(argvs))])
def test_flags_match_the_jax_drivers(driver, i):
    port, jax_mod = {"pretrain": (pretrain, jax_pretrain), "train": (train, jax_train)}[driver]
    argv = ARGVS[driver][i]
    got, want = vars(port.parse_args(argv)), vars(jax_mod.parse_args(argv))
    assert want.pop("platform") is None and got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("driver", ["pretrain", "train"])
def test_flag_types_and_choices_match(driver, monkeypatch):
    port, jax_mod = {"pretrain": (pretrain, jax_pretrain), "train": (train, jax_train)}[driver]
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", lambda self, argv=None: self)

    def actions(mod):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices, a.nargs, a.const)
                for a in mod.parse_args([])._actions if a.dest not in ("platform", "device")}

    assert actions(port) == actions(jax_mod)


def test_no_cuda_raises_without_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for driver in (pretrain, train):
        with pytest.raises(RuntimeError, match="--device cpu"):
            driver.main(["--log_dir", str(tmp_path / "log")] + TINY)
    assert common.driver_device(pretrain.parse_args(CPU)) == torch.device("cpu")
    assert common.driver_device(pretrain.parse_args(CPU + ["--num_target", "1025"])).type == "cpu"


def _events(d):
    return glob.glob(os.path.join(d, "events.out.tfevents.*"))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """run_pretrain -> run_train (view stats, reference-exact step) on the
    CPU; returns the root and the pretrain driver's log dir."""
    root = tmp_path_factory.mktemp("chain")
    pre = str(root / "pre")
    pretrain.main(["--log_dir", pre, "--batch_size", "2", "--max_epoch", "2",
                   "--eval_interval", "2", "--print_interval", "1", "--save_interval", "2",
                   "--profile_steps", "1"] + TINY + CPU)
    ssl = str(root / "ssl")
    train.main(["--log_dir", ssl, "--detector_checkpoint", os.path.join(pre, "checkpoint.tar"),
                "--batch_size", "1,2", "--max_epoch", "1", "--eval_interval", "1",
                "--print_interval", "2", "--view_stats", "--reference_exact_step"] + TINY + CPU)
    return root, pre, ssl


def test_pretrain_writes_its_files(chain):
    _, pre, _ = chain
    for name in ("log_train.txt", "checkpoint.tar", "checkpoint_2.tar", "best_checkpoint_sum.tar",
                 "best.txt", os.path.join("profile", "trace.json")):
        assert os.path.getsize(os.path.join(pre, name)) > 0, name
    log = open(os.path.join(pre, "log_train.txt")).read()
    assert "**** EPOCH 001 ****" in log and " batch 0004 " in log and "eval mAP@0.5" in log
    assert open(os.path.join(pre, "best.txt")).read().startswith("epoch 2: mAP sum ")
    for sub in ("train", "eval"):
        assert len(_events(os.path.join(pre, "tb", sub))) == 1
    ckpt = torch.load(os.path.join(pre, "checkpoint.tar"), weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 8 and "ema_model_state_dict" not in ckpt


def test_ssl_then_resume_then_eval_with_optimisation(chain):
    _, _, ssl = chain
    ckpt = torch.load(os.path.join(ssl, "checkpoint.tar"), weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 8 and "ema_model_state_dict" in ckpt
    log = open(os.path.join(ssl, "log_train.txt")).read()
    assert "unsupervised_loss" in log and "true_unlabeled_obj_acc" in log and "eval mAP@0.25" in log
    assert os.path.exists(os.path.join(ssl, "best.txt"))

    train.main(["--log_dir", ssl, "--resume", "--batch_size", "1,2", "--max_epoch", "2",
                "--eval_interval", "5", "--print_interval", "8"] + TINY + CPU)
    log = open(os.path.join(ssl, "log_train.txt")).read()
    assert "resumed from" in log and "**** EPOCH 001 ****" in log
    assert torch.load(os.path.join(ssl, "checkpoint.tar"), weights_only=True)["step"] == 16

    _, ap, map_sum = train.main(["--log_dir", ssl, "--resume", "--eval", "--use_iou_for_nms",
                                 "--opt_step", "2", "--opt_rate", "0.01", "--batch_size", "1,2",
                                 "--dump_results"] + TINY + CPU)
    assert set(ap) == {0.25, 0.5} and map_sum == ap[0.25]["mAP"] + ap[0.5]["mAP"]
    names = os.listdir(os.path.join(ssl, "dump"))
    for suffix in ("pc", "seed_pc", "vgen_pc", "aggregated_vote_pc", "proposal_pc", "gt_bbox"):
        assert f"000000_{suffix}.ply" in names, suffix


def test_eval_use_ema_scores_the_saved_teacher(chain, monkeypatch):
    """An SSL checkpoint as --detector_checkpoint with --eval keeps its
    teacher: --eval_use_ema scores the saved EMA weights, not the student."""
    _, _, ssl = chain
    seen = []
    real = common.evaluate
    monkeypatch.setattr(common, "evaluate", lambda model, *a, **k: seen.append(model) or real(
        model, *a, **k))
    saved = torch.load(os.path.join(ssl, "checkpoint.tar"), weights_only=True)
    for flag in ([], ["--eval_use_ema"]):
        train.main(["--log_dir", ssl + "_ema", "--detector_checkpoint",
                    os.path.join(ssl, "checkpoint.tar"), "--eval", "--batch_size", "1,2"]
                   + flag + TINY + CPU)
    for model, key in zip(seen, ("model_state_dict", "ema_model_state_dict")):
        for k, v in model.state_dict().items():
            assert torch.equal(v, saved[key][k]), (key, k)
    assert not all(torch.equal(saved["model_state_dict"][k], saved["ema_model_state_dict"][k])
                   for k in saved["model_state_dict"])


def test_sunrgbd_pretrain_and_eval(tmp_path):
    log = str(tmp_path / "sun")
    pretrain.main(["--dataset", "sunrgbd", "--log_dir", log, "--batch_size", "2",
                   "--max_epoch", "1", "--eval_interval", "1", "--print_interval", "2"]
                  + TINY + CPU)
    _, ap, _ = pretrain.main(["--dataset", "sunrgbd", "--log_dir", log, "--resume", "--eval",
                              "--batch_size", "2", "--dump_results",
                              "--dump_dir", str(tmp_path / "dump")] + TINY + CPU)
    assert set(ap) == {0.25, 0.5} and 0 <= ap[0.25]["AR"] <= 1
    assert {"000000_pc.ply", "000000_proposal_pc.ply", "000000_gt_bbox.ply"} <= set(
        os.listdir(tmp_path / "dump"))
    assert os.path.exists(os.path.join(log, "best.txt"))


def test_non_finite_loss_saves_and_raises(tmp_path, monkeypatch):
    real = common.fetch_metrics
    monkeypatch.setattr(common, "fetch_metrics", lambda m: {**real(m), "loss": float("nan")})
    log = str(tmp_path / "nan")
    with pytest.raises(FloatingPointError):
        pretrain.main(["--log_dir", log, "--batch_size", "2", "--max_epoch", "1"] + TINY + CPU)
    assert torch.load(os.path.join(log, "nan_checkpoint.tar"), weights_only=True)["step"] == 1
    assert "FATAL: non-finite loss nan at epoch 0 batch 0" in open(
        os.path.join(log, "log_train.txt")).read()


def test_overwrite_prompt(tmp_path, monkeypatch):
    log = tmp_path / "log"
    log.mkdir()
    (log / "keep.txt").write_text("x")
    monkeypatch.setattr("builtins.input", lambda: "n")
    assert pretrain.main(["--log_dir", str(log), "--overwrite"] + TINY + CPU) is None
    assert (log / "keep.txt").exists() and not (log / "log_train.txt").exists()
    monkeypatch.setattr("builtins.input", lambda: "y")
    pretrain.main(["--log_dir", str(log), "--overwrite", "--eval", "--batch_size", "2"]
                  + TINY + CPU)
    assert not (log / "keep.txt").exists() and (log / "log_train.txt").exists()


def test_pretrain_eval_matches_jax(tmp_path, monkeypatch):
    """A port-written checkpoint of a tiny model (untrained: with 64
    proposals on the 8 eval scenes of 32 synthetic ones, its boxes meet GT
    boxes, so AP and AR are not 0, which a 2-epoch model's often are).

    The JAX model's SA layers take the approximate ball query
    (``exact_ball_query=False``, ``lax.approx_min_k``, recall < 1), which
    its drivers cannot switch off; on these dense scenes it picks other
    neighbours than the reference's exact query, which the port runs. The
    JAX run here takes its exact query (``ball_query(exact=True)``, the
    setting its docstring keeps for parity tests); with the approximate one
    mAP@0.25 read 0.000449 against the port's 0.001008 (ROADMAP Queue 3)."""
    import iou3dmatch_tpu.cli.common as jax_common
    import iou3dmatch_tpu.models.pointnet2 as jax_pointnet2

    from iou3dmatch_tpu_torch.models.factory import build_votenet
    from iou3dmatch_tpu_torch.train import checkpoint
    from iou3dmatch_tpu_torch.train.state import create_train_state

    model, _ = build_votenet("scannet", tiny=True, device="cpu",
                             generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, create_train_state(model), epoch=0)
    flags = ["--eval", "--checkpoint_path", path, "--batch_size", "4", "--use_iou_for_nms",
             "--synthetic", "--synthetic_scenes", "32", "--tiny", "--num_point", "512",
             "--num_target", "64", "--num_workers", "2"]
    got = pretrain.main(["--log_dir", str(tmp_path / "port")] + flags + CPU)
    exact = jax_pointnet2.ball_query
    monkeypatch.setattr(jax_pointnet2, "ball_query",
                        lambda *a, exact_query=exact, **k: exact_query(*a, **{**k, "exact": True}))
    want = []
    real = jax_common.evaluate
    monkeypatch.setattr(jax_common, "evaluate",
                        lambda *a, **k: want.append(real(*a, **k)) or want[-1])
    jax_pretrain.main(["--log_dir", str(tmp_path / "jax")] + flags)
    (want_means, want_ap, want_sum), = want
    assert got[1][0.25]["mAP"] > 0 and got[1][0.25]["AR"] > 0
    for t in (0.25, 0.5):
        for key in ("mAP", "AR"):
            assert got[1][t][key] == want_ap[t][key], (t, key)
    assert got[2] == want_sum
    # the eval-loss means, within the rtol of tests/test_torch_eval.py
    assert set(got[0]) == set(want_means) | {"loss"}
    for k, v in want_means.items():
        assert got[0][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def _jax_exact_ball_query(monkeypatch):
    """JAX's SA layers on the exact ball query the port runs (see
    ``test_pretrain_eval_matches_jax``)."""
    import iou3dmatch_tpu.models.pointnet2 as jax_pointnet2

    exact = jax_pointnet2.ball_query
    monkeypatch.setattr(jax_pointnet2, "ball_query",
                        lambda *a, exact_query=exact, **k: exact_query(*a, **{**k, "exact": True}))


@pytest.mark.parametrize("iou_nms", [False, True])
@pytest.mark.parametrize("num_target", [1025, 2048])
def test_num_target_past_the_cluster_path(tmp_path, monkeypatch, num_target, iou_nms):
    """More proposals a scene than NMS's cluster path takes on the card
    (MAX_BOXES, 1,024), which the drivers refused at startup until the NMS
    kernel grew a global-matrix path: ``driver_device`` accepts the flag on a
    mocked card for both drivers, and the pretrain driver's ``--eval`` at
    ``--cluster_sampling vote_fps --vote_factor 2`` (the tiny model's 64
    seeds give 128 votes, from which FPS draws every proposal) gives the
    JAX driver's mAP and AR on the same checkpoint and scenes."""
    import iou3dmatch_tpu.cli.common as jax_common

    from iou3dmatch_tpu_torch.models.factory import build_votenet
    from iou3dmatch_tpu_torch.ops.nms import MAX_BOXES
    from iou3dmatch_tpu_torch.train import checkpoint
    from iou3dmatch_tpu_torch.train.state import create_train_state

    knobs = ["--cluster_sampling", "vote_fps", "--vote_factor", "2", "--num_target",
             str(num_target)]
    assert num_target > MAX_BOXES
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        for driver in (pretrain, train):
            assert common.driver_device(driver.parse_args(knobs)) == torch.device("cuda", 0)

    model, _ = build_votenet("scannet", tiny=True, device="cpu", sampling="vote_fps",
                             vote_factor=2, num_proposal=num_target,
                             generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, create_train_state(model), epoch=0)
    flags = ["--eval", "--checkpoint_path", path, "--batch_size", "4", "--synthetic",
             "--synthetic_scenes", "16", "--tiny", "--num_point", "512", "--num_workers", "2"] \
        + knobs + (["--use_iou_for_nms"] if iou_nms else [])
    got = pretrain.main(["--log_dir", str(tmp_path / "port")] + flags + CPU)
    _jax_exact_ball_query(monkeypatch)
    want = []
    real = jax_common.evaluate
    monkeypatch.setattr(jax_common, "evaluate",
                        lambda *a, **k: want.append(real(*a, **k)) or want[-1])
    jax_pretrain.main(["--log_dir", str(tmp_path / "jax")] + flags)
    (_, want_ap, want_sum), = want
    for t in (0.25, 0.5):
        for key in ("mAP", "AR"):
            assert got[1][t][key] == want_ap[t][key], (t, key)
    assert got[2] == want_sum
