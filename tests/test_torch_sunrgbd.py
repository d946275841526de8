"""SUN RGB-D through the port against the JAX package, on the CPU.

- The SSL step, ``reference_exact`` with view-stats, on tiny SUN RGB-D
  models (10 classes, 12 heading bins, rotated GT; the student's view
  flipped in x only and turned by up to 30 degrees, so ``trans_angle``
  re-bins the pseudo labels' headings): the inputs of
  tests/torch_ssl_cases.py::make_setup("sunrgbd") and the bounds of
  tests/test_torch_ssl_step.py (``check_one_step``).
- chip_smoke.py phase 10's synthetic frames (``write_sunrgbd_trainval``,
  the ``sunrgbd_trainval`` layout) through the port's and JAX's
  ``prep_sunrgbd`` and ``gen_split``: the same dumps bit for bit and the
  same split bytes, and the split covers the 10 classes.
- ``evaluate`` over the port's SUN RGB-D loader on dumps the port's prep
  wrote, with the GT boxes on the model's own proposals (written back as
  label lines and prepped again), against JAX's ``evaluate`` over JAX's
  loader with the same weights: mAP and AR at 0.25 and 0.5 equal, and
  mAP@0.25 above 0. The JAX model runs its exact ball query, as
  tests/test_torch_cli.py::test_pretrain_eval_matches_jax explains.
"""
import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tests import torch_ssl_cases as C  # noqa: E402
from tests.test_torch_prep import same_trees  # noqa: E402
from iou3dmatch_tpu_torch.data import gen_split as pgen  # noqa: E402
from iou3dmatch_tpu_torch.data import loader as port_loader  # noqa: E402
from iou3dmatch_tpu_torch.data import prep_sunrgbd as psun  # noqa: E402
from iou3dmatch_tpu_torch.data import sunrgbd as port_sunrgbd  # noqa: E402
from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402

torch.set_num_threads(1)


def test_ssl_step_matches_jax_on_sunrgbd():
    """reference_exact with view-stats on SUN RGB-D: tolerances of
    tests/test_torch_ssl_step.py's module docstring."""
    setup = C.make_setup("sunrgbd")
    assert not setup.batch["flip_y_axis"].any() and setup.cfg.num_heading_bin == 12
    assert np.abs(setup.batch["rot_angle"]).max() > np.pi / 12  # past half a heading bin
    C.check_one_step(setup, "reference_exact")


def prep(module, trainval, split, out, *flags):
    module.main(["--root", str(trainval), "--idx_file", str(trainval / f"{split}_data_idx.txt"),
                 "--output_dir", str(out), "--use_v1", *flags])


def test_phase10_frames_prep_and_split_as_jax_does(tmp_path, capsys):
    from iou3dmatch_tpu.data import gen_split as jgen
    from iou3dmatch_tpu.data import prep_sunrgbd as jsun

    cfg = get_config("sunrgbd")
    trainval = tmp_path / "sunrgbd_trainval"
    written = chip_smoke.write_sunrgbd_trainval(trainval, cfg, 1, 20, 2, 4000)
    assert written["frames"] == 22 and 3 * 22 <= written["boxes"] <= 8 * 22
    for mod in (psun, jsun):
        for split in ("train", "val"):
            prep(mod, trainval, split, tmp_path / mod.__name__ / split, "--num_point", "3000")
    for gen in (pgen, jgen):
        (tmp_path / f"{gen.__name__}_split").mkdir()
        gen.main(["sunrgbd", "0.5", "0", "--data_path", str(tmp_path / psun.__name__ / "train"),
                  "--out_dir", str(tmp_path / f"{gen.__name__}_split"), "--seed", "0"])
    capsys.readouterr()
    same_trees(str(tmp_path / psun.__name__), str(tmp_path / jsun.__name__))
    same_trees(str(tmp_path / f"{pgen.__name__}_split"), str(tmp_path / f"{jgen.__name__}_split"))
    labeled = (tmp_path / f"{pgen.__name__}_split" / "sunrgbd_v1_train_0.5_0.txt").read_text().split()
    assert len(labeled) == 10
    classes = {int(c) for name in labeled for c in
               np.load(tmp_path / psun.__name__ / "train" / f"{name}_bbox.npy")[:, 7]}
    assert classes == set(range(10))
    # the label files' half extents: points of a box lie inside it and vote for its centre
    votes = np.load(tmp_path / psun.__name__ / "train" / "000001_votes.npz")["point_votes"]
    assert 0.3 < votes[:, 0].mean() < 0.5  # 40 % of the points are on boxes


def test_evaluate_on_port_prepared_dumps_matches_jax(tmp_path, monkeypatch):
    import iou3dmatch_tpu.models.pointnet2 as jax_pointnet2
    from iou3dmatch_tpu.cli import common as jax_common
    from iou3dmatch_tpu.data import get_config as jax_get_config
    from iou3dmatch_tpu.data import loader as jax_loader
    from iou3dmatch_tpu.data import sunrgbd as jax_sunrgbd
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.steps import make_eval_forward as jax_eval_forward

    from iou3dmatch_tpu_torch.cli import common as port_common
    from iou3dmatch_tpu_torch.data.staging import stage_batch
    from iou3dmatch_tpu_torch.models.factory import build_votenet
    from iou3dmatch_tpu_torch.train.steps import make_eval_loss
    from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax

    cfg = get_config("sunrgbd")
    trainval, val = tmp_path / "sunrgbd_trainval", tmp_path / "sunrgbd_pc_bbox_votes_50k_v1_val"
    chip_smoke.write_sunrgbd_trainval(trainval, cfg, 3, 0, 4, 3000)
    prep(psun, trainval, "val", val, "--num_point", "2500")

    jm, _ = build_jax("sunrgbd", tiny=True)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(7)}, x, train=False))(
        jnp.zeros((2, 2048, 4), jnp.float32))
    variables = jax.tree.map(np.asarray, variables)
    pm, _ = build_votenet("sunrgbd", tiny=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)

    def dataset(module):
        return module.SunrgbdDetectionVotesDataset(str(val), num_points=2048, use_height=True,
                                                   augment=False)

    # GT on the model's own proposals: each val frame as the process loader
    # will draw it, the port's forward, and six of its boxes written back as
    # the frame's label lines (half extents, the heading as its orientation)
    ds = dataset(port_sunrgbd)
    for i, name in enumerate(ds.scan_names):
        np.random.seed(port_loader.sample_seed(0, 0, i))
        with torch.no_grad():
            ep = {k: v[0].numpy() for k, v in pm(torch.from_numpy(ds[i]["point_clouds"][None])).items()}
        rows = np.arange(6)
        size_cls = ep["size_scores"][:6].argmax(-1)
        size = cfg.mean_size_arr[size_cls] + ep["size_residuals"][rows, size_cls]
        head_cls = ep["heading_scores"][:6].argmax(-1)
        angle = cfg.class2angle(head_cls, ep["heading_residuals"][rows, head_cls])
        lines = [f"{cfg.class2type[int(c)]} 0 0 1 1 {x!r} {y!r} {z!r} {l / 2!r} {w / 2!r} "
                 f"{h / 2!r} {np.cos(a)!r} {-np.sin(a)!r}"
                 for c, (x, y, z), (l, w, h), a in zip(ep["sem_cls_scores"][:6].argmax(-1),
                                                       ep["center"][:6].astype(float), size, angle)]
        (trainval / "label_v1" / f"{name}.txt").write_text("\n".join(lines) + "\n")
    before = {f: np.load(val / f)["pc"] for f in os.listdir(val) if f.endswith("_pc.npz")}
    prep(psun, trainval, "val", val, "--num_point", "2500")
    for f, pc in before.items():  # the same draws: the clouds the forward saw
        assert np.load(val / f)["pc"].tobytes() == pc.tobytes()

    exact = jax_pointnet2.ball_query
    monkeypatch.setattr(jax_pointnet2, "ball_query",
                        lambda *a, exact_query=exact, **k: exact_query(*a, **{**k, "exact": True}))
    args = types.SimpleNamespace(use_iou_for_nms=True, conf_thresh=0.05)
    kw = dict(batch_size=2, shuffle=False, drop_last=False, num_workers=2, seed=0,
              worker_type="process")
    ours = port_loader.DataLoader(dataset(port_sunrgbd), **kw)
    theirs = jax_loader.DataLoader(dataset(jax_sunrgbd), **kw)
    try:
        jcfg = jax_get_config("sunrgbd")
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.asarray(0))
        want = jax_common.evaluate(jm, jcfg, state, theirs, jax_common.make_config_dict(jcfg, args),
                                   lambda _: None, jax_eval_forward(jm, jcfg))
        got = port_common.evaluate(pm, cfg, (stage_batch(b, device="cpu") for b in ours),
                                   port_common.make_config_dict(cfg, args), lambda _: None,
                                   make_eval_loss(pm, cfg))
    finally:
        ours.close()
        theirs.close()
    for t in (0.25, 0.5):
        for key in ("mAP", "AR"):
            assert got[1][t][key] == want[1][t][key], (t, key, got[1][t][key], want[1][t][key])
    assert got[1][0.25]["mAP"] > 0
