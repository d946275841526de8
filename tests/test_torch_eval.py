"""The port's eval path against the JAX package's, on the CPU.

- ``parse_predictions`` on CPU tensors, every NMS branch with
  ``remove_empty_box`` (scene clouds with points inside some boxes and
  fewer than 5 inside others), equal to the JAX parse: the same proposals
  in the same order, corners and scores bit for bit (the CPU path computes
  its scores with NumPy, as the JAX parse does). Its ``KeyError`` without
  clouds and ``AssertionError`` for a scene with no box left. The NMS's
  scores are torch's (``nms_scores``), whose ``exp`` may round otherwise
  than NumPy's: ``test_nms_scores_within_ulps_of_numpy`` bounds the gap
  (4 ulps for the objectness probability, 8 for the IoU-gated score), and
  picks are compared exactly, so a seeded case whose picks differed for
  two overlapping boxes scored within that gap would fail here, not pass.
- ``parse_groundtruths``, ``align_predictions_groundtruths``,
  ``get_roi_ptcloud`` (the same ``rng`` seed) and ``box3d_iou``: equal.
- The port's C++ host IoU against the JAX package's and against the NumPy
  ``box3d_iou``: equal to the JAX native bit for bit, within 1e-6 of NumPy
  (the native IoU rounds its float64 result to float32).
- ``eval_det`` and ``APCalculator`` on the same proposal and GT lists:
  recall, precision, AP, mAP and AR equal.
- ``evaluate`` over 2 batches of 2 scenes of a tiny ScanNet model, with and
  without test-time IoU optimisation, against the JAX ``evaluate`` with the
  same weights: loss metrics within rtol 1e-4 (the port's also hold the
  total ``loss``), mAP and AR at 0.25 and 0.5 within 1e-6 (GT boxes near
  the model's own proposals, so AP is not 0).
- ``evaluate(dump_dir=...)``: the first batch's PLYs, byte for byte the JAX
  ``evaluate``'s.
"""
import importlib
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402
from iou3dmatch_tpu_torch.eval import ap_helper as pap  # noqa: E402
from iou3dmatch_tpu_torch.eval import eval_det as ped  # noqa: E402

torch.set_num_threads(1)


def _random_ep(rng, b=3, k=40, nc=18, nh=1, ns=18):
    center = rng.uniform(-2, 2, (b, k, 3))
    center[:, k // 2:] = center[:, :k // 2] + rng.normal(0, 0.05, (b, k - k // 2, 3))
    return {
        "center": center.astype(np.float32),
        "heading_scores": rng.randn(b, k, nh).astype(np.float32),
        "heading_residuals": (rng.randn(b, k, nh) * 0.1).astype(np.float32),
        "size_scores": rng.randn(b, k, ns).astype(np.float32),
        "size_residuals": (rng.randn(b, k, ns, 3) * 0.1).astype(np.float32),
        "sem_cls_scores": rng.randn(b, k, nc).astype(np.float32),
        "objectness_scores": rng.randn(b, k, 2).astype(np.float32),
        "iou_scores": rng.randn(b, k, nc).astype(np.float32),
    }


def _clouds(ep, rng):
    """Scene clouds (B, N, 4): 8 points at each of the first 8 boxes'
    centers (within 1 cm), 3 at each of the next 8 (where there are), and
    200 far away; the other boxes hold none but those their neighbours'
    points fall in."""
    b = ep["center"].shape[0]
    pts = []
    for i in range(b):
        c = ep["center"][i]
        near = [c[j] + rng.uniform(-0.01, 0.01, (8 if j < 8 else 3, 3))
                for j in range(min(16, len(c)))]
        far = rng.uniform(20, 30, (200, 3))
        xyz = np.concatenate(near + [far]).astype(np.float32)
        pts.append(np.concatenate([xyz, xyz[:, 2:3]], 1))
    n = min(len(p) for p in pts)
    return np.stack([p[:n] for p in pts])


def _config(dataset, mode):
    config = pap.eval_config_dict(get_config(dataset), use_iou_for_nms=mode == "3d_cls_iou")
    config["use_3d_nms"] = mode != "2d"
    config["cls_nms"] = mode.startswith("3d_cls") or mode == "no_per_class"
    config["per_class_proposal"] = mode != "no_per_class"
    return config


def _same_lists(got, want):
    assert [len(g) for g in got] == [len(w) for w in want]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g[0] == w[0] and type(g[0]) is type(w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2] == w[2]


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
@pytest.mark.parametrize("mode", ["2d", "3d", "3d_cls", "3d_cls_iou", "no_per_class"])
def test_parse_predictions_remove_empty_box_matches_jax(mode, dataset):
    from iou3dmatch_tpu.eval.ap_helper import parse_predictions as jax_parse

    config = dict(_config(dataset, mode), remove_empty_box=True)
    cfg = config["dataset_config"]
    rng = np.random.RandomState(len(mode) + len(dataset))
    ep = _random_ep(rng, nc=cfg.num_class, nh=cfg.num_heading_bin, ns=cfg.num_size_cluster)
    ep["point_clouds"] = _clouds(ep, rng)
    got = pap.parse_predictions({k: torch.from_numpy(v) for k, v in ep.items()}, config)
    want = jax_parse(ep, config)
    _same_lists(got, want)
    _same_lists(pap.parse_predictions_np(ep, config), want)
    # boxes were removed: fewer proposals than without the test
    plain = jax_parse(ep, dict(config, remove_empty_box=False))
    assert sum(map(len, want)) < sum(map(len, plain))


@pytest.mark.parametrize("mode", ["2d", "3d", "3d_cls", "3d_cls_iou"])
def test_parse_predictions_k300_matches_jax(mode):
    """A model built with --num_target 300 (past the card NMS's old 256):
    parse_predictions on CPU tensors picks what the JAX parse picks."""
    from iou3dmatch_tpu.eval.ap_helper import parse_predictions as jax_parse

    config = _config("scannet", mode)
    ep = _random_ep(np.random.RandomState(300 + len(mode)), k=300)
    got = pap.parse_predictions({k: torch.from_numpy(v) for k, v in ep.items()}, config)
    want = jax_parse(ep, config)
    assert sum(map(len, want)) > 0
    _same_lists(got, want)


@pytest.mark.parametrize("use_iou_for_nms", [False, True])
def test_nms_scores_within_ulps_of_numpy(use_iou_for_nms):
    """``nms_scores`` (torch) against the JAX parse's NumPy scores on 32,768
    boxes of wide logits: the class equal, the objectness probability
    within 4 ulps (each of its two ``exp`` within an ulp of NumPy's, then a
    sum and a quotient) and the IoU-gated score within 8 (the gate's own
    ``exp``, sum and quotient, then a product)."""
    config = _config("scannet", "3d_cls_iou" if use_iou_for_nms else "3d_cls")
    rng = np.random.RandomState(5)
    ep = {k: (rng.randn(64, 512, n) * 3).astype(np.float32)
          for k, n in (("sem_cls_scores", 18), ("objectness_scores", 2), ("iou_scores", 18))}
    scores, sem = pap.nms_scores({k: torch.from_numpy(v) for k, v in ep.items()}, config)
    want_sem = pap.softmax_np(ep["sem_cls_scores"]).argmax(-1)
    want = pap.softmax_np(ep["objectness_scores"])[..., 1]
    if use_iou_for_nms:
        gate = 1.0 / (1.0 + np.exp(-ep["iou_scores"]))
        want = want * np.take_along_axis(gate, want_sem[..., None], 2)[..., 0]
    np.testing.assert_array_equal(sem.numpy(), want_sem)
    assert scores.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_max_ulp(scores.numpy(), want, maxulp=8 if use_iou_for_nms else 4)


def test_parse_predictions_needs_clouds_and_a_box_a_scene():
    config = dict(_config("scannet", "3d_cls"), remove_empty_box=True)
    ep = {k: torch.from_numpy(v) for k, v in _random_ep(np.random.RandomState(1)).items()}
    with pytest.raises(KeyError, match="point_clouds"):
        pap.parse_predictions(ep, config)
    ep["point_clouds"] = torch.full((3, 50, 4), 100.0)  # no box holds a point
    with pytest.raises(AssertionError):
        pap.parse_predictions(ep, config)


def _gt_batch(rng, b=3, g=8, dataset="sunrgbd"):
    cfg = get_config(dataset)
    mask = (rng.rand(b, g) < 0.75).astype(np.float32)
    mask[:, 0] = 1
    return {
        "center_label": rng.uniform(-2, 2, (b, g, 3)).astype(np.float32),
        "heading_class_label": rng.randint(0, cfg.num_heading_bin, (b, g)).astype(np.int64),
        "heading_residual_label": (rng.randn(b, g) * 0.1).astype(np.float32),
        "size_class_label": rng.randint(0, cfg.num_size_cluster, (b, g)).astype(np.int64),
        "size_residual_label": (rng.randn(b, g, 3) * 0.1).astype(np.float32),
        "sem_cls_label": rng.randint(0, cfg.num_class, (b, g)).astype(np.int64),
        "box_label_mask": mask,
    }


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
def test_groundtruths_alignment_and_roi_clouds_match_jax(dataset):
    from iou3dmatch_tpu.eval import ap_helper as jap

    cfg = get_config(dataset)
    config = pap.eval_config_dict(cfg)
    rng = np.random.RandomState(3)
    batch = _gt_batch(rng, dataset=dataset)
    got = pap.parse_groundtruths({k: torch.from_numpy(v) for k, v in batch.items()}, config)
    want = jap.parse_groundtruths(batch, config)
    assert [[c for c, _ in s] for s in got] == [[c for c, _ in s] for s in want]
    for gs, ws in zip(got, want):
        for (_, g), (_, w) in zip(gs, ws):
            np.testing.assert_array_equal(g, w)
    gt_corners, gt_params = pap.groundtruths2corners3d(batch, config)
    for a, b in zip((gt_corners, gt_params), jap.groundtruths2corners3d(batch, config)):
        np.testing.assert_array_equal(a, b)

    ep = _random_ep(rng, b=3, k=12, nc=cfg.num_class, nh=cfg.num_heading_bin,
                    ns=cfg.num_size_cluster)
    ep["center"][:, :6] = batch["center_label"][:, :6]  # some proposals on GT boxes
    pred_corners, pred_params = pap.predictions2corners3d(ep, config)
    jc, jp = jap.predictions2corners3d(ep, config)
    np.testing.assert_array_equal(pred_corners, jc)
    np.testing.assert_array_equal(pred_params, jp)
    for a, b in zip(pap.align_predictions_groundtruths(pred_corners, gt_corners, batch, 0.25),
                    jap.align_predictions_groundtruths(pred_corners, gt_corners, batch, 0.25)):
        np.testing.assert_array_equal(a, b)

    inputs = {"point_clouds": _clouds(ep, rng)}
    got = pap.get_roi_ptcloud(inputs, pred_params, num_point_roi=16, min_num_point=4,
                              rng=np.random.RandomState(9))
    want = jap.get_roi_ptcloud(inputs, pred_params, num_point_roi=16, min_num_point=4,
                               rng=np.random.RandomState(9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < got[1].sum() < got[1].size  # some boxes hold enough points, some not


def _box_pairs(rng, n=60):
    from iou3dmatch_tpu_torch.geometry.boxes import get_3d_box_np

    pairs = []
    for i in range(n):
        size = rng.uniform(0.2, 2.0, 3)
        a = get_3d_box_np(size, rng.uniform(-np.pi, np.pi), rng.uniform(-1, 1, 3))
        if i % 3 == 0:  # the same box, turned or moved a little
            b = get_3d_box_np(size * rng.uniform(0.9, 1.1, 3), rng.uniform(-0.2, 0.2),
                              rng.uniform(-0.1, 0.1, 3))
        else:
            b = get_3d_box_np(rng.uniform(0.2, 2.0, 3), rng.uniform(-np.pi, np.pi),
                              rng.uniform(-1, 1, 3))
        pairs.append((a.astype(np.float32), b.astype(np.float32)))
    return pairs


def test_box3d_iou_and_native_iou_match_jax():
    from iou3dmatch_tpu import native as jnative
    from iou3dmatch_tpu.eval import box3d_iou_np as jiou

    from iou3dmatch_tpu_torch import native as pnative
    from iou3dmatch_tpu_torch.eval import box3d_iou_np as piou

    pairs = _box_pairs(np.random.RandomState(4))
    hits = 0
    for a, b in pairs:
        want = jiou.box3d_iou(a, b)
        assert piou.box3d_iou(a, b) == want
        got = pnative.box3d_iou_native(a, b)
        ref = jnative.box3d_iou_native(a, b)
        if ref is not None:
            assert got == ref
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert ped.get_iou_obb(a, b) == got[0]
        hits += got[0] > 0
    assert hits > 10
    a = np.stack([p[0] for p in pairs[:7]])
    b = np.stack([p[1] for p in pairs[:5]])
    mat = pnative.box3d_iou_matrix_native(a, b)
    assert mat.shape == (7, 5)
    np.testing.assert_array_equal(mat, [[pnative.box3d_iou_native(x, y)[0] for y in b] for x in a])
    np.testing.assert_array_equal(piou.boxes3d_iou_batch(a, b), jiou.boxes3d_iou_batch(a, b))


def _pred_gt_lists(rng, scenes=6, nc=4):
    """Proposal and GT lists of ``scenes`` scenes: GT boxes of ``nc``
    classes, proposals near some of them (so some match at 0.25 and 0.5),
    others anywhere, one class without proposals and one without GT."""
    from iou3dmatch_tpu_torch.geometry.boxes import get_3d_box_np

    preds, gts = {}, {}
    for s in range(scenes):
        gt, pred = [], []
        for _ in range(rng.randint(2, 6)):
            c = int(rng.randint(0, nc - 1))  # class nc - 1 has no GT
            size, ctr = rng.uniform(0.3, 2.0, 3), rng.uniform(-3, 3, 3)
            box = get_3d_box_np(size, 0.0, ctr).astype(np.float32)
            gt.append((c, box))
            for _ in range(rng.randint(0, 3)):
                near = get_3d_box_np(size * rng.uniform(0.7, 1.3, 3), 0.0,
                                     ctr + rng.normal(0, 0.15, 3)).astype(np.float32)
                pred.append((c, near, float(rng.rand())))
        for _ in range(rng.randint(0, 4)):
            c = int(rng.choice([0, 1, nc - 1]))
            pred.append((c, get_3d_box_np(rng.uniform(0.3, 2.0, 3), 0.0,
                                          rng.uniform(-3, 3, 3)).astype(np.float32),
                         float(rng.rand())))
        preds[s], gts[s] = pred, gt
    return preds, gts


@pytest.mark.parametrize("thresh", [0.25, 0.5])
def test_eval_det_and_ap_calculator_match_jax(thresh):
    from iou3dmatch_tpu.eval import ap_helper as jap

    jed = importlib.import_module("iou3dmatch_tpu.eval.eval_det")  # the package exports a function of that name
    preds, gts = _pred_gt_lists(np.random.RandomState(5))
    got = ped.eval_det(preds, gts, ovthresh=thresh)
    want = jed.eval_det(preds, gts, ovthresh=thresh)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
    assert 0 < np.mean([v for v in got[2].values()]) < 1
    pcalc, jcalc = pap.APCalculator(thresh), jap.APCalculator(thresh)
    for s in range(0, 6, 3):
        batch_pred = [preds[i] for i in range(s, s + 3)]
        batch_gt = [gts[i] for i in range(s, s + 3)]
        pcalc.step(batch_pred, batch_gt)
        jcalc.step(batch_pred, batch_gt)
    assert pcalc.compute_metrics() == jcalc.compute_metrics()


# ------------------------------------------------------------------ evaluate

def _eval_batches(pm, cfg, rng):
    """2 batches of 2 scenes of 2,048 points; GT boxes near the model's
    own proposals (the port's forward, the same weights as JAX's), of their
    argmax class and size, with vote labels."""
    batches = []
    for _ in range(2):
        pc = np.zeros((2, 2048, 4), np.float32)
        pc[..., 0:3] = rng.uniform(-3.0, 3.0, (2, 2048, 3))
        pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
        with torch.no_grad():
            ep = {k: v.numpy() for k, v in pm(torch.from_numpy(pc)).items()}
        g = cfg.max_num_obj
        size_class = np.argmax(ep["size_scores"], -1)[:, :6]
        residual = np.take_along_axis(np.asarray(ep["size_residuals"])[:, :6],
                                      size_class[..., None, None], 2)[:, :, 0]
        batch = {
            "point_clouds": pc,
            "center_label": np.zeros((2, g, 3), np.float32),
            "box_label_mask": np.zeros((2, g), np.float32),
            "heading_class_label": np.zeros((2, g), np.int64),
            "heading_residual_label": np.zeros((2, g), np.float32),
            "size_class_label": np.zeros((2, g), np.int64),
            "size_residual_label": np.zeros((2, g, 3), np.float32),
            "sem_cls_label": np.zeros((2, g), np.int64),
            "vote_label": np.zeros((2, 2048, 9), np.float32),
            "vote_label_mask": np.zeros((2, 2048), np.int64),
        }
        batch["center_label"][:, :6] = np.asarray(ep["center"])[:, :6] + rng.normal(0, 0.05, (2, 6, 3))
        batch["box_label_mask"][:, :6] = 1
        batch["size_class_label"][:, :6] = size_class
        batch["size_residual_label"][:, :6] = residual
        batch["sem_cls_label"][:, :6] = np.argmax(ep["sem_cls_scores"], -1)[:, :6]
        near = np.linalg.norm(pc[:, :, None, :3] - batch["center_label"][:, None, :6], axis=-1)
        hit = near.min(-1) < 0.5
        vote = batch["center_label"][np.arange(2)[:, None], near.argmin(-1)] - pc[..., :3]
        batch["vote_label"] = np.where(hit[..., None], np.tile(vote, 3), 0).astype(np.float32)
        batch["vote_label_mask"] = hit.astype(np.int64)
        batches.append(batch)
    return batches


@pytest.fixture(scope="module")
def tiny_pair():
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    from iou3dmatch_tpu_torch.models.factory import build_votenet
    from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax

    jm, _ = build_jax("scannet", tiny=True)
    pc = np.zeros((2, 2048, 4), np.float32)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(7)}, x, train=False))(
        jnp.asarray(pc))
    variables = jax.tree.map(np.asarray, variables)
    pm, pcfg = build_votenet("scannet", tiny=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, pm, pcfg, _eval_batches(pm, pcfg, np.random.RandomState(6)), {}


@pytest.mark.parametrize("opt_step,opt_rate", [(0, 0.0), (2, 5e-2)])
def test_evaluate_matches_jax(tiny_pair, opt_step, opt_rate):
    from iou3dmatch_tpu.cli import common as jcommon
    from iou3dmatch_tpu.data import get_config as jax_get_config
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.steps import make_eval_forward as jax_eval_forward

    from iou3dmatch_tpu_torch.cli import common as pcommon
    from iou3dmatch_tpu_torch.train.steps import make_eval_loss

    jm, variables, pm, pcfg, batches, _ = tiny_pair
    args = types.SimpleNamespace(use_iou_for_nms=True, conf_thresh=0.05)
    jcfg = jax_get_config("scannet")
    jconfig = jcommon.make_config_dict(jcfg, args)
    pconfig = pcommon.make_config_dict(pcfg, args)
    assert {k: v for k, v in pconfig.items() if k != "dataset_config"} == \
        {k: v for k, v in jconfig.items() if k != "dataset_config"}
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=jnp.asarray(0))
    if "forward" not in tiny_pair[5]:  # one jitted forward for both runs
        tiny_pair[5]["forward"] = jax_eval_forward(jm, jcfg)
    want = jcommon.evaluate(jm, jcfg, state, batches, jconfig, lambda _: None,
                            tiny_pair[5]["forward"], opt_rate=opt_rate, opt_step=opt_step)
    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    lines = []
    got = pcommon.evaluate(pm, pcfg, tbatches, pconfig, lines.append,
                           make_eval_loss(pm, pcfg),
                           opt_rate=opt_rate, opt_step=opt_step)
    # the port's means also hold the total loss, which make_eval_loss adds
    assert set(got[0]) == set(want[0]) | {"loss"}
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4, atol=1e-6, err_msg=k)
    for t in (0.25, 0.5):
        assert got[1][t].keys() == want[1][t].keys()
        for key in ("mAP", "AR"):
            np.testing.assert_allclose(got[1][t][key], want[1][t][key], rtol=0, atol=1e-6)
    assert got[1][0.25]["mAP"] > 0
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=2e-6)
    assert any(line.startswith("eval mAP@0.25") for line in lines)


def test_evaluate_dump_dir_writes_the_jax_files(tiny_pair, tmp_path):
    """``evaluate(dump_dir=...)`` writes the first batch's PLYs: byte for
    byte those of JAX's ``dump_results`` on the port's outputs; the files of
    inputs and GT byte for byte the JAX ``evaluate``'s for the same weights
    and batches, and those of model outputs equal to them in every header
    line and within 1e-4 in every number (the forward's tolerance in
    ``tests/test_torch_models.py``: a value within an ulp of a rounding
    boundary prints differently at 6 decimals)."""
    import os

    from iou3dmatch_tpu.cli import common as jcommon
    from iou3dmatch_tpu.data import get_config as jax_get_config
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.steps import make_eval_forward as jax_eval_forward
    from iou3dmatch_tpu.utils import dump_helper as jdump

    from iou3dmatch_tpu_torch.cli import common as pcommon
    from iou3dmatch_tpu_torch.train.steps import make_eval_loss

    jm, variables, pm, pcfg, batches, cache = tiny_pair
    args = types.SimpleNamespace(use_iou_for_nms=True)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    outs = []
    eval_loss = make_eval_loss(pm, pcfg)
    pcommon.evaluate(pm, pcfg, tb, pcommon.make_config_dict(pcfg, args), lambda _: None,
                     lambda pc, labels: outs.append(eval_loss(pc, labels)) or outs[-1],
                     dump_dir=str(tmp_path / "port"))
    jcfg = jax_get_config("scannet")
    jdump.dump_results({k: v.numpy() for k, v in outs[0][0].items()}, batches[0],
                       str(tmp_path / "jax_writer"), jcfg)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=jnp.asarray(0))
    if "forward" not in cache:
        cache["forward"] = jax_eval_forward(jm, jcfg)
    jcommon.evaluate(jm, jcfg, state, batches, jcommon.make_config_dict(jcfg, args),
                     lambda _: None, cache["forward"], dump_dir=str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "jax_writer"))
    assert {"000000_pc.ply", "000001_gt_bbox.ply", "000001_proposal_pc.ply"} <= set(names)
    for n in names:
        got = (tmp_path / "port" / n).read_bytes()
        want = (tmp_path / "jax" / n).read_bytes()
        assert got == (tmp_path / "jax_writer" / n).read_bytes(), n
        if n.endswith(("_pc.ply", "_gt_bbox.ply")) and not n.endswith(
                ("seed_pc.ply", "vgen_pc.ply", "vote_pc.ply", "proposal_pc.ply")):
            assert got == want, n  # the batch's clouds and GT
            continue
        g_lines, w_lines = got.decode().splitlines(), want.decode().splitlines()
        end = g_lines.index("end_header") + 1
        assert g_lines[:end] == w_lines[:end] and len(g_lines) == len(w_lines), n
        assert [len(x.split()) for x in g_lines] == [len(x.split()) for x in w_lines], n
        np.testing.assert_allclose(
            np.array([float(v) for line in g_lines[end:] for v in line.split()]),
            np.array([float(v) for line in w_lines[end:] for v in line.split()]),
            rtol=0, atol=1e-4, err_msg=n)
