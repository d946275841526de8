"""Group-Free-3D with the IoU branch (``models/groupfree.py``,
``losses/groupfree.py``) against the plain reference
``reference/groupfree.py``, on the CPU at a small size: the tiny SA
geometry (128 / 64 / 32 / 16 centers over 2,048 points), 16 queries, 2
decoder layers at the published widths (d 288, 8 heads, FFN 2,048, the 2x
backbone), random weights from a seed copied into the reference by name.

- The forward in train mode with dropout on (the same masks, drawn from
  one seed): the KPS indices exactly, every stage's heads and the IoU
  logits within ``HEADS_RTOL``.
- The loss and every parameter's gradient in float64 on both sides, and
  one ``make_pretrain_step`` against the reference's step (AdamW, the
  decoder's group at a tenth of the lr).
- ``evaluate`` with IoU-guided NMS, and ``iou_optimize`` against the
  reference's ascent.
- VoteNet's ``make_pretrain_step`` unchanged: bit for bit the step as it
  was before it took a model's loss.
- The driver's flags, the spans and counters, the optimizer's groups.

Tolerances, each from the arithmetic it covers: in float32 the two sides
sum the same products in other orders (the port's three_nn distances,
its split GEMMs), which the BatchNorms of the tiny batch amplify, measured
up to 2e-5 of a head's largest magnitude; ``HEADS_RTOL`` is 1e-4, the
bound ``tests/test_torch_models.py`` holds VoteNet's heads to. In float64
the port's three_nn still measures its distances in float32
(``ops/interpolate.py``), so the FP and GridConv weights carry float32
round-off, about 1e-7 relative, which reaches the loss at 2e-9 and the
gradients at 7e-7 of a leaf's norm (or of the median leaf's, for a leaf
BatchNorm leaves at round-off): ``LOSS_RTOL`` 1e-7 and ``GRAD_GAP`` 1e-5.
"""
import copy

import numpy as np
import pytest
import torch

from iou3dmatch_tpu_torch.cli import pretrain, train
from iou3dmatch_tpu_torch.cli.common import evaluate, fetch_metrics
from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.data.synthetic import synthetic_scene
from iou3dmatch_tpu_torch.eval import ap_helper
from iou3dmatch_tpu_torch.eval.iou_opt import iou_optimize
from iou3dmatch_tpu_torch.losses import (get_groupfree_eval_loss, get_groupfree_loss,
                                         get_labeled_loss)
from iou3dmatch_tpu_torch.models.factory import build_groupfree, build_votenet
from iou3dmatch_tpu_torch.models.groupfree import GroupFreeDetector, stage_prefixes
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum
from iou3dmatch_tpu_torch.train.state import create_train_state
from iou3dmatch_tpu_torch.train.steps import make_eval_loss, make_pretrain_step
from iou3dmatch_tpu_torch.utils import trace
from reference import groupfree as ref

torch.set_num_threads(1)
HEADS_RTOL = 1e-4
LOSS_RTOL = 1e-7
GRAD_GAP = 1e-5
LAYERS, K = 2, 16


def scenes(seed: int = 0, b: int = 2, n: int = 2048) -> dict:
    cfg = get_config("scannet")
    rng = np.random.RandomState(seed)
    s = [synthetic_scene(rng, cfg, n, num_boxes=8) for _ in range(b)]
    return {k: torch.from_numpy(np.stack([x[k] for x in s])) for k in s[0]}


def pair(dtype=torch.float32):
    """(port model, reference model, cfg) with the port's weights in both."""
    model, cfg = build_groupfree(tiny=True, num_decoder_layers=LAYERS, width=2, device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    r = ref.GroupFree(cfg.mean_size_arr, num_proposal=K, num_decoder_layers=LAYERS, width=2,
                      sa_npoints=(128, 64, 32, 16))
    r.load_state_dict(model.state_dict())
    return model.to(dtype), r.to(dtype), cfg


def as_dtype(batch: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def train_mode(model, r):
    model.train()
    set_bn_momentum(model, 0.1)
    r.train()


def rel_gap(a, b) -> float:
    return float((a.detach() - b.detach()).abs().max() / b.detach().abs().max().clamp(min=1e-30))


def worst_leaf(got: dict, want: dict) -> float:
    """The harness's measure (``portbench/harness/compare.py``): |a - b|
    over the reference leaf's norm or the median leaf's, the largest."""
    med = np.median([w.norm().item() for w in want.values()])
    return max((got[n] - w).norm().item() / max(w.norm().item(), med) for n, w in want.items())


def test_forward_heads_and_kps_match_the_reference():
    model, r, _ = pair()
    batch = scenes()
    train_mode(model, r)
    ep = model.forward_with_pred_jitter(batch["point_clouds"],
                                        generator=torch.Generator().manual_seed(3))
    out = r(batch["point_clouds"], torch.Generator().manual_seed(3), jitter=True)
    assert torch.equal(ep["seed_inds"].long(), out["seed_inds"])
    assert torch.equal(ep["query_points_sample_inds"].long(), out["query_inds"])
    assert rel_gap(ep["seeds_obj_cls_logits"], out["kps_logits"]) < HEADS_RTOL
    assert stage_prefixes(LAYERS) == r.prefixes() == ["proposal_", "last_", "0head_"]
    for prefix in r.prefixes():
        for head in GroupFreeDetector.HEADS:
            assert rel_gap(ep[prefix + head], out[prefix + head]) < HEADS_RTOL, prefix + head
    for key in ("iou_scores", "iou_scores_jitter", "jitter_center", "jitter_size"):
        assert rel_gap(ep[key], out[key]) < HEADS_RTOL, key
    # the plain keys are the last stage's; objectness as the logits [0, x]
    assert torch.equal(ep["center"], ep["last_center"])
    assert torch.equal(ep["objectness_scores"][..., 1:], ep["last_objectness_scores"])
    assert not ep["objectness_scores"][..., 0].any()


def test_dropout_masks_come_from_the_generator_in_train_mode_only():
    model, _, _ = pair()
    pc = scenes()["point_clouds"]
    model.train()
    set_bn_momentum(model, 0.1)
    a = model.forward_backbone(pc, generator=torch.Generator().manual_seed(1))["last_center"]
    b = model.forward_backbone(pc, generator=torch.Generator().manual_seed(1))["last_center"]
    c = model.forward_backbone(pc, generator=torch.Generator().manual_seed(2))["last_center"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    a = model.forward_backbone(pc, generator=torch.Generator().manual_seed(1))["last_center"]
    assert torch.equal(a, model.forward_backbone(pc)["last_center"])


def test_loss_and_every_gradient_match_the_reference():
    model, r, cfg = pair(torch.float64)
    batch = as_dtype(scenes(1), torch.float64)
    train_mode(model, r)
    ep = model.forward_with_pred_jitter(batch["point_clouds"],
                                        generator=torch.Generator().manual_seed(4))
    out = r(batch["point_clouds"], torch.Generator().manual_seed(4), jitter=True)
    loss, metrics = get_groupfree_loss(ep, batch, cfg, 2)
    want = ref.loss(out, batch, r.mean_size)
    assert abs(loss.item() - want.item()) <= LOSS_RTOL * abs(want.item())
    assert metrics["pos_ratio"] > 0 and metrics["kps_pos_ratio"] > 0
    loss.backward()
    want.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in got.values())
    assert worst_leaf(got, {n: p.grad for n, p in r.named_parameters()}) < GRAD_GAP


def test_pretrain_step_matches_the_reference_step():
    model, r, cfg = pair(torch.float64)
    batch = as_dtype(scenes(2), torch.float64)
    state = create_train_state(model, seed=7, weight_decay=5e-4)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = fetch_metrics(make_pretrain_step(cfg, loss=get_groupfree_loss)(
        state, batch, 0.006, 0.1))
    assert [g["lr"] for g in state.optimizer.param_groups] == [0.006, 0.006 * 0.1]
    opt = ref.make_optimizer(r, 5e-4)
    want = ref.pretrain_step(r, opt, batch, 0.006, 0.1, torch.Generator().manual_seed(7))
    assert abs(metrics["loss"] - want) <= LOSS_RTOL * abs(want)
    # AdamW's first step moves an element by lr x g / (|g| + 1e-8): where
    # |g| is near 1e-8 the gradients' round-off shifts that fraction of lr
    # (measured up to 0.5 % of lr)
    rp = dict(r.named_parameters())
    step = {}
    for n, p in model.named_parameters():
        got = p.detach() - start[n]
        assert torch.allclose(got, rp[n].detach() - start[n], rtol=0, atol=1e-2 * 0.006), n
        step[n] = got.abs().max().item()
    assert max(v for n, v in step.items() if "decoder" in n) < 0.0007
    assert max(v for n, v in step.items() if "decoder" not in n) > 0.005


def test_optimizer_groups_follow_the_release():
    model, _, _ = pair()
    groups = model.optimizer_groups()
    names = {id(p): n for n, p in model.named_parameters()}
    slow = {names[id(p)] for p in groups[1]["params"]}
    assert [g["lr_scale"] for g in groups] == [1.0, 0.1]
    assert slow == {n for n in names.values() if "decoder" in n}
    assert any(n.startswith("decoder_key_proj") for n in slow)
    assert not any(n.startswith("prediction_heads") for n in slow)
    assert len(groups[0]["params"]) + len(slow) == len(names)


def _old_pretrain_step(cfg):
    """``make_pretrain_step``'s step before it took a model's loss and lr
    scales, without its spans and data-parallel draws."""

    def step(state, batch, lr, bn_momentum):
        model, opt = state.model, state.optimizer
        model.train()
        set_bn_momentum(model, bn_momentum)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        point_clouds = batch["point_clouds"]
        ep = model.forward_with_pred_jitter(point_clouds, generator=state.generator)
        loss, metrics = get_labeled_loss(ep, batch, cfg, point_clouds.shape[0])
        loss.backward()
        opt.step()
        state.step += 1
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return step


def test_votenet_pretrain_step_is_unchanged_bit_for_bit():
    model, cfg = build_votenet(tiny=True, device="cpu")
    twin = copy.deepcopy(model)
    a, b = create_train_state(model, seed=1), create_train_state(twin, seed=1)
    assert type(a.optimizer) is torch.optim.Adam
    batch = scenes(3)
    new, old = make_pretrain_step(cfg), _old_pretrain_step(cfg)
    for _ in range(2):
        got, want = new(a, batch, 0.001, 0.5), old(b, batch, 0.001, 0.5)
        assert torch.equal(got["loss"], want["loss"])
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n


def test_evaluate_with_iou_guided_nms():
    model, r, cfg = pair()
    batch = scenes(4)
    model.eval()
    r.eval()
    labels = {k: v for k, v in batch.items() if k != "point_clouds"}
    out, metrics = make_eval_loss(model, cfg, loss=get_groupfree_eval_loss)(
        batch["point_clouds"], labels)
    want = r(batch["point_clouds"])
    assert rel_gap(out["center"], want["last_center"]) < HEADS_RTOL
    assert rel_gap(out["iou_scores"], want["iou_scores"]) < HEADS_RTOL
    assert np.isfinite(fetch_metrics(metrics)["loss"])
    config = ap_helper.eval_config_dict(cfg, use_iou_for_nms=True)
    got = ap_helper.parse_predictions(out, config)
    plain = ap_helper.parse_predictions_np({k: v.numpy() for k, v in out.items()}, config)
    assert [len(g) for g in got] == [len(p) for p in plain] and len(got[0]) > 0
    for gs, ps in zip(got, plain):
        for g, p in zip(gs, ps):
            assert g[0] == p[0] and np.array_equal(g[1], p[1]) and g[2] == p[2]
    # the NMS scores the sigmoid of the objectness logit x that of the IoU
    # logit at the argmax class
    scores, sem = ap_helper.nms_scores(out, config)
    gate = torch.sigmoid(out["iou_scores"]).gather(2, sem[..., None])[..., 0]
    assert torch.allclose(scores, torch.sigmoid(out["objectness_scores"][..., 1]) * gate,
                          rtol=1e-6, atol=0)

    def loader():
        yield batch

    logs = []
    means, ap, _ = evaluate(model, cfg, loader(), config, logs.append, make_eval_loss(
        model, cfg, loss=get_groupfree_eval_loss), (0.25, 0.5), opt_rate=5e-4, opt_step=2)
    assert set(ap) == {0.25, 0.5} and 0 <= ap[0.25]["AR"] <= 1 and "loss" in means


def test_iou_optimize_matches_the_reference_ascent():
    model, r, cfg = pair(torch.float64)
    pc = scenes(5)["point_clouds"].double()
    model.eval()
    r.eval()
    with torch.no_grad():
        ep = model(pc)
    got = iou_optimize(model, ep, 0.05, 2)
    out = r.detect(pc)
    cls = out["last_sem_cls_scores"].argmax(-1)
    center, half = out["last_center"].detach(), out["half_size"].detach()

    def iou(c, s):
        return r.grid_conv(c, s, out["seed_xyz"], out["seed_features"])

    for _ in range(3):
        c, s = center.clone().requires_grad_(True), half.clone().requires_grad_(True)
        gc, gs = torch.autograd.grad(iou(c, s).gather(2, cls[..., None]).sum(), (c, s))
        center, half = center + 0.05 * gc, half + 0.05 * gs
    assert (center - out["last_center"]).abs().max() > 1e-6
    for a, b in ((got["center"], center), (got["size"], half),
                 (got["iou_scores"], iou(center, half))):
        assert rel_gap(a, b) < 1e-6


def test_spans_and_counters_of_a_step():
    model, cfg = build_groupfree(tiny=True, num_decoder_layers=LAYERS, width=2, device="cpu")
    batch = scenes(6)
    state = create_train_state(model, seed=1)
    step = make_pretrain_step(cfg, loss=get_groupfree_loss)
    trace.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            metrics = step(state, batch, 0.006, 0.1)
        snap = trace.snapshot()
    finally:
        trace.reset()
    assert metrics["pos_ratio"] > 0
    for name in ("model.decoder", "model.kps", "train.step", "train.loss"):
        assert snap["spans"][name]["calls"] == 1, name
    obj = snap["counters"]["groupfree.obj_pos"]
    assert obj == round(metrics["pos_ratio"].item() * 2 * K) and obj > 0
    assert snap["counters"]["groupfree.kps_pos"] == round(
        metrics["kps_pos_ratio"].item() * 2 * 64) > 0


def test_the_largest_scannet_model_has_the_published_widths():
    model, _ = build_groupfree(num_decoder_layers=12, width=2, device="cpu")
    assert model.num_proposal == 256 and len(model.decoder) == 12
    bb = model.backbone_net
    widths = [[layer.conv.weight.shape[0] for layer in getattr(bb, f"sa{i}").mlp_module]
              for i in range(1, 5)]
    assert widths == [[128, 128, 256], [256, 256, 512], [256, 256, 512], [256, 256, 512]]
    assert bb.sa1.mlp_module.layer0.conv.weight.shape[1] == 3 + 1
    assert [l.conv.weight.shape[0] for l in bb.fp2.mlp] == [512, 288]
    layer = model.decoder[0]
    assert layer.self_attn.in_proj_weight.shape == (3 * 288, 288)
    assert layer.linear1.weight.shape == (2048, 288) and layer.self_attn.nhead == 8
    assert model.grid_conv.mlp_before_iou.layer0.conv.weight.shape[1] == 3 + 288
    assert 29e6 < sum(p.numel() for p in model.parameters()) < 31e6


def test_pretrain_driver_trains_and_evaluates_groupfree(tmp_path):
    log = str(tmp_path / "gf")
    flags = ["--model", "groupfree", "--num_decoder_layers", "2", "--width", "2",
             "--synthetic", "--synthetic_scenes", "8", "--tiny", "--num_point", "512",
             "--num_target", "16", "--num_workers", "2", "--batch_size", "2",
             "--device", "cpu"]
    pretrain.main(["--log_dir", log, "--max_epoch", "1", "--eval_interval", "1",
                   "--print_interval", "2", "--learning_rate", "0.006",
                   "--weight_decay", "0.0005"] + flags)
    text = open(f"{log}/log_train.txt").read()
    assert "kps_loss" in text and "eval mAP@0.25" in text
    _, ap, _ = pretrain.main(["--log_dir", log, "--resume", "--eval", "--use_iou_for_nms",
                              "--opt_step", "2"] + flags)
    assert set(ap) == {0.25, 0.5}
    for bad in (["--bf16"], ["--vote_factor", "2"], ["--cluster_sampling", "vote_fps"]):
        with pytest.raises(SystemExit, match="groupfree"):
            pretrain.main(["--log_dir", log] + flags + bad)
    with pytest.raises(SystemExit, match="groupfree"):
        train.main(["--log_dir", str(tmp_path / "ssl"), "--model", "groupfree",
                    "--device", "cpu"])
