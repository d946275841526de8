"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference computes again from the same
inputs and weights.

Training: the loss of each of the first steps; the norm of the first
gradient, leaf by leaf, as the program's Adam holds it; the norms of
Adam's moments after the first step, and after the second beside Adam's
rule applied to the program's own state; the norm of each leaf's change
after the first steps (and of the teacher's, in SSL). A gap of norms is |a - b| over the
reference's norm of that leaf or of the median leaf, whichever is larger,
taken at the worst leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's (a bias before a train-mode BatchNorm,
which the normalisation cancels) move under Adam by round-off alone: they
are left out of the change.

Eval: the heads of each sampled request, the boxes and IoU logits after
``iou_optimize`` (or of the forward), as the largest difference over the
largest magnitude of the reference's tensor; and the proposal lists of the
parse against the plain NumPy parse of the program's own outputs, scene by
scene (``picks_off``: the scenes whose lists differ).
"""
import numpy as np
import torch

SMALL_GRAD = 1e-3  # of the median leaf's gradient norm
BOX_HEADS = ("center", "size", "iou_scores")
HEADS = ("objectness_scores", "heading_scores", "heading_residuals", "size_scores",
         "size_residuals", "sem_cls_scores")
CORNER_ATOL = 1e-4  # metres: the parse's corners are float32 decodes of the same outputs
SCORE_RTOL = 1e-5


def norms(tensors: dict) -> dict:
    """{name: f64 norm} of each leaf, in one copy to the host."""
    names = sorted(tensors)
    if not names:
        return {}
    v = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu().numpy()
    return dict(zip(names, v.tolist()))


def worst_leaf(got: dict, want: dict, leaves) -> float:
    """A leaf the program did not report reads as infinitely far."""
    leaves = sorted(leaves)
    ref = np.array([want[n] for n in leaves])
    floor = np.maximum(ref, np.median(ref))
    gap = np.abs(np.array([got.get(n, np.nan) for n in leaves]) - ref) / np.maximum(floor, 1e-30)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def moved_leaves(ref_grad: dict) -> list:
    med = np.median(list(ref_grad.values()))
    return [n for n, v in ref_grad.items() if v >= SMALL_GRAD * med]


def _median_leaf(got: dict, want: dict, leaves) -> float:
    leaves = sorted(leaves)
    ref = np.array([want[n] for n in leaves])
    gap = np.abs(np.array([got.get(n, np.nan) for n in leaves]) - ref) / np.maximum(ref, 1e-30)
    return float(np.median(np.nan_to_num(gap, nan=np.inf)))


def train_numbers(got: dict, want: dict) -> dict:
    """``got``/``want``: {"losses": [..], "moments": {"exp_avg": {leaf:
    norm}, "exp_avg_sq": ..} after the first step, "first": {"change": ..,
    "teacher_change": ..} after the first step, "change" and
    "teacher_change" (SSL) {leaf: norm} after the first steps}; ``want``
    also holds "grad", the reference's first gradient, and "beta1", its
    Adam's; ``got`` holds "update2", its moments after the second step
    beside Adam's rule applied to its own state (``drivers/train.py``).
    The numbers a limit holds: ``loss_gap.step1``; ``grad_gap``, the
    program's first gradient as its Adam holds it (exp_avg / (1 - the
    reference's beta1), so a wrong beta1 shows); ``exp_avg_sq_gap``;
    ``exp_avg_update_gap.step2`` and ``exp_avg_sq_update_gap.step2``;
    ``change1_gap`` and ``teacher_change1_gap``. The later steps' loss
    gaps, the changes after all first steps and the median leaf's are the
    calibration's readings (PERF.md: the later steps carry the round-off
    of the first amplified)."""
    lp, lr = np.array(got["losses"], np.float64), np.array(want["losses"], np.float64)
    step_gaps = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)
    if not np.isfinite(lp).all():
        step_gaps[:] = np.inf
    grad = {n: v / (1.0 - want["beta1"]) for n, v in got["moments"]["exp_avg"].items()}
    sq = want["moments"]["exp_avg_sq"]
    out = {"loss_gap": float(step_gaps.max()),
           "grad_gap": worst_leaf(grad, want["grad"], want["grad"]),
           "exp_avg_sq_gap": worst_leaf(got["moments"]["exp_avg_sq"], sq, sq)}
    for i, g in enumerate(step_gaps):
        out[f"loss_gap.step{i + 1}"] = float(g)
    if "update2" in got:
        for key, rule in got["update2"]["want"].items():
            out[f"{key}_update_gap.step2"] = worst_leaf(got["update2"]["got"][key], rule, rule)
    moved = moved_leaves(want["grad"])
    for key in ("change", "teacher_change"):
        if key not in want:
            continue
        out[f"{key}1_gap"] = worst_leaf(got["first"][key], want["first"][key], moved)
        out[f"{key}1_gap.median"] = _median_leaf(got["first"][key], want["first"][key], moved)
        out[f"{key}_gap"] = worst_leaf(got[key], want[key], moved)
        out[f"{key}_gap.median"] = _median_leaf(got[key], want[key], moved)
    return out


def tensor_gap(p, r) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return float("inf")
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-12))


def same_lists(got: list, want: list) -> bool:
    """One scene's proposal lists: the same classes, corners within
    CORNER_ATOL and scores within SCORE_RTOL, in the same order."""
    if len(got) != len(want):
        return False
    for (cg, bg, sg), (cw, bw, sw) in zip(got, want):
        if int(cg) != int(cw) or not np.allclose(bg, bw, rtol=0.0, atol=CORNER_ATOL) \
                or not np.isclose(sg, sw, rtol=SCORE_RTOL, atol=0.0):
            return False
    return True


def eval_numbers(got: list, want: list, picks: list, want_picks: list) -> dict:
    """``got``/``want``: per sampled request a dict of host arrays (the
    heads); ``picks``/``want_picks``: per request the parse's lists."""
    heads = max(tensor_gap(g[k], w[k]) for g, w in zip(got, want) for k in HEADS)
    boxes = max(tensor_gap(g[k], w[k]) for g, w in zip(got, want) for k in BOX_HEADS)
    off = sum(not same_lists(a, b) for p, q in zip(picks, want_picks) for a, b in zip(p, q))
    off += sum(abs(len(p) - len(q)) for p, q in zip(picks, want_picks))
    return {"heads_gap": heads, "boxes_gap": boxes, "picks_off": float(off)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    holds: each at or under its limit; one that was not read fails. The
    other readings are the calibration's."""
    checks, ok = {}, bool(limits)
    for name in sorted(limits):
        v, lim = numbers.get(name), limits[name]
        checks[name] = {"value": v, "limit": lim}
        if v is None or not (v <= lim):
            ok = False
    return ok, checks
