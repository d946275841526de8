"""Non-maximum suppression and lower-half suppression.

Counterpart of ``iou3dmatch_tpu/geometry/nms.py``:

- the NumPy NMS of the host-side eval path (``:14-112``, reference
  ``utils/nms.py:20-230``): ``nms_2d_faster``, ``nms_3d_faster``,
  ``nms_3d_faster_samecls``, ``lhs_3d_faster_samecls``, ``nms_2d`` and
  ``nms_crnr_dist``;
- ``nms_boxes_plain``, the batched tensor form of the three NumPy NMS
  branches of ``parse_predictions``, and ``nms_masked_plain``, that of the
  greedy NMS over an IoU matrix ``_nms_jax`` (``:170-191``), with
  ``nms_rotated`` and ``nms_normal`` (``:194-224``) on top of it;
  ``ops/nms.py`` runs them on CPU tensors and launches ``csrc/nms.cu`` on
  CUDA ones;
- ``lhs_3d_samecls_plain``, the batched tensor form of the on-device
  lower-half suppression ``lhs_3d_samecls_jax`` (``:115-167``) that dedups
  the teacher's pseudo labels; ``ops/lhs.py`` launches ``csrc/lhs.cu``.

Tie order. The JAX package's NumPy loops read ``np.argsort(score)`` from
the back, and that sort is not stable, so which of two equal scores goes
first is not defined there. The port's rule, here and in the kernel: the
higher score first; among equal scores the higher index first
(``argsort(kind="stable")`` read from the back); NaN scores before any
number, as ``argsort`` puts NaN last. On scores without ties the picks are
the JAX package's. ``_nms_jax`` breaks ties to the lower index instead
(``jnp.argmax`` takes the first maximum, and NaN as the largest), and so
does ``nms_masked_plain``.
"""
import numpy as np
import torch

# the three NMS branches of parse_predictions: (the box axes the overlap
# spans, the class gate, the dtype of its boxes and overlaps)
BOX_MODES = {
    "2d": ((0, 2), False, torch.float32),
    "3d": ((0, 1, 2), False, torch.float32),
    "3d_cls": ((0, 1, 2), True, torch.float64),
}


def _order(score):
    """Ascending order of ``score`` whose back is the port's pick order."""
    return np.argsort(score, kind="stable")


def _nms_loop(boxes, overlap_threshold, old_type, same_cls, lhs, area_eps):
    x1, y1, z1 = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    x2, y2, z2 = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    score = boxes[:, 6]
    cls = boxes[:, 7] if same_cls else None
    area = (x2 - x1) * (y2 - y1) * (z2 - z1) + area_eps

    order = _order(score)
    pick = []
    while order.size != 0:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        l = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        w = np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        h = np.maximum(0, np.minimum(z2[i], z2[rest]) - np.maximum(z1[i], z1[rest]))
        inter = l * w * h
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        if same_cls:
            o = o * (cls[i] == cls[rest])
        inds = np.where(o > overlap_threshold)[0]
        if lhs:
            # keep the upper (higher-score) half of the suppressed cluster
            # (utils/nms.py:206-211)
            for count in range(len(inds) // 2):
                pick.append(rest[inds[len(inds) - count - 1]])
        order = np.delete(order, np.concatenate(([order.size - 1], inds)))
    return pick


def nms_crnr_dist(boxes, conf, overlap_threshold):
    """NMS by corner-distance similarity instead of IoU (utils/nms.py:215-230):
    boxes (n, 8, 3) camera-frame corners, conf (n,). Suppresses the boxes
    whose ``bbox_corner_dist_measure`` to the current top box exceeds
    ``overlap_threshold``."""
    from ..data.pc_util import bbox_corner_dist_measure

    boxes = np.asarray(boxes)
    order = _order(np.asarray(conf))
    pick = []
    while order.size != 0:
        last = order.size
        i = order[-1]
        pick.append(int(i))
        scores = [bbox_corner_dist_measure(boxes[i], boxes[ind]) for ind in order[:-1]]
        order = np.delete(
            order,
            np.concatenate(([last - 1], np.where(np.array(scores) > overlap_threshold)[0])))
    return pick


def nms_2d(boxes, overlap_threshold):
    """Plain 2D NMS with intersection / area overlap; boxes (n, 5)
    [x1, y1, x2, y2, score] (utils/nms.py:20-49): ``nms_2d_faster`` with
    ``old_type``."""
    return nms_2d_faster(boxes, overlap_threshold, old_type=True)


def nms_2d_faster(boxes, overlap_threshold, old_type=False):
    """boxes: (n, 5) [x1,y1,x2,y2,score] (utils/nms.py:52-83)."""
    x1, y1, x2, y2, score = (boxes[:, k] for k in range(5))
    area = (x2 - x1) * (y2 - y1)
    order = _order(score)
    pick = []
    while order.size != 0:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        w = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        h = np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        inter = w * h
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = np.delete(
            order, np.concatenate(([order.size - 1], np.where(o > overlap_threshold)[0]))
        )
    return pick


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """boxes: (n, 7) [x1,y1,z1,x2,y2,z2,score] (utils/nms.py:86-122)."""
    return _nms_loop(boxes, overlap_threshold, old_type, False, False, 0.0)


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """boxes: (n, 8) [...,score,cls] (utils/nms.py:125-165)."""
    return _nms_loop(boxes, overlap_threshold, old_type, True, False, 0.0)


def lhs_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """Lower-half suppression (utils/nms.py:168-214). Note the +1e-8 area."""
    return _nms_loop(boxes, overlap_threshold, old_type, True, True, 1e-8)


def _goes_before(scores: torch.Tensor, higher_index_first: bool) -> torch.Tensor:
    """(B, K, K) bool: [a, b] where box a goes before box b. NaN scores
    first, then the higher score; among equal scores (and among NaN) the
    higher index first, or the lower one."""
    k = scores.shape[1]
    idx = torch.arange(k, device=scores.device)
    s_a, s_b = scores[:, :, None], scores[:, None]
    n_a, n_b = torch.isnan(s_a), torch.isnan(s_b)
    index_first = (idx[:, None] > idx[None]) if higher_index_first else (idx[:, None] < idx[None])
    return (n_a & (~n_b | index_first)) | (~n_a & ~n_b & ((s_a > s_b) | ((s_a == s_b) & index_first)))


def _greedy(over: torch.Tensor, scores: torch.Tensor, valid, higher_index_first: bool,
            first_box_when_stuck: bool) -> torch.Tensor:
    """Greedy NMS on a (B, K, K) bool suppression matrix (``over[b, i, j]``:
    winner i suppresses box j): each round the remaining box that goes
    first in the order of ``_goes_before`` wins and is kept, and the
    remaining boxes its row holds are removed. Boxes outside ``valid``
    take no part. With ``first_box_when_stuck`` (``_nms_jax``'s masked
    argmax), once every remaining box scores -inf the winner is the first
    valid box, remaining or not, and the rounds after it change nothing."""
    b, k = scores.shape
    dev = scores.device
    valid = torch.ones((b, k), dtype=torch.bool, device=dev) if valid is None else valid.bool()
    before = _goes_before(scores, higher_index_first) & valid[:, :, None]
    pos = torch.where(valid, before.sum(1), k)  # each valid box's place in the order
    idx = torch.arange(k, device=dev)
    rows = torch.arange(b, device=dev)
    first_valid = torch.where(valid, idx, k).amin(1).clamp(max=k - 1)
    remaining, keep = valid.clone(), torch.zeros_like(valid)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(k):
        live = remaining.any(1) & ~done
        if not bool(live.any()):
            break
        win = torch.where(remaining, pos, k + 1).argmin(1)
        if first_box_when_stuck:
            stuck = live & ~(remaining & (scores != -torch.inf)).any(1)
            win = torch.where(stuck, first_valid, win)
            done = done | stuck
        hot = idx == win[:, None]
        supp = remaining & over[rows, win] & ~hot
        keep = keep | (hot & live[:, None])
        remaining = torch.where(live[:, None], remaining & ~supp & ~hot, remaining)
    return keep


def box_overlaps(mins: torch.Tensor, maxs: torch.Tensor, cls, mode: str,
                 old_type: bool) -> torch.Tensor:
    """The (B, K, K) overlap ``o[b, i, r]`` of winner i with box r in
    ``_nms_loop``'s order of operations and in ``mode``'s dtype
    (``BOX_MODES``): area ((dx dy) dz) or dx dz, each side max(0, min of
    the highs - max of the lows), inter the product of the sides in the same
    order, o = inter / ((area_i + area_r) - inter), or inter / area_r with
    ``old_type``, times the class gate in ``3d_cls``."""
    axes, gated, dtype = BOX_MODES[mode]
    lo, hi = mins.to(dtype), maxs.to(dtype)
    dims = [hi[..., a] - lo[..., a] for a in axes]
    sides = [(torch.minimum(hi[:, :, None, a], hi[:, None, :, a])
              - torch.maximum(lo[:, :, None, a], lo[:, None, :, a])).clamp(min=0) for a in axes]
    area, inter = dims[0], sides[0]
    for d, s in zip(dims[1:], sides[1:]):
        area, inter = area * d, inter * s
    o = inter / area[:, None, :] if old_type else inter / ((area[:, :, None] + area[:, None, :]) - inter)
    if gated:
        o = o * (cls[:, :, None] == cls[:, None, :]).to(dtype)
    return o


def nms_boxes_plain(mins: torch.Tensor, maxs: torch.Tensor, scores: torch.Tensor, cls,
                    valid, mode: str, old_type: bool, thresh: float) -> torch.Tensor:
    """The three NMS branches of ``parse_predictions`` over each of B scenes
    (JAX ``eval/ap_helper.py:95-135``): mins, maxs (B, K, 3) f32
    camera-frame bounds, scores (B, K) f32, cls (B, K) integer classes (for
    ``3d_cls``, else None), valid (B, K) bool or None -> (B, K) bool keep
    mask. ``2d`` spans axes x and z, as ``nms_2d_faster``; ``3d`` is
    ``nms_3d_faster``; ``3d_cls`` is ``nms_3d_faster_samecls``, in float64
    as the JAX package's boxes there are. The overlap is compared with
    ``thresh`` rounded to the branch's dtype; a NaN overlap suppresses
    nothing. Picks follow the port's tie order (the module docstring);
    boxes outside ``valid`` are neither kept nor suppress."""
    if mode not in BOX_MODES:
        raise ValueError(f"unknown NMS mode {mode!r}; one of {sorted(BOX_MODES)}")
    dtype = BOX_MODES[mode][2]
    over = box_overlaps(mins, maxs, cls, mode, old_type) > torch.tensor(thresh, dtype=dtype)
    return _greedy(over, scores, valid, True, False)


def nms_masked_plain(iou: torch.Tensor, scores: torch.Tensor, thresh: float,
                     valid=None) -> torch.Tensor:
    """Greedy NMS over each of B scenes' (K, K) f32 IoU matrix, as
    ``_nms_jax`` (JAX ``geometry/nms.py:170-191``): iou (B, K, K), scores
    (B, K) -> (B, K) bool keep mask. Each round the remaining box of the
    highest score wins (ties and NaN to the lower index, NaN first), and
    suppresses the remaining boxes j with iou[winner, j] > thresh, compared
    in f32. Once every remaining box scores -inf, the winner is the first
    box, whether it remains or not (the masked argmax of an all -inf row).
    With ``valid`` it is ``_nms_jax`` on each scene's valid boxes alone."""
    over = iou > torch.tensor(thresh, dtype=torch.float32)
    return _greedy(over, scores, valid, False, True)


def nms_normal_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(B, K, 7) boxes -> (B, K, K) axis-aligned BEV IoU, heading ignored, as
    ``nms_normal_jax`` computes it (JAX ``geometry/nms.py:205-224``): the
    union clipped at 1e-6."""
    xmin, xmax = boxes[..., 0] - boxes[..., 3] / 2, boxes[..., 0] + boxes[..., 3] / 2
    ymin, ymax = boxes[..., 1] - boxes[..., 4] / 2, boxes[..., 1] + boxes[..., 4] / 2
    ix = (torch.minimum(xmax[:, :, None], xmax[:, None]) - torch.maximum(xmin[:, :, None], xmin[:, None])).clamp(min=0.0)
    iy = (torch.minimum(ymax[:, :, None], ymax[:, None]) - torch.maximum(ymin[:, :, None], ymin[:, None])).clamp(min=0.0)
    inter = ix * iy
    area = boxes[..., 3] * boxes[..., 4]
    return inter / (area[:, :, None] + area[:, None] - inter).clamp(min=1e-6)


def samecls_iou_aabb(mins: torch.Tensor, maxs: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """The (B, K, K) IoU of each scene's axis-aligned boxes, 0 across
    classes, in the JAX function's order: area (dx dy) dz + 1e-8, IoU
    inter / ((area_i + area_j) - inter), times the class gate."""
    dims = (maxs - mins).clamp(min=0.0)
    area = dims[..., 0] * dims[..., 1] * dims[..., 2] + 1e-8
    side = (torch.minimum(maxs[:, :, None], maxs[:, None])
            - torch.maximum(mins[:, :, None], mins[:, None])).clamp(min=0.0)
    inter = side[..., 0] * side[..., 1] * side[..., 2]
    iou = inter / ((area[:, :, None] + area[:, None]) - inter)
    return iou * (cls[:, :, None] == cls[:, None]).to(iou.dtype)


def lhs_3d_samecls_plain(mins: torch.Tensor, maxs: torch.Tensor, scores: torch.Tensor,
                         cls: torch.Tensor, thresh: float) -> torch.Tensor:
    """Lower-half suppression over the K axis-aligned boxes of each of B
    scenes: mins, maxs (B, K, 3) f32, scores (B, K) f32, cls (B, K)
    integer classes -> (B, K) bool keep mask.

    K fixed rounds, each gated on whether any box remains, with no read
    back to the host: pick the remaining box of highest score (ties to
    the higher index), suppress the remaining boxes of its class whose
    IoU with it exceeds ``thresh``, and keep back the better half of the
    suppressed cluster (rank < n_supp // 2, ties ranked by index). The
    IoU is inter / ((area_i + area_j) - inter) with area (dx dy) dz +
    1e-8, times the class gate, in the order of the JAX function."""
    b, k = scores.shape
    thresh = float(np.float32(thresh))  # compared in f32, as JAX does
    iou = samecls_iou_aabb(mins, maxs, cls)
    idx = torch.arange(k, device=scores.device)
    s_a, s_b = scores[:, :, None], scores[:, None]
    above = (s_a < s_b) | ((s_a == s_b) & (idx[:, None] < idx[None]))  # [a, b]: b ranks above a
    rows = torch.arange(b, device=scores.device)
    remaining = torch.ones((b, k), dtype=torch.bool, device=scores.device)
    keep = torch.zeros_like(remaining)
    for _ in range(k):
        any_left = remaining.any(1, keepdim=True)
        sc = torch.where(remaining, scores, -torch.inf)
        win = (k - 1) - sc.flip(1).argmax(1)  # the last maximum
        hot = idx == win[:, None]
        supp = remaining & (iou[rows, win] > thresh) & ~hot
        n_supp = supp.sum(1, keepdim=True)
        rank = (above & supp[:, None]).sum(2)
        keep = keep | ((hot | (supp & (rank < n_supp // 2))) & any_left)
        remaining = torch.where(any_left, remaining & ~supp & ~hot, remaining)
    return keep


