"""Rotated 3D box IoU.

Counterpart of ``iou3dmatch_tpu/geometry/iou3d.py``, itself a rebuild of
OpenPCDet's ``iou3d_nms`` kernels. Boxes are (x, y, z, dx, dy, dz,
heading), z up; VoteNet's callers pack their headings negated
(``losses/iou_labels.py``), and this module takes them as given.

The BEV overlap of a pair follows ``_pair_overlap_bev`` step by step:

- the 4 corners of each box (``_corners``), rotated about the center;
- 24 candidate vertices in a fixed order: the 16 edge-edge intersections
  (edge i of A against edge j of B, i outer), then for each corner k the
  corner k of B if it lies in A and the corner k of A if it lies in B,
  with a 1e-2 containment margin;
- the centroid of the valid candidates, their angles about it by
  ``atan2``, a stable sort that puts invalid candidates last;
- the fan area from the first sorted vertex.

The 3D IoU multiplies it by the z overlap and divides by the union clamped
at 1e-6. Every pair is independent, so all four entry points are one
paired computation, ``box_pairs``: rows of B scenes, (B, K, 7) x (B, G, 7)
-> (B, K, G); an all-pairs product is the paired form with B = 1. On a
CUDA tensor ``box_pairs`` launches ``csrc/iou3d.cu``, which writes 0 for
the pairs ``pairs_apart`` rejects and computes each other pair with one
warp; ``box_pairs_plain`` is its plain PyTorch version.
"""
import torch

from ..ops import _build

_EPS = 1e-8
_MARGIN = 1e-2
# No corner lies in the other box's 1e-2 margin past an x or y gap of
# sqrt(2) x 1e-2; REACH covers that, and REL_REACH of a box's coordinates
# the rounding of its corners and tests. Each box's extents grow by half of
# REACH (csrc/iou3d.cu kHalfReach, kRelReach).
REACH = 1.5e-2
REL_REACH = 1e-5
MODES = {"overlap_bev": 0, "iou3d": 1, "iou_bev": 2}
_SX = (-1.0, 1.0, 1.0, -1.0)  # corner order of iou3d_nms_kernel.cu:127-134
_SY = (-1.0, -1.0, 1.0, 1.0)
_NEXT = [1, 2, 3, 0]


def _corners(box: torch.Tensor):
    """(..., 7) -> corner x and y, each (..., 4)."""
    sx = box.new_tensor(_SX)
    sy = box.new_tensor(_SY)
    lx = sx * (box[..., 3:4] * 0.5)
    ly = sy * (box[..., 4:5] * 0.5)
    c, s = torch.cos(box[..., 6:7]), torch.sin(box[..., 6:7])
    return lx * c - ly * s + box[..., 0:1], lx * s + ly * c + box[..., 1:2]


def _cross2(ox, oy, ax, ay, bx, by):
    """cross(a - o, b - o)."""
    return (ax - ox) * (by - oy) - (bx - ox) * (ay - oy)


def _seg_intersection(p0x, p0y, p1x, p1y, q0x, q0y, q1x, q1y):
    """Segments p0-p1 and q0-q1 (iou3d.py::_seg_intersection) -> (valid,
    x, y), with the general line-line form where the main one degenerates."""
    rect = ((torch.minimum(p0x, p1x) <= torch.maximum(q0x, q1x))
            & (torch.minimum(q0x, q1x) <= torch.maximum(p0x, p1x))
            & (torch.minimum(p0y, p1y) <= torch.maximum(q0y, q1y))
            & (torch.minimum(q0y, q1y) <= torch.maximum(p0y, p1y)))
    s1 = _cross2(p0x, p0y, q0x, q0y, p1x, p1y)
    s2 = _cross2(p0x, p0y, p1x, p1y, q1x, q1y)
    s3 = _cross2(q0x, q0y, p0x, p0y, q1x, q1y)
    s4 = _cross2(q0x, q0y, q1x, q1y, p1x, p1y)
    valid = rect & (s1 * s2 > 0) & (s3 * s4 > 0)
    s5 = _cross2(p0x, p0y, q1x, q1y, p1x, p1y)
    denom = s5 - s1
    main = denom.abs() > _EPS
    safe = torch.where(main, denom, 1.0)
    a0, b0, c0 = p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y
    a1, b1, c1 = q0y - q1y, q1x - q0x, q0x * q1y - q1x * q0y
    d = a0 * b1 - a1 * b0
    d_safe = torch.where(d.abs() > 0, d, 1.0)
    x = torch.where(main, (s5 * q0x - s1 * q1x) / safe, (b0 * c1 - b1 * c0) / d_safe)
    y = torch.where(main, (s5 * q0y - s1 * q1y) / safe, (a1 * c0 - a0 * c1) / d_safe)
    return valid, x, y


def _in_box(box: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Corners (..., 4) inside ``box`` (..., 7), with the 1e-2 margin."""
    c, s = torch.cos(-box[..., 6:7]), torch.sin(-box[..., 6:7])
    dx, dy = px - box[..., 0:1], py - box[..., 1:2]
    rx = dx * c - dy * s
    ry = dx * s + dy * c
    return ((rx.abs() < box[..., 3:4] * 0.5 + _MARGIN)
            & (ry.abs() < box[..., 4:5] * 0.5 + _MARGIN))


def bev_candidates(a: torch.Tensor, b: torch.Tensor):
    """The 24 candidate vertices of each pair of (..., 7) boxes, in the JAX
    order -> (x, y, valid), each (..., 24)."""
    ax, ay = _corners(a)
    bx, by = _corners(b)
    v16, ix, iy = _seg_intersection(
        ax[..., :, None], ay[..., :, None], ax[..., _NEXT][..., :, None], ay[..., _NEXT][..., :, None],
        bx[..., None, :], by[..., None, :], bx[..., _NEXT][..., None, :], by[..., _NEXT][..., None, :])
    # corner k of B (valid inside A), then corner k of A (inside B)
    cx = torch.stack([bx, ax], -1).flatten(-2)
    cy = torch.stack([by, ay], -1).flatten(-2)
    v8 = torch.stack([_in_box(a, bx, by), _in_box(b, ax, ay)], -1).flatten(-2)
    return (torch.cat([ix.flatten(-2), cx], -1), torch.cat([iy.flatten(-2), cy], -1),
            torch.cat([v16.flatten(-2), v8], -1))


def _overlap_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV intersection areas of paired (..., 7) boxes -> (...)."""
    px, py, valid = bev_candidates(a, b)
    vf = valid.to(px.dtype)
    cnt = valid.sum(-1)
    cnt_safe = cnt.clamp(min=1).to(px.dtype)
    cx = (px * vf).sum(-1, keepdim=True) / cnt_safe[..., None]
    cy = (py * vf).sum(-1, keepdim=True) / cnt_safe[..., None]
    ang = torch.where(valid, torch.atan2(py - cy, px - cx), float("inf"))
    order = torch.sort(ang, dim=-1, stable=True).indices
    sx, sy = px.gather(-1, order), py.gather(-1, order)
    vx, vy = sx - sx[..., :1], sy - sy[..., :1]
    crosses = vx[..., :-1] * vy[..., 1:] - vx[..., 1:] * vy[..., :-1]
    k = torch.arange(1, 24, device=px.device)
    area = torch.where(k < cnt[..., None], crosses, 0.0).sum(-1)
    return torch.where(cnt > 0, area.abs() * 0.5, 0.0)


def box_extents(box: torch.Tensor):
    """(..., 7) -> (lo, hi), each (..., 2): the x and y extents of the
    box's corners, each grown by its reach, 0.5 REACH + REL_REACH x (|x| +
    |y| + |dx| + |dy|)."""
    cx, cy = _corners(box)
    reach = 0.5 * REACH + REL_REACH * box[..., [0, 1, 3, 4]].abs().sum(-1, keepdim=True)
    return (torch.stack([cx.amin(-1), cy.amin(-1)], -1) - reach,
            torch.stack([cx.amax(-1), cy.amax(-1)], -1) + reach)


def pairs_apart(boxes_a: torch.Tensor, boxes_b: torch.Tensor, mode: str) -> torch.Tensor:
    """(..., 7) x (..., 7) boxes, broadcast -> (...) bool: where the pair's
    grown x or y extents do not meet, so that it has no candidate vertex,
    or, in mode "iou3d", its z ranges do not overlap. ``box_pairs`` is
    exactly 0 there, and ``csrc/iou3d.cu`` writes 0 without computing the
    pair. The z test is the plain version's own z overlap."""
    a, b = boxes_a.float(), boxes_b.float()
    (alo, ahi), (blo, bhi) = box_extents(a), box_extents(b)
    apart = ((ahi < blo) | (bhi < alo)).any(-1)
    if mode == "iou3d":
        h = (torch.minimum(a[..., 2] + a[..., 5] * 0.5, b[..., 2] + b[..., 5] * 0.5)
             - torch.maximum(a[..., 2] - a[..., 5] * 0.5, b[..., 2] - b[..., 5] * 0.5))
        apart = apart | (h <= 0)
    return apart


def box_pairs_plain(boxes_a: torch.Tensor, boxes_b: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of ``box_pairs``: (B, K, 7) x (B, G, 7) ->
    (B, K, G) BEV overlap, 3D IoU or BEV IoU (``mode``)."""
    a = boxes_a.float()[:, :, None, :]
    b = boxes_b.float()[:, None, :, :]
    a, b = torch.broadcast_tensors(a, b)
    overlap = _overlap_bev(a, b)
    if mode == "overlap_bev":
        return overlap
    if mode == "iou_bev":
        union = a[..., 3] * a[..., 4] + b[..., 3] * b[..., 4] - overlap
        return overlap / union.clamp(min=1e-6)
    if mode != "iou3d":
        raise ValueError(f"unknown mode {mode!r}")
    a_zmax, a_zmin = a[..., 2] + a[..., 5] * 0.5, a[..., 2] - a[..., 5] * 0.5
    b_zmax, b_zmin = b[..., 2] + b[..., 5] * 0.5, b[..., 2] - b[..., 5] * 0.5
    h = (torch.minimum(a_zmax, b_zmax) - torch.maximum(a_zmin, b_zmin)).clamp(min=0.0)
    inter = overlap * h
    vol_a = a[..., 3] * a[..., 4] * a[..., 5]
    vol_b = b[..., 3] * b[..., 4] * b[..., 5]
    return inter / (vol_a + vol_b - inter).clamp(min=1e-6)


def box_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor, mode: str = "iou3d") -> torch.Tensor:
    """(B, K, 7) x (B, G, 7) f32 -> (B, K, G): for each scene b, ``mode``
    ("overlap_bev", "iou3d" or "iou_bev") of every box of ``boxes_a[b]``
    with every box of ``boxes_b[b]``. No gradient."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if boxes_a.device.type == "cpu":
        return box_pairs_plain(boxes_a.detach(), boxes_b.detach(), mode)
    _build.require(boxes_a, torch.float32, "boxes_a")
    _build.require(boxes_b, torch.float32, "boxes_b", boxes_a.device)
    if boxes_a.dim() != 3 or boxes_b.dim() != 3 or boxes_a.shape[2] != 7 \
            or boxes_b.shape[2] != 7 or boxes_a.shape[0] != boxes_b.shape[0]:
        raise ValueError(f"boxes (B, K, 7) and (B, G, 7) expected, got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    b, k, _ = boxes_a.shape
    g = boxes_b.shape[1]
    out = torch.empty((b, k, g), dtype=torch.float32, device=boxes_a.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel("iou3d", "iou3d_launch", (_build.VP,) * 3 + (_build.INT,) * 4 + (_build.VP,))
    _build.check(fn(boxes_a.data_ptr(), boxes_b.data_ptr(), out.data_ptr(), b, k, g, MODES[mode],
                    _build.stream(boxes_a)), "iou3d")
    box_pairs.launches += 1
    return out


box_pairs.launches = 0


def boxes_iou3d_paired_rows(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Same-scene 3D IoU, (B, K, 7) x (B, G, 7) -> (B, K, G)."""
    return box_pairs(boxes_a.float().contiguous(), boxes_b.float().contiguous(), "iou3d")


def _all_pairs(boxes_a, boxes_b, mode):
    a = boxes_a.float().contiguous()[None]
    b = boxes_b.float().contiguous()[None]
    return box_pairs(a, b, mode)[0]


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV intersection areas."""
    return _all_pairs(boxes_a, boxes_b, "overlap_bev")


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) 3D IoU (``boxes_iou3d_gpu``)."""
    return _all_pairs(boxes_a, boxes_b, "iou3d")


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV IoU."""
    return _all_pairs(boxes_a, boxes_b, "iou_bev")
