"""The port's greedy NMS against the JAX package, and a NumPy model of its
kernel against the plain version, on the CPU.

- ``nms_boxes_plain`` (the three NMS branches of ``parse_predictions``)
  equals the JAX package's NumPy ``nms_2d_faster``, ``nms_3d_faster`` and
  ``nms_3d_faster_samecls``, applied as ``parse_predictions`` applies them
  (on each scene's valid boxes, float32 boxes for the first two, float64
  for the class-aware one), in both ``old_type``s. Exactly on cases without
  tied scores; on tied ones, where the JAX package's unstable
  ``np.argsort`` leaves the order open, exactly against the same functions
  run with ``argsort(kind="stable")``, the port's rule.
- ``nms_masked_plain`` equals ``_nms_jax`` (vmapped) exactly on every case,
  and the port's ``nms_rotated`` and ``nms_normal`` equal
  ``nms_rotated_jax`` and ``nms_normal_jax``.
- ``kernel_model``, a NumPy model of ``csrc/nms.cu`` (its 64-bit key sort,
  the bit matrix of later positions with zero intersections tested without
  dividing, the scan over the positions with the all -inf rule of matrix
  mode), equals the plain version bit for bit.
- The port's NumPy ``lhs_3d_faster_samecls``, ``nms_2d`` and
  ``nms_crnr_dist`` equal the JAX package's.
"""
import numpy as np
import pytest
import torch
from nms_cases import CASES, has_ties

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from iou3dmatch_tpu_torch.geometry import nms as pnms  # noqa: E402
from iou3dmatch_tpu_torch.ops.nms import MAX_BOXES, nms_boxes, nms_masked  # noqa: E402

MODES = ("2d", "3d", "3d_cls")


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _stable_argsort(monkeypatch):
    """np.argsort with kind="stable" while the context lasts: the JAX
    package's NumPy loops under the port's tie rule."""
    plain = np.argsort
    monkeypatch.setattr(np, "argsort", lambda a, *args, **kw: plain(a, *args, kind="stable"))


def _jax_numpy_keep(case, mode, old_type):
    """The JAX package's NumPy NMS, scene by scene on the valid boxes, as
    its parse_predictions builds the boxes (ap_helper.py:95-135)."""
    from iou3dmatch_tpu.geometry import nms as jnms

    mins, maxs, scores, cls = (case[k] for k in ("mins", "maxs", "scores", "cls"))
    b, k = scores.shape
    keep = np.zeros((b, k), bool)
    for i in range(b):
        idx = np.arange(k) if case["valid"] is None else np.where(case["valid"][i])[0]
        if mode == "2d":
            boxes = np.stack([mins[i, :, 0], mins[i, :, 2], maxs[i, :, 0], maxs[i, :, 2],
                              scores[i]], axis=1)
            pick = jnms.nms_2d_faster(boxes[idx], case["thresh"], old_type)
        elif mode == "3d":
            boxes = np.concatenate([mins[i], maxs[i], scores[i, :, None]], axis=1)
            pick = jnms.nms_3d_faster(boxes[idx], case["thresh"], old_type)
        else:
            boxes = np.concatenate([mins[i], maxs[i], scores[i, :, None],
                                    cls[i, :, None].astype(np.float64)], axis=1)
            pick = jnms.nms_3d_faster_samecls(boxes[idx], case["thresh"], old_type)
        keep[i, idx[np.asarray(pick, dtype=np.int64)]] = True
    return keep


def _plain_boxes(case, mode, old_type):
    return pnms.nms_boxes_plain(_t(case["mins"]), _t(case["maxs"]), _t(case["scores"]),
                                _t(case["cls"]) if mode == "3d_cls" else None, _t(case["valid"]),
                                mode, old_type, case["thresh"]).numpy()


@pytest.mark.parametrize("old_type", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_boxes_plain_matches_jax_numpy(name, mode, old_type, monkeypatch):
    case = CASES[name]()
    got = _plain_boxes(case, mode, old_type)
    with monkeypatch.context() as m:
        if has_ties(case):
            _stable_argsort(m)
        want = _jax_numpy_keep(case, mode, old_type)
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version on CPU tensors
    wrapped = nms_boxes(_t(case["mins"]), _t(case["maxs"]), _t(case["scores"]), _t(case["cls"]),
                        _t(case["valid"]), mode, old_type, case["thresh"])
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_ties_change_what_the_unstable_sort_picks(monkeypatch):
    """On tied scores the JAX package's unstable argsort picks otherwise than
    the port's stable rule (what the stable comparison above is for); the
    port's picks are the stable ones."""
    from iou3dmatch_tpu.geometry import nms as jnms

    rng = np.random.RandomState(0)
    differ = 0
    for _ in range(20):
        boxes = np.zeros((128, 7), np.float32)
        boxes[:, 0:3] = rng.uniform(0, 3.0, (128, 3))
        boxes[:, 3:6] = boxes[:, 0:3] + 1.0
        boxes[:, 6] = np.round(rng.rand(128) * 4) / 4  # scores on a quarter grid
        unstable = jnms.nms_3d_faster(boxes, 0.25)
        with monkeypatch.context() as m:
            _stable_argsort(m)
            stable = jnms.nms_3d_faster(boxes, 0.25)
        differ += unstable != stable
        keep = pnms.nms_boxes_plain(*(torch.from_numpy(x[None]) for x in (
            boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6])), None, None, "3d", False, 0.25)
        assert np.flatnonzero(keep[0].numpy()).tolist() == sorted(stable)
    assert differ > 0


def _iou_3d(case):
    return pnms.box_overlaps(_t(case["mins"]), _t(case["maxs"]), None, "3d", False).float()


def _jax_masked(iou, scores, valid, thresh):
    from iou3dmatch_tpu.geometry.nms import _nms_jax

    b, k = scores.shape
    keep = np.zeros((b, k), bool)
    fn = jax.jit(_nms_jax, static_argnums=2)
    for i in range(b):
        idx = np.arange(k) if valid is None else np.where(valid[i])[0]
        if idx.size:
            keep[i, idx] = np.asarray(fn(jnp.asarray(iou[i][np.ix_(idx, idx)]),
                                         jnp.asarray(scores[i, idx]), thresh))
    return keep


@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_masked_plain_matches_nms_jax(name):
    case = CASES[name]()
    iou = _iou_3d(case)
    got = pnms.nms_masked_plain(iou, _t(case["scores"]), case["thresh"], _t(case["valid"]))
    want = _jax_masked(iou.numpy(), case["scores"], case["valid"], case["thresh"])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nms_masked(iou, _t(case["scores"]), case["thresh"],
                                             _t(case["valid"])).numpy(), want)


# JAX compiles its rotated IoU for each K (4-5 s each): three shapes of it
ROTATED = ("clustered_k128", "special_k33", "all_neg_inf_k20")


@pytest.mark.parametrize("name,kind", [(n, "normal") for n in sorted(CASES)]
                         + [(n, "rotated") for n in ROTATED])
def test_nms_rotated_and_normal_match_jax(name, kind):
    from iou3dmatch_tpu.geometry import nms as jnms

    case = CASES[name]()
    boxes, scores = case["boxes"], case["scores"]
    port = pnms.nms_rotated if kind == "rotated" else pnms.nms_normal
    jfn = jax.jit(jnms.nms_rotated_jax if kind == "rotated" else jnms.nms_normal_jax,
                  static_argnums=2)
    got = port(_t(boxes), _t(scores), case["thresh"]).numpy()
    want = np.stack([np.asarray(jfn(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), case["thresh"]))
                     for i in range(boxes.shape[0])])
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- the kernel's model

def order_key(s: np.ndarray, low: np.ndarray) -> np.ndarray:
    """csrc/nms.cu order_key: the float's bits as an order-keeping unsigned
    int (-0 as +0, NaN above +inf) over the tie-breaking ``low``."""
    u = np.where(s == 0, np.float32(0), s).astype(np.float32).view(np.uint32)
    o = np.where(np.isnan(s), np.uint32(0xFFFFFFFF),
                 np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)))
    return (o.astype(np.uint64) << np.uint64(32)) | low.astype(np.uint64)


def _overlap_rows(lo, hi, area, label, mode, old_type, thresh):
    """(n, n) bool by position: row r suppresses column c > r, each overlap
    in the kernel's order of operations and type."""
    dtype = np.float64 if mode == "3d_cls" else np.float32
    with np.errstate(invalid="ignore", divide="ignore"):
        side = np.maximum(dtype(0), np.minimum(hi[:, None], hi[None]) - np.maximum(lo[:, None], lo[None]))
        inter = side[..., 0] * side[..., 1]
        if side.shape[-1] == 3:
            inter = inter * side[..., 2]
        den = np.broadcast_to(area[None], inter.shape) if old_type else (area[:, None] + area[None]) - inter
        o = inter / den
        if mode == "3d_cls":
            o = o * (label[:, None] == label[None]).astype(dtype)
        # a zero intersection is tested without dividing
        over = np.where(inter == 0, (den != 0) & (den == den) & (dtype(0) > dtype(thresh)),
                        o > dtype(thresh))
    return np.triu(over, 1)


def kernel_model(case, mode, old_type):
    """csrc/nms.cu step by step in NumPy: the keys and positions, the bit
    rows of later positions as 64-bit words, and thread 0's scan over the
    positions (a position not removed when the scan reaches it wins; in
    matrix mode an all -inf remainder gives the first valid box)."""
    scores, thresh = case["scores"], case["thresh"]
    b, k = scores.shape
    valid = np.ones((b, k), bool) if case["valid"] is None else case["valid"]
    keep = np.zeros((b, k), bool)
    matrix = mode == "matrix"
    iou = _iou_3d(case).numpy() if matrix else None
    for s in range(b):
        idx = np.arange(k)
        key = np.where(valid[s], order_key(scores[s], (k - 1 - idx) if matrix else idx), 0)
        n = int(valid[s].sum())
        pos = np.array([(key > key[i]).sum() for i in range(k)])
        box_at = np.zeros(n, np.int64)
        box_at[pos[valid[s]]] = idx[valid[s]]
        if matrix:
            over = np.triu(iou[s][np.ix_(box_at, box_at)] > np.float32(thresh), 1)
        else:
            axes = [0, 2] if mode == "2d" else [0, 1, 2]
            dtype = np.float64 if mode == "3d_cls" else np.float32
            lo = case["mins"][s][box_at][:, axes].astype(dtype)
            hi = case["maxs"][s][box_at][:, axes].astype(dtype)
            d = hi - lo
            area = d[:, 0] * d[:, 1]
            if len(axes) == 3:
                area = area * d[:, 2]
            over = _overlap_rows(lo, hi, area, case["cls"][s][box_at], mode, old_type, thresh)
        rows = [0] * n  # row r: the later positions it suppresses, as one int
        for r in range(n):
            for c in np.flatnonzero(over[r]):
                rows[r] |= 1 << int(c)
        words = [(row >> (64 * v)) & ((1 << 64) - 1) for row in rows for v in range(4)]
        first = np.where(valid[s])[0]
        pf = int(pos[first[0]]) if first.size else 0
        removed, won, stuck = [0] * 4, [0] * 4, False
        for q in range(n):  # thread 0's scan, 64-bit words
            w, bit = q // 64, 1 << (q % 64)
            wins = not removed[w] & bit
            if matrix:
                stuck = stuck or (wins and scores[s, box_at[q]] == -np.inf and q != pf)
                wins = wins and not stuck
            for v in range(w, 4):
                removed[v] |= words[4 * q + v] if wins else 0
            won[w] |= bit if wins else 0
        if matrix and stuck:
            won[pf // 64] |= 1 << (pf % 64)
        for i in idx[valid[s]]:
            p = int(pos[i])
            keep[s, i] = bool(won[p // 64] >> (p % 64) & 1)
    return keep


@pytest.mark.parametrize("mode,old_type", [(m, o) for m in MODES for o in (False, True)]
                         + [("matrix", False)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_plain(name, mode, old_type):
    case = CASES[name]()
    got = kernel_model(case, mode, old_type)
    if mode == "matrix":
        want = pnms.nms_masked_plain(_iou_3d(case), _t(case["scores"]), case["thresh"],
                                     _t(case["valid"])).numpy()
    else:
        want = _plain_boxes(case, mode, old_type)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- the NumPy copies

@pytest.mark.parametrize("name", ["clustered_k128", "one_class_k128", "near_threshold_k64",
                                  "special_k33", "apart_k64"])
def test_numpy_copies_match_jax(name, monkeypatch):
    from iou3dmatch_tpu.geometry import nms as jnms

    case = CASES[name]()
    if has_ties(case):
        _stable_argsort(monkeypatch)
    for s in range(case["scores"].shape[0]):
        boxes8 = np.concatenate([case["mins"][s], case["maxs"][s], case["scores"][s, :, None],
                                 case["cls"][s, :, None].astype(np.float64)], axis=1)
        assert pnms.lhs_3d_faster_samecls(boxes8, 0.25) == jnms.lhs_3d_faster_samecls(boxes8, 0.25)
        boxes5 = boxes8[:, [0, 2, 3, 5, 6]].astype(np.float32)
        assert pnms.nms_2d(boxes5, 0.25) == jnms.nms_2d(boxes5, 0.25)
        lo, hi = case["mins"][s][:24].astype(np.float64), case["maxs"][s][:24].astype(np.float64)
        corners = np.stack([np.where(np.array(bits)[None], hi, lo) for bits in (
            (1, 1, 1), (1, 1, 0), (0, 1, 0), (0, 1, 1), (1, 0, 1), (1, 0, 0), (0, 0, 0),
            (0, 0, 1))], 1)
        conf = case["scores"][s][:24]
        assert pnms.nms_crnr_dist(corners, conf, 0.6) == jnms.nms_crnr_dist(corners, conf, 0.6)


def test_wrappers_refuse_bad_input():
    case = CASES["clustered_k37"]()
    args = [_t(case[k]) for k in ("mins", "maxs", "scores", "cls")]
    with pytest.raises(ValueError, match="unknown NMS mode"):
        nms_boxes(*args, None, "3d_xyz", False, 0.25)
    with pytest.raises(TypeError):
        nms_boxes(*args[:3], args[3].float(), None, "3d_cls", False, 0.25)
    with pytest.raises(ValueError, match="3d_cls needs cls"):
        nms_boxes(*args[:3], None, None, "3d_cls", False, 0.25)
    big = torch.zeros((1, MAX_BOXES + 1, 3))
    with pytest.raises(ValueError, match=f"at most {MAX_BOXES}"):
        nms_boxes(big, big, torch.zeros((1, MAX_BOXES + 1)), None, None, "3d", False, 0.25)
    with pytest.raises(ValueError, match=f"at most {MAX_BOXES}"):
        nms_masked(torch.zeros((1, MAX_BOXES + 1, MAX_BOXES + 1)), torch.zeros((1, MAX_BOXES + 1)), 0.25)
