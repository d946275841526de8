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
- ``kernel_model``, a NumPy model of ``csrc/nms.cu`` (each block of a
  cluster ordering its share of the boxes by the 64-bit key, the row strips
  of the bit matrix with the class skip and zero intersections tested
  without dividing, the leader's scan a 64-position word at a time with the
  all -inf rule of matrix mode), equals the plain version bit for bit at
  every cluster size ``nms_plan`` can pick; ``nms_plan`` keeps its rules.
  Past MAX_BOXES it models the global-matrix path: the order of all K
  keys, the 64 x 64 tiles on and above the diagonal below nv (rows past nv
  zero), the scan a word at a time with each later word ORing its
  winners' rows, on ``nms_cases.LARGE`` (K = 1,025 to 4,096).
- Every K runs on the CPU: K from 257 to 4,096 gives the JAX package's
  picks (``LARGE`` in each box mode against its NumPy NMS, and matrix mode
  against ``_nms_jax``).
- The port's NumPy ``lhs_3d_faster_samecls``, ``nms_2d`` and
  ``nms_crnr_dist`` equal the JAX package's.
"""
import numpy as np
import pytest
import torch
from nms_cases import CASES, LARGE, has_ties
from nms_cases import clustered as nms_clustered

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from iou3dmatch_tpu_torch.geometry import nms as pnms  # noqa: E402
from iou3dmatch_tpu_torch.ops.nms import (GLOBAL_MAX_BOXES, MAX_BOXES, MIN_ROWS,  # noqa: E402
                                          MODE_IDS, NMS_CLUSTERS, SMEM_MAX, nms_boxes,
                                          nms_masked, nms_plan)

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


NEG_INF_HIGH = 0x007FFFFF  # order_key's high word of -inf


def _overlap_rows(lo, hi, area, label, gated, dtype, old_type, thresh, chunk=512):
    """(n, n) bool by position: whether row r suppresses column c, each
    overlap in the kernel's order of operations and ``dtype``, times the
    class gate where ``gated``; a zero intersection is tested without
    dividing. ``chunk`` rows at a time, to bound the temporaries."""
    out = np.zeros((lo.shape[0], lo.shape[0]), bool)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for r0 in range(0, lo.shape[0], chunk):
            r = slice(r0, r0 + chunk)
            side = np.maximum(dtype(0), np.minimum(hi[r, None], hi[None])
                              - np.maximum(lo[r, None], lo[None]))
            inter = side[..., 0] * side[..., 1]
            if side.shape[-1] == 3:
                inter = inter * side[..., 2]
            den = (np.broadcast_to(area[None], inter.shape) if old_type
                   else (area[r, None] + area[None]) - inter)
            o = inter / den
            if gated:
                o = o * (label[r, None] == label[None]).astype(dtype)
            out[r] = np.where(inter == 0, (den != 0) & (den == den) & (dtype(0) > dtype(thresh)),
                              o > dtype(thresh))
    return out


def _words(bits: np.ndarray, words: int) -> list:
    """(n, <= 64 words) bool rows -> each row's 64-bit words as Python ints."""
    pad = np.zeros((bits.shape[0], 64 * words), bool)
    pad[:, :bits.shape[1]] = bits
    packed = np.packbits(pad, axis=1, bitorder="little").view("<u8")
    return [[int(x) for x in row] for row in packed]


LOCAL_ORDER = 128  # csrc/nms.cu kLocalOrder


def kernel_model(case, mode, old_type):
    """csrc/nms.cu step by step in NumPy, at every cluster size C of
    NMS_CLUSTERS:

    - every block's keys (boxes outside ``valid`` last); up to LOCAL_ORDER
      boxes every block orders all of them, past it block r orders its share
      [r s, (r + 1) s), s = ceil(K / C), and the others read them;
    - the bit matrix, a warp a row: in class-aware mode at thresh >= 0 the
      row queues only the later positions of its own class (every other
      pair gets a 0 bit without an overlap); else every later position; the
      row's words from q // 64 on go to the leader's matrix, whose other
      words hold random bits here, which must change nothing;
    - the leader's rounds a 64-position word at a time: lane w decides word
      w's winners serially from its diagonal words, then the winners' rows go
      into every later word, the lanes of each word ORing the rows of a
      share of the winners; then matrix mode's all -inf rule: the scan is
      cut at the first winner scoring -inf other than the first valid box,
      which wins.

    Past MAX_BOXES, the global-matrix path: the order over all K keys (no
    cluster shares); the tiles (row word, column word) on and above the
    diagonal and below nv write every row of their words, rows past nv as
    zeros (the other words hold random bits, which must change nothing);
    the scan decides each word's winners from its diagonal words, then a
    warp for each later word ORs the winners' rows into it.

    Returns (keep (B, K) bool, overlaps computed, overlaps skipped)."""
    scores, thresh = case["scores"], case["thresh"]
    b, k = scores.shape
    valid = np.ones((b, k), bool) if case["valid"] is None else case["valid"]
    keep = np.zeros((b, k), bool)
    matrix = mode == "matrix"
    iou = _iou_3d(case).numpy() if matrix else None
    skip = mode == "3d_cls" and not thresh < 0
    glob = k > MAX_BOXES
    words = -(-k // 64)
    computed = skipped = 0
    for s in range(b):
        idx = np.arange(k)
        key = np.where(valid[s], order_key(scores[s], (k - 1 - idx) if matrix else idx), np.uint64(0))
        label = case["cls"][s]
        n = int((key != 0).sum())
        pos_of = np.where(key != 0, (key[None, :] > key[:, None]).sum(1), -1)
        for cluster in () if glob else NMS_CLUSTERS:  # each block's share covers every box once
            share = k if k <= LOCAL_ORDER else -(-k // cluster)
            owners = [list(range(r * share, min(k, (r + 1) * share)))
                      for r in range(cluster if share < k else 1)]
            assert sorted(sum(owners, [])) == list(range(k))
        box_at = np.zeros(k, np.int64)
        box_at[pos_of[pos_of >= 0]] = idx[pos_of >= 0]
        box = box_at[:n]
        if matrix:
            over = iou[s][np.ix_(box, box)] > np.float32(thresh)
        else:
            axes = [0, 2] if mode == "2d" else [0, 1, 2]
            dtype = np.float64 if mode == "3d_cls" else np.float32
            lo = case["mins"][s][box][:, axes].astype(dtype)
            hi = case["maxs"][s][box][:, axes].astype(dtype)
            d = hi - lo
            area = d[:, 0] * d[:, 1]
            if len(axes) == 3:
                area = area * d[:, 2]
            over = _overlap_rows(lo, hi, area, label[box], mode == "3d_cls", dtype, old_type, thresh)
        later = np.triu(np.ones((n, n), bool), 1)
        cand = later & (label[box][:, None] == label[box][None]) if skip else later
        rows = np.where(cand, over, False)
        computed += int(cand.sum())
        skipped += int((later & ~cand).sum())
        # the words of the leader's matrix the kernel writes: row q's from
        # q // 64 on (the global path's tiles: every row of their words,
        # rows past n zero). Every other word keeps whatever the memory
        # held: here, random bits, which must change nothing
        words_n = -(-n // 64)
        halves = np.random.RandomState(s).randint(0, 2 ** 32, (64 * words, 2 * words), dtype=np.uint64)
        if n:
            exact = np.packbits(np.pad(rows, ((0, 64 * words - n), (0, 64 * words - n))), axis=1,
                                bitorder="little").view("<u4").astype(np.uint64)
            for q in range(64 * words_n if glob else n):
                halves[q, 2 * (q // 64):2 * words_n] = exact[q, 2 * (q // 64):2 * words_n]
        mat = [[int(halves[q, 2 * v]) | int(halves[q, 2 * v + 1]) << 32 for v in range(words)]
               for q in range(64 * words)]
        wn = -(-n // 64)
        first = np.flatnonzero(valid[s])
        pf = int(pos_of[first[0]]) if first.size else 0
        wide = 2 if wn <= 2 else 4 if wn <= 4 else 8 if wn <= 8 else 16  # the kernel's S
        removed, won = [0] * max(16, wn), [0] * wn
        for w in range(wn):
            mine, rem = 0, removed[w]
            for bit_at in range(min(64, n - 64 * w)):  # lane w, the diagonal block
                q, bit = 64 * w + bit_at, 1 << bit_at
                if not rem & bit:
                    rem |= mat[q][w]
                    mine |= bit
            removed[w] = rem
            if glob:  # a warp a later word: the OR of the winners' rows
                for v in range(w + 1, wn):
                    for b in range(64):
                        if mine >> b & 1:
                            removed[v] |= mat[64 * w + b][v]
                won[w] = mine
                continue
            share = 64 * wide // 32  # lanes l with l % wide == v split the winners
            for v in range(w + 1, wn):
                parts = [0] * (32 // wide)
                for part in range(32 // wide):
                    for b in range(share):
                        if mine >> (part * share + b) & 1:
                            parts[part] |= mat[64 * w + part * share + b][v]
                for part in parts:
                    removed[v] |= part
            won[w] = mine
        if matrix:  # the all -inf rule, after the scan: cut at the first -inf winner but pf
            neg = [int(key[box_at[q]]) >> 32 == NEG_INF_HIGH for q in range(n)]
            hits = [q for q in range(n) if won[q // 64] >> (q % 64) & 1 and neg[q] and q != pf]
            if hits:
                for q in range(hits[0], n):
                    won[q // 64] &= ~(1 << (q % 64))
                won[pf // 64] |= 1 << (pf % 64)
        for i in idx[pos_of >= 0]:
            p = int(pos_of[i])
            keep[s, i] = bool(won[p // 64] >> (p % 64) & 1)
    return keep, computed, skipped


@pytest.mark.parametrize("mode,old_type", [(m, o) for m in MODES for o in (False, True)]
                         + [("matrix", False)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_plain(name, mode, old_type):
    """The model, at every cluster size nms_plan can pick, equals the plain
    version; the class skip computes only same-class pairs."""
    case = CASES[name]()
    if mode == "matrix":
        want = pnms.nms_masked_plain(_iou_3d(case), _t(case["scores"]), case["thresh"],
                                     _t(case["valid"])).numpy()
    else:
        want = _plain_boxes(case, mode, old_type)
    got, computed, skipped = kernel_model(case, mode, old_type)
    np.testing.assert_array_equal(got, want)
    if mode != "3d_cls" or case["thresh"] < 0:
        assert skipped == 0
    if mode == "3d_cls" and case["thresh"] >= 0 and len(np.unique(case["cls"])) > 1:
        assert skipped > 0


@pytest.mark.parametrize("mode", MODES + ("matrix",))
@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_k_plain_matches_jax(name, mode, monkeypatch):
    """Past the cluster path (K = 1,025 to 4,096): the plain versions pick
    what the JAX package's NumPy NMS (each box mode, as parse_predictions
    applies it) and ``_nms_jax`` (matrix mode) pick, and the wrappers take
    the plain versions on the CPU."""
    case = LARGE[name]()
    if mode == "matrix":
        iou = _iou_3d(case)
        got = pnms.nms_masked_plain(iou, _t(case["scores"]), case["thresh"], _t(case["valid"]))
        want = _jax_masked(iou.numpy(), case["scores"], case["valid"], case["thresh"])
        wrapped = nms_masked(iou, _t(case["scores"]), case["thresh"], _t(case["valid"]))
    else:
        got = _plain_boxes(case, mode, False)
        with monkeypatch.context() as m:
            if has_ties(case):
                _stable_argsort(m)
            want = _jax_numpy_keep(case, mode, False)
        wrapped = nms_boxes(_t(case["mins"]), _t(case["maxs"]), _t(case["scores"]),
                            _t(case["cls"]), _t(case["valid"]), mode, False, case["thresh"])
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(wrapped.numpy(), want)


@pytest.mark.parametrize("mode,old_type", [("2d", False), ("3d", True), ("3d_cls", False),
                                           ("3d_cls", True), ("matrix", False)])
@pytest.mark.parametrize("name", sorted(LARGE))
def test_kernel_model_global_path_matches_plain(name, mode, old_type):
    """The model of the global-matrix path equals the plain version bit for
    bit past MAX_BOXES; the class skip computes only same-class pairs."""
    case = LARGE[name]()
    assert case["scores"].shape[1] > MAX_BOXES
    if mode == "matrix":
        want = pnms.nms_masked_plain(_iou_3d(case), _t(case["scores"]), case["thresh"],
                                     _t(case["valid"])).numpy()
    else:
        want = _plain_boxes(case, mode, old_type)
    got, computed, skipped = kernel_model(case, mode, old_type)
    np.testing.assert_array_equal(got, want)
    assert computed > 0
    if mode == "3d_cls" and case["thresh"] >= 0 and len(np.unique(case["cls"])) > 1:
        assert skipped > 0
    else:
        assert skipped == 0


def test_nms_plan():
    """Clusters fill the SMs at serving's 8 scenes, a block holds at least
    MIN_ROWS rows, clusters the card cannot hold at once are not taken, and
    many scenes run as clusters of one."""
    assert nms_plan(8, 128, 132) == 8
    assert nms_plan(8, 256, 132) == 16
    assert nms_plan(8, 1024, 132) == 16
    assert nms_plan(8, 1024, 132, {2: 66, 4: 33, 8: 16, 16: 7}) == 8
    assert nms_plan(1, 1, 132) == 1
    assert nms_plan(1, 31, 132) == 1
    assert nms_plan(1, 32, 132) == 2
    assert nms_plan(300, 128, 132) == 1
    assert nms_plan(40, 128, 132) == 2
    assert nms_plan(40, 128, 132, {2: 30}) == 1
    for b in (1, 8, 16, 33, 66, 132, 300):
        for k in (1, 16, 100, 128, 257, 1024):
            c = nms_plan(b, k, 132)
            assert c in NMS_CLUSTERS and (c == 1 or (b * c <= 132 and c * MIN_ROWS <= k))


def test_kernel_source_matches_wrapper():
    """The wrapper's limits are the source's."""
    from pathlib import Path

    src = (Path(pnms.__file__).parents[1] / "csrc" / "nms.cu").read_text()
    assert f"constexpr int kMaxBoxes = {MAX_BOXES};" in src
    assert f"constexpr int kMaxCluster = {max(NMS_CLUSTERS)};" in src
    # the global path: its entries, and the shared memory that bounds its K
    assert f"constexpr int kSmemMax = {SMEM_MAX};" in src
    assert "return 8 + 64 * 8 + 3LL * words * 8;" in src  # rounds_smem, as GLOBAL_MAX_BOXES counts
    assert GLOBAL_MAX_BOXES % 64 == 0 and (GLOBAL_MAX_BOXES // 64) ** 2 < 2 ** 31
    for entry in ("nms_boxes_global_launch", "nms_matrix_global_launch"):
        assert f'extern "C" int {entry}(' in src
    for mode, i in MODE_IDS.items():
        name = {"2d": "k2D", "3d": "k3D", "3d_cls": "k3DCls", "matrix": "kMatrix"}[mode]
        assert f"{name} = {i}" in src


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
    # the CPU takes any K, as the JAX package does: past the card's old 256
    # and at MAX_BOXES + 1, the plain versions pick what the JAX package
    # picks (to 4,096: test_large_k_plain_matches_jax)
    for name in ("clustered_k257", "k1025"):
        case = CASES["clustered_k257"]() if name == "clustered_k257" else nms_clustered(22, 1, MAX_BOXES + 1, 18)
        got = nms_boxes(*(_t(case[k]) for k in ("mins", "maxs", "scores", "cls")), None, "3d_cls",
                        False, case["thresh"])
        np.testing.assert_array_equal(got.numpy(), _jax_numpy_keep(case, "3d_cls", False))
        iou = _iou_3d(case)
        np.testing.assert_array_equal(nms_masked(iou, _t(case["scores"]), case["thresh"]).numpy(),
                                      _jax_masked(iou.numpy(), case["scores"], None, case["thresh"]))
