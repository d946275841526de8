"""The port's ``three_interpolate``, forward and backward, against the JAX
package's, on the CPU.

- The forward, which the wrapper runs on CPU tensors as
  ``three_interpolate_plain``, against JAX's ``three_interpolate`` at
  FP1- and FP2-like small shapes and on edge cases: indices repeated
  within a query and shared across queries, indices out of range that the
  clamp catches, zero weights, one known row (m = 1), a channel count that
  is not a multiple of 4. Tolerance rtol 1e-6 (both sum three f32
  products).
- The gradient of the features, through the port's autograd Function (its
  plain backward, an ``index_add_`` of g w), against ``jax.vjp`` through
  JAX's custom VJP (``_interp_bwd``, a one-hot segment sum): each of the
  two within rtol 1e-5 of a float64 sum, relative to the sum of the
  magnitudes added into the element (the gate the gather's backward is
  held to on the card). ``idx`` and ``weight`` get no gradient.
- ``kernel_model``, a NumPy model of ``csrc/three_interpolate.cu``'s
  rounding (each product f w rounded to f32, then ((0 + p0) + p1) + p2 in
  f32: the sum starts from its identity, so a sum of -0 products is +0, as
  PyTorch's), equals the plain forward bit for bit, the sign of zeros
  included (the zero-weight case has queries whose every product is -0);
  so the kernel, which the card holds to the plain version, rounds as this
  model does.
- The fused forward, ``three_interpolate(..., skip)`` ([interpolated |
  skip], FP's input), against JAX's ``three_interpolate`` then
  ``jnp.concatenate`` at rtol 1e-6, and its gradients against ``jax.vjp``
  of the same: the features' within the backward's gate, the skip's equal
  to the cotangent's skip columns.
- ``ordered_backward``, the backward's order in NumPy float32 (each row's
  slots in ascending slot order, from 0, each product rounded), and
  ``bwd_kernel_model``, a NumPy model of ``csrc/three_interpolate.cu``'s
  backward kernel (windows of slots, each warp's segment counted, the
  counts scanned, each slot placed by its rank among equal rows of its
  32-slot step, teams of lanes walking runs of rows cut by work) under the
  planned launch and under forced ones, windows as small as 32 slots
  included, equal ``three_interpolate_backward_plain`` bit for bit on every
  case (one thread), every element written once; so the kernel, which the
  card holds to the CPU plain version, sums as this model does.
- The backward of a strided cotangent (FP's interpolated columns of
  [interpolated | skip]) equals that of its contiguous copy.
- ``interp_bwd_plan`` gives every SM a block at FP1's and FP2's shapes of 8
  and 12 scenes, and ``check_interp_bwd_launch`` refuses what the kernel
  cannot take; the plan's constants are the source's.
- ``PointnetFPModule`` in train mode against the flax module: the output
  within atol 1e-4 (``tests/test_torch_models.py``'s) and the gradients
  of every parameter and of the known features within 1e-4 of the largest
  entry (``tests/test_torch_model_parts.py``'s).
- On CPU tensors the wrappers count no launch.
"""
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models import pointnet2 as pp  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.ops.interpolate import (  # noqa: E402
    IBWD_BLOCKS_PER_SM, IBWD_MAX_ROWS, IBWD_THREADS, InterpBwdLaunch, check_interp_bwd_launch,
    interp_bwd_plan,
    three_interpolate, three_interpolate_backward, three_interpolate_backward_plain,
    three_interpolate_plain)
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

jp = pytest.importorskip("iou3dmatch_tpu.models.pointnet2")
torch.set_num_threads(1)
FWD_RTOL = 1e-6
BWD_RTOL = 1e-5
MODULE_ATOL = 1e-4
GRAD_RTOL = 1e-4
MOMENTUM = 0.1


def _weights(rng, b, n):
    """Inverse-distance weights as FP makes them: 1 / (d + 1e-8), normalised."""
    recip = 1.0 / (rng.uniform(0.01, 2.0, (b, n, 3)) + 1e-8)
    return (recip / recip.sum(-1, keepdims=True)).astype(np.float32)


def _case(name):
    """(features (B, m, C), idx (B, n, 3) int32, weight (B, n, 3)) from a
    NumPy seed."""
    rng = np.random.RandomState(sorted(CASES).index(name))
    b, m, n, c = CASES[name]
    feats = rng.randn(b, m, c).astype(np.float32)
    idx = rng.randint(0, m, (b, n, 3)).astype(np.int32)
    w = _weights(rng, b, n)
    if name == "repeats":
        idx[:, ::3, 1] = idx[:, ::3, 0]  # a row twice in one query
        idx[:, ::5] = idx[:, :1]  # one triple shared by many queries
        idx[:, 1::7, :] = 2  # the same row three times
    elif name == "out_of_range":
        idx[:, ::2, 0] = -rng.randint(1, 5, idx[:, ::2, 0].shape)
        idx[:, 1::3, 2] = m + rng.randint(0, 5, idx[:, 1::3, 2].shape)
        idx[:, 5, :] = [-1, m, 1 << 30]
    elif name == "zero_weights":
        w[:, ::2, 1] = 0.0
        w[:, 1::4, :] = 0.0
        w[:, 3::4, 0] = 1.0
    return feats, idx, w


CASES = {  # (B, m, n, C)
    "fp1": (2, 32, 64, 24),  # FP1's ratio: n = 2m
    "fp2": (2, 64, 128, 24),
    "repeats": (2, 16, 60, 8),
    "out_of_range": (3, 20, 40, 12),
    "zero_weights": (2, 24, 48, 8),
    "one_row": (2, 1, 30, 16),
    "ragged_channels": (3, 17, 37, 5),
}


def _jax_forward(feats, idx, w):
    from iou3dmatch_tpu.ops.interpolate import three_interpolate as jax_interp

    return np.asarray(jax_interp(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w)))


def _f64_backward(g, idx, w, m):
    """The features' gradient summed in float64, and the sum of the
    magnitudes added into each element."""
    g, w = torch.from_numpy(g).double(), torch.from_numpy(w).double()
    idx = torch.from_numpy(idx)
    return (three_interpolate_backward_plain(g, idx, w, m).numpy(),
            three_interpolate_backward_plain(g.abs(), idx, w.abs(), m).numpy())


def kernel_model(feats, idx, w):
    """csrc/three_interpolate.cu's arithmetic in NumPy float32: each index
    clamped to [0, m - 1], each product f w rounded to f32, then
    ((0 + p0) + p1) + p2, each sum rounded to f32."""
    b, m, _ = feats.shape
    i = np.clip(idx.astype(np.int64), 0, m - 1)
    rows = feats[np.arange(b)[:, None, None], i]  # (B, n, 3, C)
    p = rows * w[..., None]
    return ((np.float32(0) + p[:, :, 0]) + p[:, :, 1]) + p[:, :, 2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    feats, idx, w = _case(name)
    got = three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (idx.shape[0], idx.shape[1],
                                                               feats.shape[2])
    np.testing.assert_allclose(got.numpy(), _jax_forward(feats, idx, w), rtol=FWD_RTOL, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_is_the_plain_forward_bit_for_bit(name):
    feats, idx, w = _case(name)
    want = three_interpolate_plain(torch.from_numpy(feats), torch.from_numpy(idx),
                                   torch.from_numpy(w)).numpy()
    got = kernel_model(feats, idx, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_matches_jax_vjp(name):
    from iou3dmatch_tpu.ops.interpolate import three_interpolate as jax_interp

    feats, idx, w = _case(name)
    m = feats.shape[1]
    g = np.random.RandomState(40).randn(idx.shape[0], idx.shape[1], feats.shape[2]).astype(
        np.float32)
    f = torch.from_numpy(feats).requires_grad_()
    weight = torch.from_numpy(w).requires_grad_()
    out = three_interpolate(f, torch.from_numpy(idx), weight)
    got_f, got_w = torch.autograd.grad(out, (f, weight), torch.from_numpy(g), allow_unused=True)
    assert got_w is None  # the weights get no gradient, as in JAX's VJP
    _, vjp = jax.vjp(lambda x: jax_interp(x, jnp.asarray(idx), jnp.asarray(w)),
                     jnp.asarray(feats))
    want, = vjp(jnp.asarray(g))
    ref, mag = _f64_backward(g, idx, w, m)
    for what, grad in (("port", got_f.numpy()), ("jax", np.asarray(want))):
        assert grad.dtype == np.float32
        bad = np.abs(grad.astype(np.float64) - ref) > BWD_RTOL * mag
        assert not bad.any(), (what, np.abs(grad - ref).max())
    # rows no slot names get exact zeros on both sides
    named = np.zeros((idx.shape[0], m), bool)
    np.put_along_axis(named, np.clip(idx, 0, m - 1).reshape(idx.shape[0], -1), True, axis=1)
    assert (got_f.numpy()[~named] == 0).all() and (np.asarray(want)[~named] == 0).all()


def test_jax_backward_is_the_plain_backward():
    """JAX's ``_interp_bwd`` (the one-hot segment sum) against the port's
    ``three_interpolate_backward_plain`` called directly, and the backward
    wrapper on CPU tensors returning the plain one's result."""
    from iou3dmatch_tpu.ops.interpolate import _interp_bwd

    feats, idx, w = _case("out_of_range")
    m = feats.shape[1]
    g = np.random.RandomState(41).randn(idx.shape[0], idx.shape[1], feats.shape[2]).astype(
        np.float32)
    want, none_i, none_w = _interp_bwd((jnp.asarray(idx), jnp.asarray(w), m), jnp.asarray(g))
    assert none_i is None and none_w is None
    args = (torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(w), m)
    got = three_interpolate_backward_plain(*args)
    assert torch.equal(three_interpolate_backward(*args), got)
    ref, mag = _f64_backward(g, idx, w, m)
    for grad in (got.numpy(), np.asarray(want)):
        assert not (np.abs(grad.astype(np.float64) - ref) > BWD_RTOL * mag).any()


def test_no_gradient_for_indices_or_weights():
    feats, idx, w = _case("fp1")
    weight = torch.from_numpy(w).requires_grad_()
    for f in (torch.from_numpy(feats), torch.from_numpy(feats).requires_grad_()):
        out = three_interpolate(f, torch.from_numpy(idx), weight)
        grad, = torch.autograd.grad(out.sum(), weight, allow_unused=True)
        assert grad is None


def test_cpu_wrappers_count_no_launch_and_refuse_bad_shapes():
    feats, idx, w = _case("fp2")
    before = (three_interpolate.launches, three_interpolate_backward.launches)
    f = torch.from_numpy(feats).requires_grad_()
    three_interpolate(f, torch.from_numpy(idx), torch.from_numpy(w)).sum().backward()
    assert (three_interpolate.launches, three_interpolate_backward.launches) == before
    # float64 on the CPU (the port's float64 steps): the plain version in float64
    got = three_interpolate(torch.from_numpy(feats).double(), torch.from_numpy(idx),
                            torch.from_numpy(w).double())
    assert got.dtype == torch.float64
    with pytest.raises(ValueError, match="idx and weight"):
        three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx[..., :2]),
                          torch.from_numpy(w[..., :2]))
    with pytest.raises(ValueError, match="known row"):
        three_interpolate(torch.zeros((2, 0, 4)), torch.from_numpy(idx[:2]),
                          torch.from_numpy(w[:2]))


SKIP_CHANNELS = 6  # the fused cases' skip width: not a multiple of 4 in "ragged_channels"'s


def _skip(name):
    """(B, n, Cs) skip features for case ``name``."""
    _, idx, _ = _case(name)
    rng = np.random.RandomState(100 + sorted(CASES).index(name))
    return rng.randn(idx.shape[0], idx.shape[1], SKIP_CHANNELS).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_forward_and_gradients_match_jax_concatenate(name):
    """[interpolated | skip] in one call against JAX's ``three_interpolate``
    then ``jnp.concatenate`` (JAX's FP, ``models/pointnet2.py:237-241``):
    the output at rtol 1e-6; the features' gradient within the backward's
    gate, the skip's equal to the cotangent's skip columns, as ``jax.vjp``
    gives them."""
    from iou3dmatch_tpu.ops.interpolate import three_interpolate as jax_interp

    feats, idx, w = _case(name)
    skip = _skip(name)
    m, c = feats.shape[1:]
    f = torch.from_numpy(feats).requires_grad_()
    sk = torch.from_numpy(skip).requires_grad_()
    out = three_interpolate(f, torch.from_numpy(idx), torch.from_numpy(w), sk)
    assert tuple(out.shape) == idx.shape[:2] + (c + SKIP_CHANNELS,)

    def jax_fp(x, y):
        return jnp.concatenate([jax_interp(x, jnp.asarray(idx), jnp.asarray(w)), y], axis=-1)

    want, vjp = jax.vjp(jax_fp, jnp.asarray(feats), jnp.asarray(skip))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=FWD_RTOL, atol=0)
    assert torch.equal(out[..., c:], sk)
    g = np.random.RandomState(43).randn(*out.shape).astype(np.float32)
    got_f, got_s = torch.autograd.grad(out, (f, sk), torch.from_numpy(g))
    want_f, want_s = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(got_s.numpy(), g[..., c:])
    np.testing.assert_array_equal(np.asarray(want_s), g[..., c:])
    ref, mag = _f64_backward(np.ascontiguousarray(g[..., :c]), idx, w, m)
    for what, grad in (("port", got_f.numpy()), ("jax", np.asarray(want_f))):
        assert not (np.abs(grad.astype(np.float64) - ref) > BWD_RTOL * mag).any(), what


def ordered_backward(g, idx, w, m):
    """The backward's order in NumPy float32: each row's sum starts at 0 and
    adds g[q] * w[s] (the product rounded to f32) for its slots s = 3 q + k
    in ascending s, each sum rounded to f32."""
    b, n, c = g.shape
    rows = np.clip(idx.astype(np.int64), 0, m - 1).reshape(b, 3 * n)
    out = np.zeros((b, m, c), np.float32)
    for scene in range(b):
        for s in range(3 * n):
            r = rows[scene, s]
            out[scene, r] = out[scene, r] + g[scene, s // 3] * w[scene].reshape(-1)[s]
    return out


def _lower_bound(start, nr, target):
    """The first r of [0, nr] with start[r] + r >= target."""
    return int(np.searchsorted(start[:nr + 1] + np.arange(nr + 1), target, side="left"))


def _team_starts(start, nr, teams):
    """Each team's first row as the kernel writes them, one pass over the
    rows: row r starts the teams t in (T(r - 1), T(r)] for T(r) =
    floor((start[r] + r) teams / work); equal to the first row whose
    weighted start reaches ceil(t work / teams)."""
    work = int(start[nr]) + nr
    out = np.full(teams + 1, -1, np.int64)
    for r in range(nr + 1):
        t_lo = 0 if r == 0 else (int(start[r - 1]) + r - 1) * teams // work + 1
        out[t_lo:(int(start[r]) + r) * teams // work + 1] = r
    want = [_lower_bound(start, nr, -(-t * work // teams)) for t in range(teams + 1)]
    assert out.tolist() == want
    return out


def bwd_kernel_model(g, idx, w, m, launch, window=3072, warps=IBWD_THREADS // 32):
    """csrc/three_interpolate.cu's backward kernel in NumPy, block by block
    (scene, range of rows, slice of pieces) and window by window: warp k
    keeps, in order, and counts the slots of its contiguous segment
    (ceil(wn / 32 warps) 32-slot steps) that fall in the block's rows; the
    scan of the counts gives where each row's slots start and each warp's
    cursor in it; a warp places its kept slots 32 at a time at cursor +
    rank among the step's earlier lanes of the same row
    (``__match_any_sync``), then moves the cursor; teams of lanes (a
    power of two, one piece each, 256 threads) walk runs of rows cut by
    work (``_team_starts``), adding each product to the row's sum in list
    order, from 0 in the first window and from what it wrote in a later
    one, and write each row once, zeros where no slot names it. Returns the
    output and the count of first-window writes of each element."""
    b, n, c = g.shape
    ranges, slices = launch
    vec = 4 if c % 4 == 0 else 1
    pieces, u = c // vec, 3 * n
    out = np.full((b, m, c), np.nan, np.float32)
    writes = np.zeros((b, m, c), np.int64)
    for scene in range(b):
        rows_all = np.clip(idx[scene].reshape(-1).astype(np.int64), 0, m - 1)
        w_all = w[scene].reshape(-1)
        for rg in range(ranges):
            lo, hi = rg * m // ranges, (rg + 1) * m // ranges
            nr = hi - lo
            for sl in range(slices):
                ch = slice(sl * pieces // slices * vec, (sl + 1) * pieces // slices * vec)
                lanes = 1
                while lanes < 32 and lanes < -(-pieces // slices):
                    lanes *= 2
                teams = IBWD_THREADS // lanes
                for s0 in range(0, u, window):
                    first = s0 == 0
                    wn = min(window, u - s0)
                    rows = rows_all[s0:s0 + wn]
                    seg = -(-wn // (32 * warps)) * 32
                    bounds = [(min(k * seg, wn), min(k * seg + seg, wn)) for k in range(warps)]
                    counts = np.zeros((warps, nr), np.int64)
                    for k, (a0, a1) in enumerate(bounds):
                        mine = rows[a0:a1][(rows[a0:a1] >= lo) & (rows[a0:a1] < hi)] - lo
                        np.add.at(counts[k], mine, 1)
                    start = np.concatenate([[0], np.cumsum(counts.sum(0))])
                    cursor = start[:-1] + np.cumsum(counts, 0) - counts
                    ordered = np.full(start[-1], -1, np.int64)
                    for k, (a0, a1) in enumerate(bounds):
                        kept = [(s, rows[s] - lo) for s in range(a0, a1) if lo <= rows[s] < hi]
                        for c0 in range(0, len(kept), 32):
                            step = kept[c0:c0 + 32]
                            seen = {}
                            for s, r in step:
                                ordered[cursor[k, r] + seen.get(r, 0)] = s
                                seen[r] = seen.get(r, 0) + 1
                            for r, cnt in seen.items():
                                cursor[k, r] += cnt
                    assert (ordered >= 0).all()
                    work = start[nr] + nr
                    team_start = _team_starts(start, nr, teams)
                    for t in range(teams):
                        ra, rb = team_start[t], team_start[t + 1]
                        if ra >= rb:
                            continue

                        def put(r, acc):
                            out[scene, lo + r, ch] = acc
                            writes[scene, lo + r, ch] += first

                        def open_row(r):
                            return (np.zeros(ch.stop - ch.start, np.float32) if first
                                    else out[scene, lo + r, ch].copy())

                        cur, acc = ra, open_row(ra)
                        for e in range(start[ra], start[rb]):
                            while e >= start[cur + 1]:
                                put(cur, acc)
                                cur += 1
                                acc = open_row(cur)
                            slot = s0 + ordered[e]
                            acc = acc + g[scene, slot // 3, ch] * w_all[slot]
                        put(cur, acc)
                        if first:
                            for r in range(cur + 1, rb):
                                put(r, np.zeros(ch.stop - ch.start, np.float32))
    return out, writes


def _bwd_inputs(name):
    feats, idx, w = _case(name)
    g = np.random.RandomState(44).randn(idx.shape[0], idx.shape[1], feats.shape[2]).astype(
        np.float32)
    return g, idx, w, feats.shape[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ordered_backward_is_the_plain_backward_bit_for_bit(name):
    g, idx, w, m = _bwd_inputs(name)
    want = three_interpolate_backward_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                            torch.from_numpy(w), m).numpy()
    got = ordered_backward(g, idx, w, m)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _model_launches(b, n, m, c):
    """The planned launch on 132 SMs and on 4, and forced ones: one range
    and one slice, a row a range, every piece its own slice."""
    pieces = c // 4 if c % 4 == 0 else c
    return sorted({tuple(interp_bwd_plan(b, n, m, c, 132)), tuple(interp_bwd_plan(b, n, m, c, 4)),
                   (1, 1), (m, 1), (min(m, 3), pieces)})


@pytest.mark.parametrize("window", [3072, 96, 32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_kernel_model_is_the_plain_backward_bit_for_bit(name, window):
    """Under every launch of ``_model_launches`` and windows of the source's
    3,072 slots, 96 and 32 (so the cases take several windows and warps with
    empty segments): bit for bit the plain backward, every element written
    once in the first window."""
    g, idx, w, m = _bwd_inputs(name)
    want = three_interpolate_backward_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                            torch.from_numpy(w), m).numpy()
    for launch in _model_launches(idx.shape[0], idx.shape[1], m, g.shape[2]):
        check_interp_bwd_launch(InterpBwdLaunch(*launch), m, g.shape[2])
        got, writes = bwd_kernel_model(g, idx, w, m, launch, window)
        assert (writes == 1).all(), launch
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=str(launch))


def test_backward_kernel_model_at_fp2_shape():
    """One scene of FP2 (1,024 queries into 512 rows of 256 channels, so 64
    pieces cut into 2 slices of 32) with the planned launch at 8 scenes:
    bit for bit the plain backward."""
    rng = np.random.RandomState(45)
    n, m, c = 1024, 512, 256
    idx = rng.randint(0, m, (1, n, 3)).astype(np.int32)
    idx[0, :m, 0] = np.arange(m)  # FP's queries start with the known points themselves
    w = _weights(rng, 1, n)
    g = rng.randn(1, n, c).astype(np.float32)
    launch = interp_bwd_plan(8, n, m, c, 132)
    assert launch == (16, 2)
    want = three_interpolate_backward_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                            torch.from_numpy(w), m).numpy()
    got, writes = bwd_kernel_model(g, idx, w, m, launch)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_of_a_strided_cotangent(name):
    """The features' columns of a (B, n, C + Cs) cotangent, read in place,
    give the backward of their contiguous copy."""
    g, idx, w, m = _bwd_inputs(name)
    wide = torch.from_numpy(np.concatenate([g, np.ones_like(g[..., :3])], -1))
    strided = wide[..., :g.shape[2]]
    assert not strided.is_contiguous()
    args = (torch.from_numpy(idx), torch.from_numpy(w), m)
    assert torch.equal(three_interpolate_backward(strided, *args),
                       three_interpolate_backward(strided.contiguous(), *args))


@pytest.mark.parametrize("b", [8, 12])
@pytest.mark.parametrize("n,m", [(512, 256), (1024, 512)])
def test_backward_plan_covers_the_card_at_fp_shapes(b, n, m):
    """FP1 and FP2 of the pretrain and SSL steps: 2 slices of 128 channels,
    and the most ranges whose blocks fit one wave of IBWD_BLOCKS_PER_SM
    blocks on each of 132 SMs: (16, 2) at 8 scenes, (11, 2) at 12, the
    best of chip_smoke.py --ibwd-sweep on an H100."""
    launch = interp_bwd_plan(b, n, m, 256, 132)
    check_interp_bwd_launch(launch, m, 256)
    assert launch == {8: (16, 2), 12: (11, 2)}[b]
    wave = IBWD_BLOCKS_PER_SM * 132
    assert wave - b * launch.slices < launch.blocks(b) <= wave


def test_backward_plan_edge_shapes_and_refusals():
    """Small and ragged widths take one slice; more rows than a block holds
    take more ranges; one row, one range. The check refuses empty launches,
    more ranges than rows, more rows a range than IBWD_MAX_ROWS and more
    slices than pieces."""
    assert interp_bwd_plan(2, 37, 17, 5, 132) == (17, 1)
    assert interp_bwd_plan(1, 10, 1, 8, 132) == (1, 1)
    assert interp_bwd_plan(200, 1024, 512, 256, 132) == (1, 2)
    assert interp_bwd_plan(1, 100, 40, 1024, 132) == (33, 8)
    big = interp_bwd_plan(1, 5000, 3 * IBWD_MAX_ROWS + 1, 64, 1)
    assert big.ranges == 4 and big.slices == 1
    for m, c in ((17, 5), (1, 8), (512, 256), (3 * IBWD_MAX_ROWS + 1, 64)):
        check_interp_bwd_launch(interp_bwd_plan(3, 100, m, c, 132), m, c)
    for launch, m, c in (((0, 1), 8, 8), ((9, 1), 8, 8), ((1, 0), 8, 8), ((1, 3), 8, 8),
                         ((1, 6), 8, 5), ((1, 1), IBWD_MAX_ROWS + 1, 8)):
        with pytest.raises(ValueError, match="no backward launch"):
            check_interp_bwd_launch(InterpBwdLaunch(*launch), m, c)


def test_backward_constants_match_the_source():
    """The plan's threads and rows a block are csrc/three_interpolate.cu's,
    and the file builds without multiply-add contraction."""
    from iou3dmatch_tpu_torch.ops import _build

    src = (Path(__file__).resolve().parents[1] / "iou3dmatch_tpu_torch" / "csrc"
           / "three_interpolate.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kBwdThreads"] == IBWD_THREADS and consts["kMaxRows"] == IBWD_MAX_ROWS
    assert consts["kWindow"] == 3072 and consts["kWindow"] % consts["kBwdThreads"] == 0
    assert "-fmad=false" in _build._flags("three_interpolate")


FP_MLP = (24 + 8, 32, 16)  # [interpolated | skip] channels, then two layers


@pytest.mark.parametrize("skip", [True, False])
def test_fp_module_forward_and_gradients_match_flax(skip):
    """Train mode: the output, the BN-normalised step's gradient of a random
    projection of the output with respect to every parameter and to the
    known features (the interpolated table), against the flax module."""
    rng = np.random.RandomState(42)
    b, n, m = 2, 64, 32
    unknown = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    known = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    kf = rng.randn(b, m, 24).astype(np.float32)
    uf = rng.randn(b, n, 8).astype(np.float32) if skip else None
    mlp = FP_MLP if skip else (24,) + FP_MLP[1:]
    jm = jp.PointnetFPModule(mlp=mlp)
    jargs = (jnp.asarray(unknown), jnp.asarray(known), None if uf is None else jnp.asarray(uf))
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(3), *jargs,
                                                       jnp.asarray(kf), train=False)))
    out_shape = (b, n, mlp[-1])
    proj = rng.randn(*out_shape).astype(np.float32)

    def loss(params, known_feats):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *jargs,
                          known_feats, train=True, momentum=MOMENTUM, mutable=["batch_stats"])
        return jnp.sum(out * proj), out

    (_, want_out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(kf))
    pm = pp.PointnetFPModule(mlp, torch.Generator().manual_seed(0))
    # the key rule names a lone module's shared MLP as an SA module's
    pm.load_state_dict({k.replace("mlp_module.", "mlp.", 1): v
                        for k, v in state_dict_from_jax(variables).items()}, strict=True)
    pm.train()
    set_bn_momentum(pm, MOMENTUM)
    tk = torch.from_numpy(kf).requires_grad_()
    out = pm(torch.from_numpy(unknown), torch.from_numpy(known),
             None if uf is None else torch.from_numpy(uf), tk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0,
                               atol=MODULE_ATOL)
    (out * torch.from_numpy(proj)).sum().backward()
    want = {k.replace("mlp_module.", "mlp.", 1): v for k, v in
            state_dict_from_jax({"params": jax.tree.map(np.asarray, grads[0])}).items()}
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k, v in list(want.items()) + [("known features", torch.from_numpy(np.asarray(grads[1])))]:
        g = tk.grad if k == "known features" else got[k]
        scale = float(np.abs(v.numpy()).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=k)
