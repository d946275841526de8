"""Three-nearest-neighbour search and inverse-distance interpolation.

Counterpart of ``iou3dmatch_tpu/ops/interpolate.py`` (reference
``interpolate_gpu.cu:14-160``).

- ``three_nn``: sqrt distances and int32 indices of the 3 nearest known
  points, the lowest index winning on ties. It launches ``csrc/three_nn.cu``
  on CUDA tensors and runs its plain PyTorch version, ``three_nn_plain``
  (three masked argmin passes, each returning the first minimum), on CPU
  tensors. No gradient. The kernel splits each query's seeds over S lanes
  of a warp and gives each thread Q queries; ``three_nn_plan`` picks
  (S, Q) from the shape and the card's SM count.
- ``three_interpolate``: a gather and a weighted sum over the 3 neighbours,
  optionally followed by FP's skip features ([interpolated | skip], the
  concatenation FP's MLP takes, in one pass), differentiable in the
  features (as JAX's custom VJP) and the skip features: on CUDA tensors its
  forward launches ``csrc/three_interpolate.cu`` (a block a tile of
  queries, their indices and weights staged once, bit for bit its plain
  version) and its backward, ``three_interpolate_backward``, the same
  file's backward kernel (one launch; each row's slots summed in ascending
  slot order, so bit for bit the CPU plain version; ``interp_bwd_plan``
  picks its blocks), reading the cotangent's interpolated columns in place;
  the skip's gradient is a view of the cotangent. On CPU tensors the plain
  versions ``three_interpolate_plain`` and
  ``three_interpolate_backward_plain``.
"""
from typing import NamedTuple, Optional

import torch

from . import _build


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) x (..., 3) -> (...) squared distance, written out term by
    term so each product is rounded on its own."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """unknown: (B, n, 3), known: (B, m, 3) ->
    (dist (B, n, 3) f32, idx (B, n, 3) int32)."""
    unknown, known = unknown.float(), known.float()
    d2 = _sq_dist(unknown[:, :, None, :], known[:, None, :, :])  # (B, n, m)
    idxs = []
    for _ in range(3):
        i = torch.argmin(d2, dim=2)
        idxs.append(i)
        d2 = d2.scatter(2, i[..., None], float("inf"))
    idx = torch.stack(idxs, dim=-1)  # (B, n, 3)
    rows = torch.arange(known.shape[0], device=known.device)[:, None, None]
    dist = torch.sqrt(_sq_dist(unknown[:, :, None, :], known[rows, idx]))
    return dist, idx.to(torch.int32)


# The instantiations of csrc/three_nn.cu (its NN_CASEs): S lanes a query, Q
# queries a thread.
NN_LANES = (1, 2, 4, 8, 16, 32)
NN_QUERIES = (1, 2, 4)
NN_LAUNCHES = tuple((s, q) for s in NN_LANES for q in NN_QUERIES)
NN_THREADS = 256  # a block's threads: csrc/three_nn.cu kThreads
# warps the plan gives every SM where the shape has them: two blocks, less a
# warp, so that 256 blocks on 132 SMs count (chip_smoke.py --nn-sweep, PERF.md)
NN_WARPS_PER_SM = 15


class NnLaunch(NamedTuple):
    """Blocks of NN_THREADS threads; each query's seeds split over ``lanes``
    lanes of a warp (lane l scans the 4-seed groups g with g % lanes == l),
    ``queries`` queries a thread."""
    lanes: int
    queries: int

    @property
    def rows(self) -> int:
        """Queries a block holds."""
        return NN_THREADS // self.lanes * self.queries

    def blocks(self, b: int, n: int) -> int:
        return b * -(-n // self.rows)

    def warps(self, b: int, n: int) -> int:
        return self.blocks(b, n) * NN_THREADS // 32


def three_nn_plan(b: int, n: int, m: int, n_sm: int) -> NnLaunch:
    """The launch for B scenes of n queries among m seeds: the smallest S,
    and for it the largest Q, whose blocks give every SM NN_WARPS_PER_SM
    warps, S at most one lane a 4-seed group (m // 4); where none does, the
    largest such S with Q = 1. A larger S splits each query's scan and adds
    a merge; a larger Q lets one shared load serve more distance tests;
    either way fewer warps are left to hide latency."""
    lanes = [s for s in NN_LANES if s <= max(1, m // 4)]
    for s in lanes:
        for q in reversed(NN_QUERIES):
            launch = NnLaunch(s, q)
            if launch.warps(b, n) >= NN_WARPS_PER_SM * n_sm:
                return launch
    return NnLaunch(lanes[-1], 1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor, launch: Optional[NnLaunch] = None):
    """unknown: (B, n, 3), known: (B, m, 3) with m >= 1 ->
    (dist (B, n, 3) f32, idx (B, n, 3) int32), equal to ``three_nn_plain``.

    Neither output carries a gradient, on either route, as the reference's
    ``ThreeNN``: GridConv keeps only ``idx`` and computes the distances again
    in autograd, and FP's xyz needs none. On CUDA tensors (contiguous f32,
    one device) it launches the kernel on the current stream with
    ``three_nn_plan``'s launch, or ``launch`` (for sweeps and tests), and
    counts the launch in ``three_nn.launches``."""
    if unknown.dim() != 3 or unknown.shape[2] != 3 or known.dim() != 3 or known.shape[2] != 3 \
            or known.shape[0] != unknown.shape[0]:
        raise ValueError(f"unknown (B, n, 3) and known (B, m, 3) expected, got "
                         f"{tuple(unknown.shape)} and {tuple(known.shape)}")
    if known.shape[1] < 1:
        raise ValueError("three_nn needs at least one known point a scene")
    if unknown.device.type == "cpu":
        return three_nn_plain(unknown.detach(), known.detach())
    _build.require(unknown, torch.float32, "unknown")
    _build.require(known, torch.float32, "known", unknown.device)
    b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    if dist.numel() == 0:
        return dist, idx
    if launch is None:
        n_sm = torch.cuda.get_device_properties(unknown.device).multi_processor_count
        launch = three_nn_plan(b, n, m, n_sm)
    if tuple(launch) not in NN_LAUNCHES:
        raise ValueError(f"csrc/three_nn.cu has no launch {launch}")
    fn = _build.kernel("three_nn", "three_nn_launch", (_build.VP,) * 4 + (_build.INT,) * 5
                       + (_build.VP,))
    _build.check(fn(unknown.data_ptr(), known.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, m,
                    *launch, _build.stream(unknown)), "three_nn")
    three_nn.launches += 1
    return dist, idx


three_nn.launches = 0


def three_interpolate_plain(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                            skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch ``three_interpolate``: features (B, m, C), idx (B, n, 3)
    clamped to [0, m - 1], weight (B, n, 3) -> (B, n, C), the (B, n, 3, C)
    gather times the weights summed over the neighbours; with ``skip`` (B,
    n, Cs), ``torch.cat`` of that and ``skip`` on the last axis."""
    b, m = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None, None]
    g = features[rows, idx.long().clamp(0, m - 1)]  # (B, n, 3, C)
    out = (g * weight[..., None]).sum(dim=2)
    return out if skip is None else torch.cat([out, skip], dim=-1)


def three_interpolate_backward_plain(g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                                     m: int) -> torch.Tensor:
    """Plain PyTorch backward of ``three_interpolate`` into the features:
    g (B, n, C), idx (B, n, 3), weight (B, n, 3) -> (B, m, C), each slot's
    g row times its weight added into the row its clamped index names
    (JAX ``_interp_bwd``). On the CPU ``index_add_`` adds the slots in
    ascending order into zeros, each product rounded first: the order
    ``csrc/three_interpolate.cu``'s backward keeps."""
    b, n, c = g.shape
    rows = idx.long().clamp(0, m - 1) + m * torch.arange(b, device=g.device)[:, None, None]
    out = torch.zeros((b * m, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows.reshape(-1), (g[:, :, None, :] * weight[..., None]).reshape(-1, c))
    return out.reshape(b, m, c)


def _check_interp(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                  skip: Optional[torch.Tensor]) -> None:
    if features.dim() != 3 or idx.dim() != 3 or idx.shape[2] != 3 or weight.shape != idx.shape \
            or idx.shape[0] != features.shape[0]:
        raise ValueError(f"features (B, m, C), idx and weight (B, n, 3) expected, got "
                         f"{tuple(features.shape)}, {tuple(idx.shape)} and {tuple(weight.shape)}")
    if skip is not None and (skip.dim() != 3 or skip.shape[:2] != idx.shape[:2]):
        raise ValueError(f"skip (B, n, Cs) expected for idx {tuple(idx.shape)}, got "
                         f"{tuple(skip.shape)}")
    if features.shape[1] < 1:
        raise ValueError("three_interpolate needs at least one known row a scene")
    if features.device.type == "cpu":
        return
    if features.dtype != torch.float32:
        raise TypeError(f"three_interpolate on the card takes f32 features, not {features.dtype} "
                        f"(FP's interpolation runs in f32 under bf16 too)")
    _build.require(features, torch.float32, "features")
    _build.require(idx, torch.int32, "idx", features.device)
    _build.require(weight, torch.float32, "weight", features.device)
    if skip is not None:
        _build.require(skip, torch.float32, "skip", features.device)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _interp_kernel(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                   skip: Optional[torch.Tensor]) -> torch.Tensor:
    b, m, c = features.shape
    n = idx.shape[1]
    if skip is not None and skip.shape[2] == 0:
        skip = None
    cs = 0 if skip is None else skip.shape[2]
    out = torch.empty((b, n, c + cs), dtype=torch.float32, device=features.device)
    if out.numel() == 0:
        return out
    tables = (features,) if skip is None else (features, skip)
    vec = 4 if c % 4 == 0 and cs % 4 == 0 and _aligned(*tables) else 1
    fn = _build.kernel("three_interpolate", "three_interpolate_launch",
                       (_build.VP,) * 5 + (_build.INT,) * 6 + (_build.VP,))
    _build.check(fn(features.data_ptr(), idx.data_ptr(), weight.data_ptr(),
                    None if skip is None else skip.data_ptr(), out.data_ptr(), b, n, m, c, cs,
                    vec, _build.stream(features)), "three_interpolate")
    three_interpolate.launches += 1
    return out


IBWD_THREADS = 256  # a backward block's threads: csrc/three_interpolate.cu kBwdThreads
IBWD_MAX_ROWS = 512  # rows a backward block may own: kMaxRows
# backward blocks an SM holds at once (98 registers a thread): more blocks
# than this on every SM start a second wave, which cost 1.4-1.5x at FP1 and
# FP2 (chip_smoke.py --ibwd-sweep, PERF.md)
IBWD_BLOCKS_PER_SM = 2
IBWD_SLICE_PIECES = 32  # a slice's pieces: a warp of lanes, a 16-byte piece each where C % 4 == 0


class InterpBwdLaunch(NamedTuple):
    """Blocks of IBWD_THREADS threads of ``three_interpolate_backward``'s
    kernel: each scene's rows cut into ``ranges`` ranges (at most
    IBWD_MAX_ROWS rows each), its channel pieces into ``slices``; a block a
    (scene, range, slice)."""
    ranges: int
    slices: int

    def blocks(self, b: int) -> int:
        return b * self.ranges * self.slices


def _pieces(c: int) -> int:
    return c // 4 if c % 4 == 0 else c


def interp_bwd_plan(b: int, n: int, m: int, c: int, n_sm: int) -> InterpBwdLaunch:
    """The backward's launch for B scenes of n queries (3 n slots) into m
    rows of C channels: slices of IBWD_SLICE_PIECES pieces (one where the
    row has fewer), then the most row ranges whose blocks fit one wave of
    IBWD_BLOCKS_PER_SM blocks on each of ``n_sm`` SMs, never more ranges
    than rows nor fewer than IBWD_MAX_ROWS rows a range allow. Every block
    stages and ranks all of its scene's slots, but sums only its rows'; n
    plays no part (a block walks the slots in windows)."""
    slices = max(1, _pieces(c) // IBWD_SLICE_PIECES)
    ranges = min(m, IBWD_BLOCKS_PER_SM * n_sm // (b * slices))
    return InterpBwdLaunch(max(ranges, -(-m // IBWD_MAX_ROWS), 1), slices)


def check_interp_bwd_launch(launch: InterpBwdLaunch, m: int, c: int) -> None:
    """Raises unless the kernel takes ``launch`` for m rows of C channels:
    1 <= ranges <= m with at most IBWD_MAX_ROWS rows a range, and 1 <=
    slices <= the row's pieces."""
    ranges, slices = launch
    if not (1 <= ranges <= m and -(-m // ranges) <= IBWD_MAX_ROWS and 1 <= slices <= _pieces(c)):
        raise ValueError(f"csrc/three_interpolate.cu has no backward launch {launch} for "
                         f"m = {m}, C = {c}")


def three_interpolate_backward(g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, m: int,
                               launch: Optional[InterpBwdLaunch] = None) -> torch.Tensor:
    """g (B, n, C) f32 cotangent of ``three_interpolate``'s interpolated
    columns, idx (B, n, 3) int32, weight (B, n, 3) f32 -> (B, m, C) f32
    gradient of the features. On a CUDA tensor it launches
    ``csrc/three_interpolate.cu``'s backward (``interp_bwd_plan``'s launch,
    or ``launch``): one kernel, each row's slots summed in ascending slot
    order from 0, each product rounded, and the row written once, so the
    result is the CPU plain version's bit for bit and the same from run to
    run. g may be strided (its last stride 1): FP's gradient reads the first
    C columns of the cotangent of [interpolated | skip] in place. Counted in
    ``three_interpolate_backward.launches``."""
    if g.device.type == "cpu":
        return three_interpolate_backward_plain(g, idx, weight, m)
    if g.device.type != "cuda":
        raise ValueError(f"g must be a CUDA tensor, got {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be torch.float32, got {g.dtype}")
    _build.require(idx, torch.int32, "idx", g.device)
    _build.require(weight, torch.float32, "weight", g.device)
    if g.dim() != 3 or idx.shape != g.shape[:2] + (3,) or weight.shape != idx.shape or m < 1:
        raise ValueError(f"g (B, n, C), idx and weight (B, n, 3) expected with m >= 1, got "
                         f"{tuple(g.shape)}, {tuple(idx.shape)}, {tuple(weight.shape)} and m = {m}")
    b, n, c = g.shape
    if g.numel() and c > 1 and g.stride(2) != 1:
        raise ValueError(f"g's channels must be contiguous, got strides {g.stride()}")
    out = torch.empty((b, m, c), dtype=torch.float32, device=g.device)
    if g.numel() == 0:
        return out.zero_()
    if launch is None:
        launch = interp_bwd_plan(b, n, m, c,
                                 torch.cuda.get_device_properties(g.device).multi_processor_count)
    check_interp_bwd_launch(launch, m, c)
    g_scene, g_row = g.stride(0), g.stride(1)
    vec = 4 if c % 4 == 0 and g_scene % 4 == 0 and g_row % 4 == 0 and _aligned(g) else 1
    fn = _build.kernel("three_interpolate", "three_interpolate_bwd_launch",
                       (_build.VP,) * 4 + (_build.INT,) * 4 + (_build.LONG,) * 2
                       + (_build.INT,) * 3 + (_build.VP,))
    _build.check(fn(g.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(), b, n, m, c,
                    g_scene, g_row, *launch, vec, _build.stream(g)), "three_interpolate backward")
    three_interpolate_backward.launches += 1
    return out


three_interpolate_backward.launches = 0


class _ThreeInterpolate(torch.autograd.Function):
    """The interpolation, with FP's skip features concatenated after it,
    differentiable in the features (the custom VJP of the JAX
    ``three_interpolate``, ``ops/interpolate.py:110-150``) and in the skip
    features. It keeps the indices, the weights, m and C, never the
    tables."""

    @staticmethod
    def forward(ctx, features, idx, weight, skip):
        ctx.m, ctx.c = features.shape[1], features.shape[2]
        ctx.save_for_backward(idx, weight)
        if features.device.type == "cpu":
            return three_interpolate_plain(features, idx, weight, skip)
        return _interp_kernel(features, idx, weight, skip)

    @staticmethod
    def backward(ctx, g):
        idx, weight = ctx.saved_tensors
        grad_f = grad_skip = None
        if ctx.needs_input_grad[0]:  # the interpolated columns, in place
            grad_f = three_interpolate_backward(g[..., :ctx.c], idx, weight, ctx.m)
        if ctx.needs_input_grad[3]:
            grad_skip = g[..., ctx.c:]  # a view: the skip's columns of g
        return grad_f, None, None, grad_skip


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                      skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """features: (B, m, C), idx: (B, n, 3), weight: (B, n, 3) -> (B, n, C),
    equal to ``three_interpolate_plain``; with ``skip`` (B, n, Cs), FP's
    input [interpolated | skip], (B, n, C + Cs), in one pass. Differentiable
    in ``features`` and ``skip`` (idx and weight get no gradient, as in
    JAX's VJP and the reference's ``ThreeInterpolate``). On CUDA tensors
    (f32 features, weights and skip, int32 indices, contiguous, one device)
    it launches ``csrc/three_interpolate.cu`` and counts the launch in
    ``three_interpolate.launches``; its backward is
    ``three_interpolate_backward`` for the features and a view of the
    cotangent for ``skip``. CPU tensors of any float dtype take the plain
    versions."""
    _check_interp(features, idx, weight, skip)
    return _ThreeInterpolate.apply(features, idx, weight, skip)


three_interpolate.launches = 0
