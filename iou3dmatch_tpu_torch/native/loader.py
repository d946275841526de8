"""Native (C++) host-side loader kernels: vote labels and the floor percentile.

The port's copy of ``iou3dmatch_tpu/native/loader.py:30-185``. It backs
the two largest deterministic costs of a ScanNet scene load with
``loader_host.cc``, built by ``native/__init__.py::build_library`` with g++
into ``build/native/`` and bound with ctypes. Every random draw stays in
NumPy, so the ``np.random`` stream, and with it each ``__getitem__`` bit for
bit, is the JAX package's; these kernels are pure functions whose outputs
are bit-identical to the NumPy forms beside them (``compute_votes_plain``,
``np.percentile``), which the tests hold them to.

Unlike the JAX package's binding there is no NumPy fallback and no opt-out:
a failed build raises with the compiler's output, and so does a failed
percentile self-check. ``percentile_native`` returns None only where NumPy
defines the answer and an order statistic cannot give it (NaN, exact zeros
at the percentile, q out of range); the datasets then call ``np.percentile``.
"""
import ctypes
import threading

import numpy as np

from . import HERE, build_library

SRC = HERE / "loader_host.cc"
# -ffp-contract=off forbids FMA contraction, which would round otherwise
# than NumPy's one rounding an operation
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


def load() -> ctypes.CDLL:
    """The ctypes library, built at first use; raises if it cannot be built
    or if its percentile disagrees with NumPy's."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build_library(SRC, FLAGS)
            for name, xyz_p in (("scannet_votes_f32", _F32P), ("scannet_votes_f64", _F64P)):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [xyz_p, ctypes.c_int64, _I64P, _I64P, _I64P, ctypes.c_int64,
                               _F64P, _F64P]
            for name, p in (("order2_f32", _F32P), ("order2_f64", _F64P)):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, p]
            _percentile_self_check(lib)
            _lib = lib
    return _lib


def _percentile_self_check(lib) -> None:
    """Byte-compare the native percentile with ``np.percentile`` at the one
    quantile the datasets use (q = 0.99, the reference's floor height,
    scannet_detection_dataset.py:127, sunrgbd_detection_dataset.py:119).
    ``percentile_native`` mirrors NumPy's private quantile internals
    (float32 virtual index and gamma for float32 input, a two-branch lerp);
    a NumPy upgrade could change them, so a mismatch raises."""
    rng = np.random.RandomState(20260819)
    for dtype in (np.float32, np.float64):
        for n in (7, 100, 4096, 40000):
            z = (rng.randn(n) * 3 + 1).astype(dtype)
            z = np.where(z == 0, dtype(0.125), z)  # no exact zero: no deferral
            ours = np.asarray(_percentile(lib, z, 0.99))
            ref = np.asarray(np.percentile(z, 0.99))
            if ours.dtype != ref.dtype or ours.tobytes() != ref.tobytes():
                raise RuntimeError(
                    f"native percentile {ours!r} != np.percentile {ref!r} ({dtype.__name__}, "
                    f"n={n}): NumPy's quantile rule changed, update percentile_native")


def compute_votes_plain(point_cloud, instance_labels, semantic_labels, valid_ids):
    """The NumPy form of the vote labels (JAX ``data/scannet.py:100-140``, the
    reference loop scannet_detection_dataset.py:182-193 vectorised): a
    stable sort by instance id and grouped ``reduceat`` min/max. Returns
    (N, 3) float64 votes and the (N,) float64 mask."""
    n = point_cloud.shape[0]
    point_votes = np.zeros([n, 3])
    point_votes_mask = np.zeros(n)
    labels = instance_labels
    if labels.size and 0 <= labels.min() and labels.max() < 2**15:
        # int16 stable argsort dispatches to radix sort
        labels = labels.astype(np.int16)
    order = np.argsort(labels, kind="stable")
    sorted_labels = instance_labels[order]
    starts = np.flatnonzero(np.r_[True, sorted_labels[1:] != sorted_labels[:-1]])
    counts = np.diff(np.r_[starts, len(sorted_labels)])
    valid_group = np.isin(semantic_labels[order[starts]], valid_ids)
    xyz_sorted = point_cloud[order, :3]
    gmin = np.minimum.reduceat(xyz_sorted, starts, axis=0)
    gmax = np.maximum.reduceat(xyz_sorted, starts, axis=0)
    centers = 0.5 * (gmin + gmax)
    gid = np.repeat(np.arange(len(starts)), counts)
    keep = valid_group[gid]
    kept_rows = order[keep]
    point_votes[kept_rows] = centers[gid[keep]] - xyz_sorted[keep]
    point_votes_mask[kept_rows] = 1.0
    return point_votes, point_votes_mask


def compute_votes_native(point_cloud, instance_labels, semantic_labels, valid_ids):
    """(N, 3) float64 votes and the (N,) float64 mask of the reference loop
    (scannet_detection_dataset.py:182-193) in one O(N) pass; bit-identical
    to ``compute_votes_plain``: min and max do not depend on order,
    0.5 * (min + max) and center - xyz are the same single rounded
    operations in the cloud's own dtype, and a group's validity is its
    first point's semantic label. The cloud is float32 or float64."""
    lib = load()
    xyz = np.ascontiguousarray(point_cloud[:, :3])
    if xyz.dtype == np.float32:
        fn, ptr = lib.scannet_votes_f32, _F32P
    elif xyz.dtype == np.float64:
        fn, ptr = lib.scannet_votes_f64, _F64P
    else:
        raise TypeError(f"vote labels take a float32 or float64 cloud, not {xyz.dtype}")
    n = xyz.shape[0]
    ins = np.ascontiguousarray(instance_labels, dtype=np.int64)
    sem = np.ascontiguousarray(semantic_labels, dtype=np.int64)
    vid = np.ascontiguousarray(valid_ids, dtype=np.int64)
    if ins.shape != (n,) or sem.shape != (n,):
        raise ValueError(f"labels {ins.shape} and {sem.shape} for a cloud of {n} points")
    votes = np.zeros((n, 3), np.float64)
    mask = np.zeros(n, np.float64)
    fn(xyz.ctypes.data_as(ptr), n, ins.ctypes.data_as(_I64P), sem.ctypes.data_as(_I64P),
       vid.ctypes.data_as(_I64P), vid.shape[0], votes.ctypes.data_as(_F64P),
       mask.ctypes.data_as(_F64P))
    return votes, mask


def percentile_native(z, q):
    """``np.percentile(z, q)`` of a 1-D float32 or float64 array (the linear
    method) by native selection, or None where NumPy's answer cannot come
    from two order statistics: NaN in ``z``, q out of range, or an exact
    zero at the percentile (which of +0 and -0 lands there depends on the
    partition's tie order, and the sign reaches the height channel)."""
    return _percentile(load(), z, q)


def _percentile(lib, z, q):
    if z.ndim != 1 or z.shape[0] == 0:
        raise ValueError(f"percentile_native takes a non-empty 1-D array, not {z.shape}")
    n = z.shape[0]
    # NumPy 2.x: for float32 input the virtual index and the interpolation
    # run in float32 (q is cast to the array's dtype), for float64 in float64
    if z.dtype == np.float32:
        fn, ptr = lib.order2_f32, _F32P
        q_ = np.float32(np.true_divide(q, 100))
        vi = np.float32(n - 1) * q_
        one = np.float32(1)
    elif z.dtype == np.float64:
        fn, ptr = lib.order2_f64, _F64P
        q_ = np.true_divide(q, 100)
        vi = q_ * (n - 1)
        one = np.float64(1)
    else:
        raise TypeError(f"percentile_native takes float32 or float64, not {z.dtype}")
    if not (0 <= vi <= n - 1) or np.isnan(z).any():
        return None  # nth_element with NaN is undefined; NumPy propagates it
    lo = int(np.floor(vi))
    hi = min(lo + 1, n - 1)
    zc = np.ascontiguousarray(z)
    out2 = np.empty(2, z.dtype)
    fn(zc.ctypes.data_as(ptr), n, lo, hi, out2.ctypes.data_as(ptr))
    a, b = out2[0], out2[1]
    if a == 0 or b == 0:
        return None
    t = vi - np.floor(vi)
    diff = np.subtract(b, a)
    if t < 0.5:
        return a + diff * t
    return b - diff * (one - t)
