"""Native (C++) host runtime: the oriented 3D IoU of the AP evaluator.

The port's copy of ``iou3dmatch_tpu/native/__init__.py:22-101``. It builds
``iou3d_host.cc`` with ``g++`` at first use into
``build/native/libiou3d_host-<hash>.so`` at the repository root (the hash
covers the source and the flags, so an edited source is rebuilt) and binds
it with ctypes. Unlike the JAX package's binding it does not fall back to
NumPy: a failed build raises with the compiler's output.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "iou3d_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libiou3d_host-{digest}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temporary name and an atomic rename: a concurrent first use (eval
    # pool workers) never sees half a library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> ctypes.CDLL:
    """The ctypes library, built at first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.box3d_iou_pair.restype = ctypes.c_float
            lib.box3d_iou_pair.argtypes = [fp, fp, fp]
            lib.box3d_iou_matrix.restype = None
            lib.box3d_iou_matrix.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int, fp]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def box3d_iou_native(corners1, corners2):
    """(8, 3) x (8, 3) camera-frame corners -> (iou3d, iou_bev), computed in
    float64 from the float32 corners and returned as Python floats of the
    float32 results."""
    c1 = np.ascontiguousarray(corners1, dtype=np.float32)
    c2 = np.ascontiguousarray(corners2, dtype=np.float32)
    bev = ctypes.c_float(0.0)
    iou = load().box3d_iou_pair(_ptr(c1), _ptr(c2), ctypes.byref(bev))
    return float(iou), float(bev.value)


def box3d_iou_matrix_native(corners_a, corners_b):
    """(na, 8, 3) x (nb, 8, 3) -> (na, nb) float32 3D IoU."""
    a = np.ascontiguousarray(corners_a, dtype=np.float32)
    b = np.ascontiguousarray(corners_b, dtype=np.float32)
    na, nb = a.shape[0], b.shape[0]
    out = np.empty((na, nb), dtype=np.float32)
    load().box3d_iou_matrix(_ptr(a), na, _ptr(b), nb, _ptr(out))
    return out
