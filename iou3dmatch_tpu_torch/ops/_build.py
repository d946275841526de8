"""Builds the port's CUDA kernels and binds them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the repository root, with
the compiler output beside it in ``<name>-<hash>.log``; the hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is built or imported when this
module is imported: the first launch builds what it needs, and ``build()``
builds several sources at once, one ``nvcc`` process each, all started
together.

A C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code, so a refused launch never passes silently.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fps", "ball_query", "gather", "gather_bwd", "iou3d", "lhs", "three_nn", "nms",
           "three_interpolate")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# iou3d, lhs, three_nn, nms and three_interpolate follow their plain
# versions operation by operation, each product and sum rounded on its own:
# no multiply-add contraction anywhere in these files
SOURCE_FLAGS = {name: ("-fmad=false",)
                for name in ("iou3d", "lhs", "three_nn", "nms", "three_interpolate")}


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())

_lock = threading.Lock()
_libs = {}
_fns = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output of the library ``library_path(name)`` was built
    with (``-Xptxas -v`` puts each kernel's registers and spills there),
    kept beside it; raises if that library has not been built."""
    return library_path(name).with_suffix(".log").read_text()


def build(names=SOURCES) -> dict:
    """Compiles each source in ``names`` whose library is missing, all in
    parallel, and keeps each compiler output beside its library. Returns
    ``{name: compiler output}`` for the ones it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            log = so.with_suffix(".log")
            log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
            log_tmp.write_text(logs[name])
            os.replace(log_tmp, log)  # the log first: a library never lacks its log
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    return logs


def build_variant(name: str, define: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with ``-D<define>`` beside the kernels' own
    libraries, and loaded: a build for measuring, which no wrapper uses.
    Raises with the compiler output if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}-{define.lower()}.so"
    proc = subprocess.run([_nvcc(), *_flags(name), f"-D{define}", "-o", str(so),
                           str(CSRC / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name} with -D{define}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def kernel(source: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<source>.cu``, built and loaded at
    first use, with its argument types declared."""
    key = (source, symbol)
    with _lock:
        if key not in _fns:
            if source not in _libs:
                build((source,))
                _libs[source] = ctypes.CDLL(str(library_path(source)))
            fn = getattr(_libs[source], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return _fns[key]


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def require(t: torch.Tensor, dtype: torch.dtype, name: str, device=None) -> None:
    """Raises unless ``t`` is a contiguous CUDA tensor of ``dtype`` (on
    ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


VP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float
DOUBLE = ctypes.c_double
