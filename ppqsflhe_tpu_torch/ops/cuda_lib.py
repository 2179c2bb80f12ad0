"""Build and load the port's CUDA kernels (``ppqsflhe_tpu_torch/csrc``).

The kernel sources compile with nvcc into ONE shared library with a plain
C interface, loaded with ctypes: one nvcc per source (per part of a source
in :data:`PARTS`), all started together, then one link. Nothing is built
when this module is imported: :func:`library` builds on first use, into
``build/ppqsflhe_tpu_torch/`` under the repository root, named by a hash of
the sources and flags so a stale library is never loaded. Every C entry
point returns ``cudaGetLastError()`` after its launch; :func:`check` turns
a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppqsflhe_tpu_torch"
SOURCES = ("mxu_ntt.cu", "streamed_ntt.cu", "fourstep_ntt.cu", "base_ext.cu", "ks_ip.cu",
           "moddown.cu", "decompose.cu", "overlap_probe.cu")
HEADERS = ("common.cuh", "butterfly.cuh")
# sources built in parts, each an nvcc of its own with -DPPQ_PART=p (p < parts):
# a part holds one C entry point and the kernel instances it launches, so the
# two widest sources (~50 and ~28 s whole on an H100 host) compile in parallel
PARTS = {"mxu_ntt.cu": 2, "streamed_ntt.cu": 2}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: pointers and the stream as void*, sizes as int, strides as
# long long; kernel 2 takes its constants as one ExtParams struct
# (ops/cuda_ext.py), by value
_SIGNATURES = {
    "ppq_mxu_ntt_stage": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ppq_mxu_ntt_stage_mont": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ppq_fourstep_pass": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ppq_streamed_stage_a": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "ppq_streamed_stage_b": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ppq_base_extend": [_P, _P, "ExtParams", _I, _I, _I, _I, _P],
    "ppq_ks_inner_product": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ppq_moddown_tail": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P],
    "ppq_decompose_digit": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P],
    "ppq_overlap_probe": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None       # wall time of the build this process ran (None: cached)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libppqsflhe_cuda_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    units = [(s, [f"-DPPQ_PART={p}"] if s in PARTS else [], f"{Path(s).stem}{p}")
             for s in SOURCES for p in range(PARTS.get(s, 1))]
    objs = [tmp.with_suffix(f".{stem}.o") for _, _, stem in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, *part, "-c", str(CSRC / s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for (s, part, _), o in zip(units, objs)]
    errors = []
    for (s, part, _), p in zip(units, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {s} {' '.join(part)} failed ({p.returncode}):\n{err[-4000:]}")
    if not errors:
        r = subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            errors.append(f"nvcc link failed ({r.returncode}):\n{r.stderr[-4000:]}")
    for o in objs:
        o.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .cuda_ext import ExtParams

        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ExtParams if a == "ExtParams" else a for a in args]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, shape=None) -> None:
    """Raise unless ``t`` is a contiguous int64 CUDA tensor (of ``shape``)."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise ValueError(f"{name}: expected int64, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
