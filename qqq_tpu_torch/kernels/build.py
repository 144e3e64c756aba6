"""Build and load the CUDA kernels (counterpart of qqq_tpu/native/build.py).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Builds happen at first
use, all sources at once (one ``nvcc`` process per source, started
together), into ``build/qqq_tpu_torch/<hash>/`` under the repository root
(listed in ``.gitignore``).  The hash covers the sources, the headers and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  Only sources in this repository are compiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "qqq_tpu_torch"

#: the sources of the W4A8 serving paths: the GEMM routes (per channel,
#: g128 requant, g128 exact; each plain and GLU-fused; per channel and g128
#: exact with the activation quantization fused in), the KV writes (slot
#: and paged), the split-key decode (whole-cache and S-tiled over the slot
#: cache, and paged) and prefill flash attention (slot and paged)
KERNELS = ("w4a8_gemm", "w4a8_requant", "w4a8_group", "w4a8_fused",
           "kv_write", "split_decode_attention", "flash_attention")

#: what an entry returns, having launched nothing, when its block would need
#: more shared memory than the card gives one block (csrc/smem_fit.cuh)
SMEM_TOO_LARGE = -2

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=KERNELS) -> Dict[str, float]:
    """Compile every missing library in parallel.  Returns the seconds each
    build took (empty when everything was built already).  The ``nvcc``
    output, ``-Xptxas -v``'s register and spill report included, goes to
    ``<name>.log`` beside each library."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        tmp = out / f"lib{n}.so.tmp{os.getpid()}"
        log = open(out / f"{n}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, log, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    secs: Dict[str, float] = {}
    failed: List[str] = []
    for n, tmp, log, t0, p in procs:
        rc = p.wait()
        log.close()
        secs[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{n}: nvcc exit {rc}\n{(out / f'{n}.log').read_text()}")
        else:
            os.replace(tmp, out / f"lib{n}.so")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    p = _build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; builds all kernels first if
    this one is missing."""
    path = _build_dir() / f"lib{name}.so"
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def bind(name: str, fn: str, sig: str, ret: str = "i"):
    """The C entry ``fn`` of library ``name`` with its argtypes set from
    ``sig``: ``p`` a pointer (the stream included), ``i`` an int.  A launch
    entry returns ``cudaGetLastError()`` (``ret`` "i"); a sizing entry
    returns bytes as a long long (``ret`` "q")."""
    f = getattr(load(name), fn)
    f.argtypes = [_VOID if c == "p" else _INT for c in sig]
    f.restype = ctypes.c_longlong if ret == "q" else _INT
    return f


def check(err: int, what: str) -> None:
    """Raises unless the entry launched: ValueError for a block too large
    for the card's shared memory (``what`` names the shape), else
    RuntimeError with the CUDA error."""
    if err == SMEM_TOO_LARGE:
        raise ValueError(f"{what}: the block needs more shared memory than "
                         "the card gives one block")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, dtype, shape: Optional[tuple], name: str, device) -> None:
    """Wrapper-side argument check: the kernels take contiguous tensors of
    one dtype and shape on the launching card (``device``, the first
    operand's) and read them through raw pointers."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
