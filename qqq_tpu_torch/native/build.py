"""Build and load the host INT4 packer (port of qqq_tpu/native/build.py).

``packing.c`` is compiled once by the host C compiler into a shared library
under ``build/qqq_tpu_torch_native/`` at the repository root (listed in
``.gitignore``), named by the hash of the source, and loaded with
``ctypes``.  Where no C compiler exists the NumPy twins below do the same
work; a compiler that exists but fails raises.  The port packs on the
card at run time (core/packing.py); this packer is a host helper for
checkpoint conversion, bit-equal to the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger("qqq_tpu_torch")

_SRC = pathlib.Path(__file__).resolve().parent / "packing.c"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "qqq_tpu_torch_native")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler() -> Optional[str]:
    cc = os.environ.get("CC")
    if cc:
        return cc
    return next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)


def load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the packing library; None where no C
    compiler exists.  Raises RuntimeError when the compiler fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    cc = _compiler()
    if cc is None:
        logger.info("no C compiler; the INT4 packer runs in NumPy")
        return None
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = BUILD_DIR / f"packing_{tag}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        cmd = [cc, "-O3", "-shared", "-fPIC", "-fopenmp", str(_SRC),
               "-o", str(tmp)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building the INT4 packer failed "
                               f"({' '.join(cmd)}):\n{done.stderr}")
        os.replace(tmp, so_path)  # atomic: concurrent builds agree
        logger.info("built the native packing library: %s", so_path)
    lib = ctypes.CDLL(str(so_path))
    for name in ("pack_int4", "unpack_int4"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                       ctypes.c_long]
    _lib = lib
    return _lib


def _pack_int4_numpy(q: np.ndarray) -> np.ndarray:
    K, N = q.shape
    u = (q.astype(np.int32) + 8).astype(np.uint32)
    ub = u.reshape(K // 128, 2, 16, 4, N)
    byte = ub[:, 0] | (ub[:, 1] << 4)
    w32 = (
        byte[:, :, 0] | (byte[:, :, 1] << 8)
        | (byte[:, :, 2] << 16) | (byte[:, :, 3] << 24)
    )
    return w32.reshape(K // 8, N).view(np.int32)


def _unpack_int4_numpy(packed: np.ndarray) -> np.ndarray:
    K8, N = packed.shape
    K = K8 * 8
    w = packed.view(np.uint32).reshape(K // 128, 16, N)
    bytes_ = np.stack([(w >> (8 * i)) & 0xFF for i in range(4)], axis=2)
    lo = (bytes_ & 0xF).reshape(K // 128, 64, N)
    hi = (bytes_ >> 4).reshape(K // 128, 64, N)
    u = np.concatenate([lo, hi], axis=1)
    return (u.astype(np.int32) - 8).reshape(K, N).astype(np.int8)


def pack_int4_host(q: np.ndarray) -> np.ndarray:
    """(K, N) signed int4 codes → (K//8, N) int32, the nibble-plane layout
    of core/packing.pack_int4; native where a C compiler exists, NumPy
    otherwise."""
    q = np.ascontiguousarray(q, dtype=np.int8)
    K, N = q.shape
    if K % 128:
        raise ValueError(f"K={K} must be a multiple of 128")
    if q.size and (q.min() < -8 or q.max() > 7):
        raise ValueError(
            "int4 codes out of range [-8, 7]: packed words would wrap"
        )
    lib = load_native()
    if lib is None:
        return _pack_int4_numpy(q)
    out = np.empty((K // 8, N), np.int32)
    lib.pack_int4(q.ctypes.data_as(ctypes.c_void_p),
                  out.ctypes.data_as(ctypes.c_void_p), K, N)
    return out


def unpack_int4_host(packed: np.ndarray) -> np.ndarray:
    """(K//8, N) int32 → (K, N) int8 codes in [-8, 7]."""
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    K8, N = packed.shape
    lib = load_native()
    if lib is None:
        return _unpack_int4_numpy(packed)
    out = np.empty((K8 * 8, N), np.int8)
    lib.unpack_int4(packed.ctypes.data_as(ctypes.c_void_p),
                    out.ctypes.data_as(ctypes.c_void_p), K8 * 8, N)
    return out
