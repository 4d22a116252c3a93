"""ctypes bridge to the port's native packing library
(kernels/csrc/packlib.cpp; port of smoothquant_tpu/utils/native.py).

The library is built with g++ -O3 at first use into the git-ignored
kernels/_build/, keyed by a hash of its source and flags; its loops run on
std::thread (the JAX library's OpenMP needs libgomp, which a g++ install
may lack), as many as torch's intra-op threads.  There is no
fallback: where the library cannot be built, lib() raises, and so does
every entry point (the JAX package drops quietly to numpy).  The numpy
functions beside them (*_plain) are the plain versions the tests hold the
library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "..", "kernels", "csrc", "packlib.cpp")
BUILD_DIR = os.path.join(_HERE, "..", "kernels", "_build")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-pthread", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_I64, _INT = ctypes.c_int64, ctypes.c_int
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_SIGNATURES = {
    "permute_cols_f32": [_F32P, _I32P, _I64, _I64, _F32P],
    "group_quant": [_F32P, _I64, _I64, _I64, _INT, _I8P, _F32P],
    "group_quant_rcp": [_F32P, _I64, _I64, _I64, _INT, _I8P, _F32P],
    "pack_nibbles_split": [_I8P, _I64, _I64, _I8P],
    "transpose_i8": [_I8P, _I64, _I64, _I8P],
    "transpose_f32": [_F32P, _I64, _I64, _F32P],
    "set_threads": [_INT],
}


def build() -> str:
    """Compile the library (once per source and flags); returns its path.
    Raises with the compiler's output when it cannot be built."""
    src = os.path.abspath(SRC)
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.abspath(os.path.join(BUILD_DIR, f"packlib-{digest}.so"))
    if os.path.exists(so_path):
        return so_path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("host_pack needs g++ to build kernels/csrc/packlib.cpp; "
                           "none was found")
    tmp = f"{so_path}.tmp{os.getpid()}"
    out = subprocess.run([cxx, *CXX_FLAGS, src, "-o", tmp], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building packlib.cpp failed:\n{out.stdout}")
    os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = argtypes, None
            _lib = handle
        _lib.set_threads(max(torch.get_num_threads(), 1))
        return _lib


def available() -> bool:
    """True when the library builds and loads."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _fp(a):
    return a.ctypes.data_as(_F32P)


def _ip8(a):
    return a.ctypes.data_as(_I8P)


def permute_cols(w: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """dst[:, j] = w[:, perm[j]] of a (out, in) float32 matrix."""
    w = np.ascontiguousarray(w, np.float32)
    perm = np.ascontiguousarray(perm, np.int32)
    if perm.shape != (w.shape[1],) or (perm.size and not 0 <= perm.min() <= perm.max()
                                       < w.shape[1]):
        raise ValueError(f"perm must index the {w.shape[1]} columns, got {perm.shape}")
    out = np.empty_like(w)
    lib().permute_cols_f32(_fp(w), perm.ctypes.data_as(_I32P), w.shape[0], w.shape[1],
                           _fp(out))
    return out


def _group_quant(fn: str, w: np.ndarray, group: int, n_bits: int):
    w = np.ascontiguousarray(w, np.float32)
    o, c = w.shape
    if c % group:
        raise ValueError(f"in_features {c} is not a multiple of the group {group}")
    q = np.empty((o, c), np.int8)
    scales = np.empty((o, c // group), np.float32)
    getattr(lib(), fn)(_fp(w), o, c, group, n_bits, _ip8(q), _fp(scales))
    return q, scales


def group_quant(w: np.ndarray, group: int, n_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(out, in) f32 → (q int8 (out, in), scales f32 (out, in/group)) by the
    JAX package's host rule (scale = max(absmax, 1e-5) / q_max, q =
    rint(w · (1/scale)))."""
    return _group_quant("group_quant", w, group, n_bits)


def group_quant_rcp(w: np.ndarray, group: int, n_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """group_quant by the port's device rule (quant/core.group_quant_params:
    scale = max(absmax, 1e-5) · f32(1/q_max), q = rint(w / scale))."""
    return _group_quant("group_quant_rcp", w, group, n_bits)


def pack_nibbles_split(qt: np.ndarray) -> np.ndarray:
    """(K, O) int8 int4-range → (K/2, O) split-half bytes, nibbles biased
    by +8."""
    qt = np.ascontiguousarray(qt, np.int8)
    k, o = qt.shape
    if k % 2:
        raise ValueError(f"nibble packing needs an even K, got {k}")
    out = np.empty((k // 2, o), np.int8)
    lib().pack_nibbles_split(_ip8(qt), k, o, _ip8(out))
    return out


def transpose(a: np.ndarray) -> np.ndarray:
    """(r, c) int8 or float32 → (c, r), contiguous."""
    a = np.ascontiguousarray(a)
    fn = {np.dtype(np.int8): ("transpose_i8", _ip8),
          np.dtype(np.float32): ("transpose_f32", _fp)}.get(a.dtype)
    if fn is None:
        raise TypeError(f"transpose takes int8 or float32, not {a.dtype}")
    out = np.empty((a.shape[1], a.shape[0]), a.dtype)
    getattr(lib(), fn[0])(fn[1](a), a.shape[0], a.shape[1], fn[1](out))
    return out


# ---------------------------------------------------------------- plain versions


def permute_cols_plain(w, perm):
    return np.ascontiguousarray(np.asarray(w, np.float32)[:, np.asarray(perm)])


def group_quant_plain(w, group, n_bits, rule="jax"):
    """group_quant ("jax") or group_quant_rcp ("rcp") in numpy float32."""
    w = np.asarray(w, np.float32)
    o, c = w.shape
    g = w.reshape(o, c // group, group)
    qmax = np.float32(2 ** (n_bits - 1) - 1)
    absmax = np.maximum(np.abs(g).max(-1, keepdims=True), np.float32(1e-5))
    if rule == "jax":
        scales = absmax / qmax
        q = np.rint(g * (np.float32(1) / scales))
    else:
        scales = absmax * (np.float32(1) / qmax)
        q = np.rint(g / scales)
    return q.astype(np.int8).reshape(o, c), scales.reshape(o, c // group)


def pack_nibbles_split_plain(qt):
    qt = np.asarray(qt, np.int8)
    k = qt.shape[0]
    lo = (qt[: k // 2].astype(np.int16) + 8).astype(np.uint8) & 0x0F
    hi = ((qt[k // 2:].astype(np.int16) + 8).astype(np.uint8) & 0x0F) << 4
    return (lo | hi).astype(np.int8)


def transpose_plain(a):
    return np.ascontiguousarray(np.asarray(a).T)
