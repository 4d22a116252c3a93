"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Every `csrc/*.cu` is compiled for sm_90a in its own nvcc process (all
started together), then linked into one shared library with a plain C
interface.  The library is cached under `kernels/_build/` keyed by a hash
of the sources and flags, so a second process reuses it; a fresh checkout
builds it at first use.  Nothing here runs at import time: the CPU tests
import every module on a machine without nvcc.

Launch accounting lives here too: each kernel wrapper adds one to
`LAUNCHES[name]` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures (argtypes, restype) of the exported entry points; every
# pointer and the stream go as c_void_p so ctypes never cuts them to 32 bits
_SIGNATURES = {
    "sq_rawx_workspace_bytes": ([_I] * 5, ctypes.c_longlong),
    "sq_rawx": ([_P] * 8 + [_I] * 10 + [_F, _F, _I, _I, _P], _I),
    "sq_rawx_stream": ([_P] * 7 + [_I] * 10 + [_F, _F, _F, _I, _I, _P], _I),
    "sq_int4_gmm": ([_P] * 7 + [_I] * 5 + [_I, _I, _P], _I),
    "sq_int4_gmm_wg": ([_P] * 7 + [_I] * 5 + [_I, _P], _I),
    "sq_int_gmm_workspace_bytes": ([_I] * 4, ctypes.c_longlong),
    "sq_int_gmm": ([_P] * 8 + [_I] * 6 + [_I, _I, _P], _I),
    "sq_int_gmm_stream": ([_P] * 7 + [_I] * 10 + [_P], _I),
    "sq_dual_path": ([_P] * 6 + [_I] * 7 + [_I, _I, _P], _I),
    "sq_gmm_stacked_workspace_bytes": ([_I] * 4, ctypes.c_longlong),
    "sq_int4_gmm_stacked": ([_P] * 8 + [_I] * 6 + [_I, _I, _P], _I),
    "sq_int4_gmm_stacked_stream": ([_P] * 7 + [_I] * 10 + [_P], _I),
    "sq_quantize_grouped_t": ([_P] * 3 + [_I] * 4 + [_F, _I, _P], _I),
    "sq_norm_quantize_t": ([_P] * 5 + [_I] * 8 + [_F, _F, _I, _I, _P], _I),
    "sq_act_rows": ([_P] * 5 + [_I] * 13 + [_F] * 3 + [_I, _I, _P], _I),
    "sq_write_cache_hm": ([_P] * 9 + [_I] * 5 + [_I, _P], _I),
    "sq_write_cache_smajor": ([_P] * 9 + [_I] * 5 + [_I, _P], _I),
    "sq_kv_rows_smajor": ([_P] * 11 + [_L] * 6 + [_I] * 11 + [_P], _I),
    "sq_kv_rows_hm": ([_P] * 11 + [_L] * 6 + [_I] * 11 + [_P], _I),
    "sq_decode_attn_smajor": ([_P] * 7 + [_I] * 6 + [_F, _I, _P], _I),
    "sq_decode_attn_smajor_split": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    "sq_int8_prefill": ([_P] * 7 + [_I] * 4 + [_I, _I, _P], _I),
    "sq_int8_prefill_rawx": ([_P] * 8 + [_I] * 4 + [_I, _I, _P], _I),
    "sq_int8_prefill_wg": ([_P] * 7 + [_I] * 4 + [_I, _I, _P], _I),
    "sq_int8_linear_wg": ([_P] * 4 + [_I] * 3 + [_F] + [_I] * 3 + [_P], _I),
    "sq_int8_linear_stream": ([_P] * 4 + [_I] * 3 + [_F] + [_I] * 3 + [_P], _I),
    "sq_decode_attn": ([_P] * 8 + [_I] * 6 + [_F, _I, _I, _P], _I),
    "sq_decode_attn_split": ([_P] * 8 + [_I] * 7 + [_F, _I, _P], _I),
    "sq_fp_matmul_workspace_bytes": ([_I] * 3, ctypes.c_longlong),
    "sq_fp_matmul": ([_P] * 4 + [_I] * 3 + [_I, _P], _I),
    "sq_fp_matmul_stream": ([_P] * 3 + [_I] * 5 + [_P], _I),
    "sq_int8_gemm": ([_P] * 4 + [_I] * 4 + [_F] + [_I] * 3 + [_P], _I),
    "sq_int8_bmm_attn": ([_P] * 3 + [_I] * 4 + [_F] + [_I] * 3 + [_P], _I),
    "sq_norm_quant": ([_P] * 4 + [_I] * 2 + [_F] * 2 + [_I] * 2 + [_P], _I),
    "sq_norm_quant_rows": ([_P] * 4 + [_I] * 5 + [_F] * 2 + [_I] * 3 + [_P], _I),
    "sq_fused_attn": ([_P] * 11 + [_I] * 10 + [_F, _I, _P], _I),
    "sq_fused_attn_split": ([_P] * 11 + [_I] * 11 + [_F, _P], _I),
    "sq_mlp_fused_workspace_bytes": ([_I] * 11, ctypes.c_longlong),
    "sq_mlp_fused_grid_blocks": ([_I] * 3, _I),
    "sq_mlp_fused": ([_P] * 10 + [_I] * 13 + [_F, _F, _I, _I, _P], _I),
    "sq_mlp_stream": ([_P] * 12 + [_I] * 14 + [_F] * 3 + [_I] * 3 + [_P], _I),
}

_lib = None
_lock = threading.Lock()
build_log = ""


def reset_launches() -> None:
    LAUNCHES.clear()


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> str:
    """Compile every source in parallel and link the library; returns its
    path.  Raises with nvcc's output on failure."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libsq_kernels_{_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR,
                           f"{os.path.basename(src)[:-3]}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [p.communicate()[0] for _, p in procs]   # wait for every nvcc
    for (obj, p), out in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj}:\n{out}")
    objs = [obj for obj, _ in procs]
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", "-gencode",
                           "arch=compute_90a,code=sm_90a", *objs, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    build_log = "\n".join(logs)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def check_operands(device: torch.device, **tensors) -> None:
    """Raise unless every given tensor lies on `device` and is contiguous:
    the kernels take raw pointers and index them densely."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def aligned(t: torch.Tensor, align: int = 16) -> torch.Tensor:
    """t, or a copy of it that starts `align`-byte aligned (the kernels'
    vector, cp.async and TMA copies need it; a slice may start anywhere)."""
    return t if t.data_ptr() % align == 0 else t.clone()


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


DT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dt_code(t: torch.Tensor) -> int:
    try:
        return DT_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None
