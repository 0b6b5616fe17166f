"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exports a plain ``extern "C"`` launcher that
returns ``cudaGetLastError()``.  On first use the sources are compiled
with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started
together), linked into one shared library under ``build/kernels/`` at the
repository root, and loaded with ``ctypes``.  The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused.  A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("paged_attention.cu", "ragged_attention.cu")
HEADERS = ("attention_tile.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# what the last build printed (ptxas register / shared-memory report) and
# how long it took; empty / None when the library came from BUILD_DIR
build_log = ""
build_seconds: Optional[float] = None

_lib: Optional[ctypes.CDLL] = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k_pool, v_pool, block_tables, context_lens, out,
    # b, n_kv, g, hd, nb, bs, dtype, stream
    "paged_attention_launch": [_P] * 6 + [_I] * 7 + [_P],
    # q, k_pool, v_pool, block_tables, positions, out,
    # n_seg, seq_l, n_kv, g, hd, nb, bs, dtype, stream
    "ragged_attention_launch": [_P] * 6 + [_I] * 8 + [_P],
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` as torch finds it, else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(c)}):\n{o}")
    return "".join(outs)


def _build(lib_path: Path) -> None:
    global build_log, build_seconds
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    stage = lib_path.parent / f".{lib_path.stem}.{os.getpid()}"
    stage.mkdir(parents=True, exist_ok=True)
    objs = [stage / (Path(s).stem + ".o") for s in SOURCES]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                    for s, o in zip(SOURCES, objs)])
    tmp = stage / lib_path.name
    log += _run_all([[nvcc, "-shared", "-gencode",
                      "arch=compute_90a,code=sm_90a",
                      *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    shutil.rmtree(stage, ignore_errors=True)
    build_log = log
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib_path = BUILD_DIR / f"libreprotorch_kernels-{_digest()}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


HEAD_DIMS = (32, 64, 112, 128)
_DTYPE_CODE = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    """Kernel dtype id of a float tensor (0 = float32, 1 = bfloat16)."""
    code = _DTYPE_CODE.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def check_operands(name: str, floats, ints) -> None:
    """What every launcher assumes of its operands: one CUDA device,
    contiguous, one float dtype, int32 metadata, 16-byte aligned floats
    (the kernels read q and the pools with 16-byte vector loads)."""
    import torch
    dev = floats[0].device
    for t in (*floats, *ints):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and on "
                             f"{dev}")
    for t in floats:
        if t.dtype != floats[0].dtype:
            raise TypeError(f"{name}: q and the pools must share a dtype")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: float operands must be 16-byte "
                             "aligned")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tables and positions must be int32")
    if floats[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {floats[0].shape[-1]} not in "
                         f"{HEAD_DIMS}")
