"""Build and load the port's CUDA kernels (csrc/*.cu, which include
csrc/*.cuh) as one shared library.

At first use, one `nvcc -c` per source, all started together, compiles
the sources for sm_90a, and one more links them into
build/torch_kernels/libsmt_kernels_<hash>.so, where <hash> covers the
sources, their headers and the flags, so an edit rebuilds and an
unchanged tree reuses the library. The kernels export a plain C interface
(no PyTorch headers, so the build takes seconds); `load()` binds it with
ctypes. Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C entry point -> argtypes; every entry point returns cudaGetLastError().
# dtype codes: 0 fp32, 1 bf16, 2 fp16 (K1, K3, K4's out, the row
# quantization's x, K5; K6 and K7 take 0 and 1)
SIGNATURES = {
    # g2, x2, rb, cb, out, ws, counters, T, O, I, n, bm, splits, dtype, stream
    "smt_block_grad": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    # p, g, m, v, scalars, numel, stream
    "smt_masked_adam": (P, P, P, P, P, I, P),
    # q, k, v, o, lse, B, S, Hq, Hkv, hd, sm_scale, dtype, stream
    "smt_attn_fwd": (P, P, P, P, P, I, I, I, I, I, F, I, P),
    # o, do, delta, B, S, Hq, hd, dtype, stream
    "smt_attn_bwd_delta": (P, P, P, I, I, I, I, I, P),
    # q, k, v, do, lse, delta, dk, dv, workspace, B, S, Hq, Hkv, hd,
    # partitions, sm_scale, dtype, stream
    "smt_attn_bwd_dkdv": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
    # workspace, dk, dv, n, partitions, dtype, stream
    "smt_attn_bwd_dkdv_reduce": (P, P, P, I, I, I, P),
    # q, k, v, do, lse, delta, dq, B, S, Hq, Hkv, hd, sm_scale, dtype, stream
    "smt_attn_bwd_dq": (P, P, P, P, P, P, P, I, I, I, I, I, F, I, P),
    # q, k, v, ks, vs, slot_mask, o, ws_o, ws_m, ws_l, B, T, S, Hq, Hkv, hd,
    # cache_index, sm_scale, q dtype, cache dtype (2 = int8), splits, stream
    "smt_cached_attn": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, P),
    # ws_o, ws_m, ws_l, o, rows, hd, splits, dtype, stream
    "smt_cached_attn_combine": (P, P, P, P, I, I, I, I, P),
    # x, sw (or null), xq, sx, T, K, x dtype, stream
    "smt_row_quant": (P, P, P, P, I, I, I, P),
    # xq, sx, wq, sw, out, T, O, K, out dtype, bm, bn, grid, stream
    "smt_q8mm_t": (P, P, P, P, P, I, I, I, I, I, I, I, P),
    # gq, sg, wq, out, T, O, K, out dtype, bm, bn, grid, stream
    "smt_q8mm_g": (P, P, P, P, I, I, I, I, I, I, I, P),
    # out, src, delta, run_o, run_start, run_j, idx_in, T, O, I, runs, n,
    # transpose, dtype, bm, bn, stream
    "smt_block_correction": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # x, w4, s4, ws, counters, out, T, O, K, splits, out dtype, stream
    "smt_q4mm": (P, P, P, P, P, P, I, I, I, I, I, P),
}

_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built from csrc/ on the machine with the card")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsmt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.time()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    objs = [obj for _, obj, _ in jobs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    last_build_seconds = time.time() - t0
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_COUNTERS = {}  # (owner, device index) -> zeroed int32 tile counters


def tile_counters(device, n: int, owner: str):
    """At least n zeroed int32 counters on `device` for the kernel `owner`,
    whose last CTA of a tile to arrive sums the split partials (K1, K6).
    Every launch leaves the counters it used at zero, so one buffer per
    kernel serves every call in stream order."""
    import torch
    key = (owner, device.index)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
