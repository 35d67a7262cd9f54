"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

One `nvcc` call compiles every source for sm_90a into
build/torch_kernels/libsmt_kernels_<hash>.so at first use, where <hash>
covers the sources and the flags, so an edit rebuilds and an unchanged
tree reuses the library. The kernels export a plain C interface (no
PyTorch headers, so the build takes seconds); `load()` binds it with
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
# C entry point -> argtypes; every entry point returns cudaGetLastError()
SIGNATURES = {
    # g2, x2, rb, cb, out, T, O, I, n, dtype (0 fp32, 1 bf16), stream
    "smt_block_grad": (P, P, P, P, P, I, I, I, I, I, P),
    # p, g, m, v, scalars, numel, stream
    "smt_masked_adam": (P, P, P, P, P, I, P),
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
    for src in sources():
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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *[str(s) for s in sources()]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    last_build_seconds = time.time() - t0
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stdout + proc.stderr)
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


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
