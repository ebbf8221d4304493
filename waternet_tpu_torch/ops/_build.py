"""Build the port's CUDA kernels with nvcc at first use and bind them.

``csrc/clahe.cu`` has a plain C interface, so it compiles without
PyTorch's headers (seconds, not minutes) into
``build/kernels/libwaternet_clahe.so`` at the repository root and loads
with ctypes. The library is rebuilt whenever the hash of the source and
the flags changes; ``--use_fast_math`` is never used (the kernels must
round exactly like the plain versions). nvcc's ``-Xptxas -v`` report of
registers and shared memory is kept beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "clahe.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_NAME = "libwaternet_clahe.so"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    usual install prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        Path(home) / "bin" / "nvcc" if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CLAHE "
        "kernels are built from waternet_tpu_torch/csrc at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernel library if it is missing or stale; return its path."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (BUILD_DIR / (LIB_NAME + ".log")).write_text(
        log + f"\n[{time.perf_counter() - t0:.2f} s, rc {proc.returncode}]\n"
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process, with every
    function's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.waternet_clahe_tile_lut.argtypes = [
        ptr, ptr, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr,
    ]
    lib.waternet_clahe_tile_lut.restype = i32
    lib.waternet_clahe_lut_planes.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.waternet_clahe_lut_planes.restype = i32
    return lib
