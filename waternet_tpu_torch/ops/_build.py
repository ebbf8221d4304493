"""Build the port's CUDA kernels with nvcc at first use and bind them.

Every ``csrc/*.cu`` has a plain C interface, so it compiles without
PyTorch's headers (seconds, not minutes). Each source compiles to its own
object with one nvcc process, all started together; one more nvcc call
links the objects into ``build/kernels/libwaternet_kernels.so`` at the
repository root, which loads with ctypes. The library is rebuilt whenever
the hash of the sources and the flags changes; ``--use_fast_math`` is
never used (the kernels must round exactly like the plain versions).
nvcc's ``-Xptxas -v`` report of registers and shared memory is kept beside
the library.
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
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_NAME = "libwaternet_kernels.so"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_TIMEOUT_S = 600


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
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "kernels are built from waternet_tpu_torch/csrc at first use"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
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
    exe = nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in SOURCES]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    compiles = [
        ([exe, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], obj)
        for src, obj in zip(SOURCES, objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd, _ in compiles
    ]
    log, failed = [], False
    for (cmd, _), proc in zip(compiles, procs):
        out, _ = proc.communicate(timeout=_TIMEOUT_S)
        log.append(f"$ {' '.join(cmd)}\n{out}[rc {proc.returncode}]")
        failed |= proc.returncode != 0
    if not failed:
        link = [exe, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(
            link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=_TIMEOUT_S,
        )
        log.append(f"$ {' '.join(link)}\n{proc.stdout}[rc {proc.returncode}]")
        failed = proc.returncode != 0
    text = "\n".join(log)
    (BUILD_DIR / (LIB_NAME + ".log")).write_text(
        text + f"\n[{time.perf_counter() - t0:.2f} s, {'failed' if failed else 'ok'}]\n"
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process, with every
    function's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "waternet_clahe_tile_lut": [
            ptr, ptr, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr,
        ],
        "waternet_clahe_tile_histogram": [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr],
        "waternet_clahe_lut_planes": [
            ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr,
        ],
        "waternet_clahe_lut_blend": [
            ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            i32, i32, i32, ptr,
        ],
        "waternet_dct8_dequant_idct": [ptr, ptr, ptr, ptr, i32, i32, ptr],
        "waternet_dct8_decode_u8": [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
        ],
        "waternet_conv_bias_act": [ptr, ptr, i32, i32, i32, ctypes.c_longlong, i32, i32, ptr],
        "waternet_dwconv3x3": [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    return lib
