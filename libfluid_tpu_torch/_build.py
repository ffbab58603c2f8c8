"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each kernel source compiles with its own ``nvcc`` call, all at once, and
the objects link into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds), loaded with ``ctypes``, in
the directory of :func:`libfluid_tpu_torch.cache.kernel_dir` under a name
keyed by the sources', headers' and flags' hash. The build runs at first
use of those sources; a failed build raises. Every entry point takes raw
device pointers plus the CUDA stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

from libfluid_tpu_torch import cache

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = (
    "expand.cu", "p2g.cu", "p2g_overflow.cu", "p2g_bwd.cu", "stencil.cu", "vcycle.cu", "g2p.cu",
    "g2p_bwd.cu", "correction.cu", "correction_bwd.cu", "surface.cu", "surface_bwd.cu", "bf16_check.cu",
)
# staging.cuh: g2p.cu, g2p_bwd.cu, p2g_bwd.cu; jitter.cuh: correction.cu, correction_bwd.cu
HEADERS = ("staging.cuh", "jitter.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-I", str(CSRC),
)

# flags of single sources: the fused V-cycle keeps the plain versions'
# unfused multiplies and adds
SOURCE_FLAGS = {"vcycle.cu": ("-fmad=false",)}
LIB_PATH = cache.keyed_path(
    "libfluid_tpu_kernels.so", [CSRC / f for f in SOURCES + HEADERS],
    [*NVCC_FLAGS, *(f"{s}:{' '.join(fl)}" for s, fl in sorted(SOURCE_FLAGS.items()))],
)
BUILD_DIR = LIB_PATH.parent

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# entry point -> argument types; the last argument is always the stream
SIGNATURES = {
    "lf_expand": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "lf_p2g": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    "lf_p2g_overflow": [_P] * 13 + [_I, _LL, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    "lf_p2g_normalize": [_P] * 9 + [_LL, _LL, _LL, _P],
    "lf_p2g_bwd": [_P] * 8 + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    "lf_stencil": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "lf_stencil16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "lf_mg_pre": [_P] * 8 + [_I, _I, _I, _F, _F, _P],
    "lf_mg_restrict": [_P] * 10 + [_I, _I, _I, _F, _P],
    "lf_mg_up": [_P] * 10 + [_I, _I, _I, _F, _F, _P],
    "lf_mg_coarse": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P],
    "lf_mg16_pre": [_P] * 8 + [_I, _I, _I, _F, _F, _P],
    "lf_mg16_restrict": [_P] * 10 + [_I, _I, _I, _F, _P],
    "lf_mg16_up": [_P] * 10 + [_I, _I, _I, _F, _F, _P],
    "lf_mg16_coarse": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P],
    "lf_g2p": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _F, _F, _F, _P],
    "lf_g2p_bwd": [_P] * 10 + [_LL, _I, _I, _I, _F, _F, _F, _F, _P],
    "lf_correction": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "lf_correction_bwd": [_P] * 5 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "lf_surface": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P],
    "lf_surface_keep": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P],
    "lf_surface_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
    "lf_bf16_check": [_P, _P],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _run(cmds) -> None:
    """Run the commands in parallel; raise with the output of the first that
    fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"kernel build failed ({' '.join(cmd)}):\n{out}\n{err}")
    if failed:
        raise RuntimeError(failed[0])


def build() -> None:
    """Compile every kernel (one nvcc per source, all at once) and link them
    into ``LIB_PATH``; raises if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    _run([
        [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(s, ()), "-c", "-o", str(o), str(CSRC / s)]
        for s, o in zip(SOURCES, objs)
    ])
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}"
    _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The kernel library, built first if these sources have none."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIB_PATH.exists():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
