"""ctypes bindings for the native host runtime ``native/libfluid_host.cpp``
(port of ``libfluid_tpu.native``).

The C++ library provides the host-side runtime of the reference's testbed
threads: an asynchronous export pool (points/OBJ/PPM serialization off the
dispatch thread) and mesh finalization (vertex weld and area-weighted
normals). It is host code, off the device path.

The shared library is compiled on first use with g++ into the directory of
:func:`libfluid_tpu_torch.cache.kernel_dir` (beside the CUDA kernel
library), under a name keyed by the source's and flags' hash; every entry
point has the
JAX package's pure-Python version as its fallback, so the package works
without a toolchain. :func:`available` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from libfluid_tpu_torch import cache

_SRC = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "native",
                                    "libfluid_host.cpp"))
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB_PATH = (str(cache.keyed_path("libfluid_host.so", [_SRC], _FLAGS)) if os.path.exists(_SRC)
             else None)

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the shared library if these sources have none; returns its
    path or None."""
    if _LIB_PATH is None:
        return None
    if os.path.exists(_LIB_PATH):
        return _LIB_PATH
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        global _build_error
        _build_error = str(e)
        return None
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        path = _build()
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(path)
        lib.lf_pool_create.restype = ctypes.c_void_p
        lib.lf_pool_create.argtypes = [ctypes.c_int]
        lib.lf_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.lf_pool_flush.argtypes = [ctypes.c_void_p]
        lib.lf_pool_pending.restype = ctypes.c_int
        lib.lf_pool_pending.argtypes = [ctypes.c_void_p]
        lib.lf_pool_errors.restype = ctypes.c_int
        lib.lf_pool_errors.argtypes = [ctypes.c_void_p]
        lib.lf_submit_points.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.lf_submit_obj.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        lib.lf_submit_ppm.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ]
        lib.lf_weld_mesh.restype = ctypes.c_int
        lib.lf_weld_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def weld_mesh(
    vertices: np.ndarray, count: Optional[int] = None, eps: float = 1e-6,
    with_normals: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(T,3,3) triangle soup -> (positions (V,3), indices (F,3), normals).

    Native weld + area-weighted normals when the library is available,
    otherwise a numpy fallback (``io.obj.dedup_triangles`` + vectorized
    normal accumulation)."""
    tris = np.ascontiguousarray(
        np.asarray(vertices)[: (vertices.shape[0] if count is None else int(count))],
        np.float32,
    )
    n_tris = tris.shape[0]
    if n_tris == 0:
        z = np.zeros((0, 3), np.float32)
        return z, np.zeros((0, 3), np.int32), (z if with_normals else None)
    lib = _load()
    if lib is not None:
        out_pos = np.empty((n_tris * 3, 3), np.float32)
        out_idx = np.empty((n_tris * 3,), np.int32)
        out_nrm = np.empty((n_tris * 3, 3), np.float32) if with_normals else None
        nv = lib.lf_weld_mesh(
            _f32p(tris), n_tris, eps, _f32p(out_pos),
            out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _f32p(out_nrm) if with_normals else None,
        )
        return (
            out_pos[:nv].copy(),
            out_idx.reshape(-1, 3).copy(),
            out_nrm[:nv].copy() if with_normals else None,
        )
    # numpy fallback
    from libfluid_tpu_torch.io.obj import dedup_triangles

    pos, idx = dedup_triangles(tris, n_tris, decimals=max(0, round(-np.log10(eps))))
    nrm = None
    if with_normals:
        e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
        e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
        fn = np.cross(e1, e2)
        nrm = np.zeros_like(pos)
        for k in range(3):
            np.add.at(nrm, idx[:, k], fn)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-30)
    return pos.astype(np.float32), idx.astype(np.int32), nrm


class ExportPool:
    """Asynchronous frame exporter (the testbed's writer threads).

    Submissions copy their data and return immediately; serialization happens
    on native worker threads. Call :meth:`flush` to barrier, check
    :attr:`errors` afterwards. Falls back to a Python thread pool writing via
    :mod:`libfluid_tpu_torch.io` when the native library is unavailable.
    """

    def __init__(self, n_threads: int = 2):
        self._lib = _load()
        self._pool = None
        self._py_pool = None
        self._py_futures = []
        if self._lib is not None:
            self._pool = ctypes.c_void_p(self._lib.lf_pool_create(n_threads))
        else:
            import concurrent.futures

            self._py_pool = concurrent.futures.ThreadPoolExecutor(n_threads)

    @property
    def native(self) -> bool:
        return self._pool is not None

    def submit_points(self, path: str, positions, active=None) -> None:
        pos = np.ascontiguousarray(np.asarray(positions), np.float32)
        if self._pool is not None:
            act = None
            actp = None
            if active is not None:
                act = np.ascontiguousarray(np.asarray(active), np.uint8)
                actp = act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            self._lib.lf_submit_points(
                self._pool, path.encode(), _f32p(pos), actp, pos.shape[0]
            )
        else:
            from libfluid_tpu_torch.io.point_cloud import save_points

            a = None if active is None else np.asarray(active).copy()
            self._py_futures.append(
                self._py_pool.submit(save_points, path, pos.copy(), a)
            )

    def submit_obj(self, path: str, vertices, count=None, weld_eps: float = 1e-6,
                   with_normals: bool = True) -> None:
        tris = np.ascontiguousarray(
            np.asarray(vertices)[: (None if count is None else int(count))],
            np.float32,
        )
        if self._pool is not None:
            self._lib.lf_submit_obj(
                self._pool, path.encode(), _f32p(tris), tris.shape[0],
                weld_eps, int(with_normals),
            )
        else:
            from libfluid_tpu_torch.io.obj import save_obj

            self._py_futures.append(
                self._py_pool.submit(save_obj, path, tris.copy(), tris.shape[0])
            )

    def submit_ppm(self, path: str, image, gamma: float = 2.2) -> None:
        img = np.ascontiguousarray(np.asarray(image), np.float32)
        h, w, _ = img.shape
        if self._pool is not None:
            self._lib.lf_submit_ppm(
                self._pool, path.encode(), _f32p(img), w, h, gamma or 0.0
            )
        else:
            from libfluid_tpu_torch.io.ppm import save_ppm

            self._py_futures.append(
                self._py_pool.submit(save_ppm, path, img.copy(), gamma)
            )

    def flush(self) -> None:
        if self._pool is not None:
            self._lib.lf_pool_flush(self._pool)
        else:
            for f in self._py_futures:
                f.result()
            self._py_futures.clear()

    @property
    def errors(self) -> int:
        if self._pool is not None:
            return self._lib.lf_pool_errors(self._pool)
        n = 0
        for f in self._py_futures:
            if f.done() and f.exception() is not None:
                n += 1
        return n

    def close(self) -> None:
        if self._pool is not None:
            self.flush()
            self._lib.lf_pool_destroy(self._pool)
            self._pool = None
        elif self._py_pool is not None:
            self.flush()
            self._py_pool.shutdown()
            self._py_pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
