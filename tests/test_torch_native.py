"""The port's native host runtime (``libfluid_tpu_torch.native``) on the
cases of ``tests/test_native.py``: weld and normals, the pure-Python weld
against the library's, the export pool's round trip and error count, the
library in use where g++ builds it; and the weld equal to the JAX
package's, whose module is the same contract."""

import os

import numpy as np
import pytest

from libfluid_tpu import native as jnative
from libfluid_tpu_torch import cache, native
from libfluid_tpu_torch.io.obj import load_obj
from libfluid_tpu_torch.io.point_cloud import load_points


def two_quads():
    """Two triangles sharing an edge: 6 corners, 4 unique vertices."""
    return np.asarray(
        [
            [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
            [[1, 0, 0], [1, 1, 0], [0, 1, 0]],
        ],
        np.float32,
    )


def test_weld_mesh_counts_and_normals():
    tris = two_quads()
    pos, idx, nrm = native.weld_mesh(tris, with_normals=True)
    assert pos.shape == (4, 3)
    assert idx.shape == (2, 3)
    # both faces lie in z=0 with +z winding -> all vertex normals +z
    np.testing.assert_allclose(nrm, np.tile([0, 0, 1.0], (4, 1)), atol=1e-6)
    # indices reconstruct the soup
    np.testing.assert_allclose(pos[idx], tris, atol=0)


def test_weld_mesh_python_fallback_matches():
    tris = two_quads()
    got = native.weld_mesh(tris, with_normals=True)
    # force the numpy fallback by calling internals
    from libfluid_tpu_torch.io.obj import dedup_triangles

    pos, idx = dedup_triangles(tris, 2)
    assert pos.shape[0] == got[0].shape[0]
    # same vertex SET (order may differ)
    a = {tuple(v) for v in np.round(got[0], 5).tolist()}
    b = {tuple(v) for v in np.round(pos, 5).tolist()}
    assert a == b


def test_export_pool_round_trip(tmp_path):
    pool = native.ExportPool(2)
    pts = np.random.default_rng(0).uniform(-5, 5, (257, 3)).astype(np.float32)
    active = np.ones((257,), bool)
    active[::3] = False
    ppath = str(tmp_path / "pts.txt")
    pool.submit_points(ppath, pts, active)

    tris = two_quads()
    opath = str(tmp_path / "mesh.obj")
    pool.submit_obj(opath, tris)

    img = np.random.default_rng(1).uniform(0, 1, (13, 17, 3)).astype(np.float32)
    ipath = str(tmp_path / "img.ppm")
    pool.submit_ppm(ipath, img, gamma=2.2)

    pool.flush()
    assert pool.errors == 0

    got = load_points(ppath)
    np.testing.assert_allclose(got, pts[active], rtol=1e-6)

    pos, idx = load_obj(opath)
    assert pos.shape == (4, 3)
    assert idx.shape == (2, 3)

    with open(ipath, "rb") as f:
        header = f.readline()
        assert header == b"P6\n"
        dims = f.readline().split()
        assert dims == [b"17", b"13"]
    pool.close()


def test_export_pool_reports_errors(tmp_path):
    pool = native.ExportPool(1)
    pool.submit_points(str(tmp_path / "no_dir" / "x.txt"), np.zeros((1, 3), np.float32))
    pool.flush()
    assert pool.errors == 1
    pool.close()


def test_native_library_used():
    if not native.available():
        pytest.skip("native toolchain missing")
    pool = native.ExportPool(1)
    assert pool.native
    pool.close()
    assert os.path.dirname(native._LIB_PATH) == str(cache.kernel_dir())


def test_weld_equals_jax():
    rng = np.random.default_rng(3)
    tris = np.concatenate([two_quads(), rng.uniform(-1, 1, (5, 3, 3)).astype(np.float32)])
    for a, b in zip(native.weld_mesh(tris), jnative.weld_mesh(tris)):
        np.testing.assert_array_equal(a, b)


def test_library_names_are_keyed_by_content(tmp_path, monkeypatch):
    """Two trees that share ``$LIBFLUID_CACHE_DIR`` never load each other's
    library: its name changes with a source's bytes or a flag, and not
    with the file's time."""
    monkeypatch.setenv("LIBFLUID_CACHE_DIR", str(tmp_path / "cache"))
    src = tmp_path / "k.cu"
    src.write_text("int a;")
    first = cache.keyed_path("lib.so", [src], ["-O3"])
    assert first.parent == tmp_path / "cache" and first.suffix == ".so"
    os.utime(src, (1, 1))
    assert cache.keyed_path("lib.so", [src], ["-O3"]) == first
    assert cache.keyed_path("lib.so", [src], ["-O2"]) != first
    src.write_text("int b;")
    assert cache.keyed_path("lib.so", [src], ["-O3"]) != first
