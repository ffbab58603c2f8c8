"""Scene representation: flat tensors and a host-side builder (port of
``libfluid_tpu.renderer.scene``).

Triangles are stored as a vertex and two edges with precomputed geometric
normals, spheres as affine-transformed unit spheres, each row with a
material id into a :class:`~libfluid_tpu_torch.renderer.materials.MaterialTable`.
:class:`SceneBuilder` collects meshes on the host in numpy, as the JAX
package does; :meth:`SceneBuilder.finish` pads the arrays to their capacity,
collects the emissive triangles into the light list and moves everything to
the device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from libfluid_tpu_torch.config import resolve_device
from libfluid_tpu_torch.renderer import materials as mat_mod


class Scene(NamedTuple):
    # triangles
    tri_p0: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor  # (T, 3) edge to vertex 2
    tri_e2: torch.Tensor  # (T, 3) edge to vertex 3
    tri_normal: torch.Tensor  # (T, 3) unit geometric normal
    tri_mat: torch.Tensor  # (T,) int64; 0 = padding/null
    # spheres (unit sphere through an affine transform)
    sph_to_world: torch.Tensor  # (S, 3, 4)
    sph_to_local: torch.Tensor  # (S, 3, 4)
    sph_mat: torch.Tensor  # (S,) int64
    materials: mat_mod.MaterialTable
    # emissive triangle lights
    light_tri: torch.Tensor  # (L,) int64 indices into the triangle arrays
    light_area: torch.Tensor  # (L,)
    light_mask: torch.Tensor  # (L,) bool, the valid entries
    # optional uniform-grid ray accelerator (renderer.accel); None = the
    # chunked brute-force intersector
    accel: object = None

    @property
    def device(self) -> torch.device:
        return self.tri_p0.device


class SceneBuilder:
    """Host-side accumulation of primitives and materials; call
    :meth:`finish` once for the :class:`Scene`."""

    def __init__(self):
        self._tris: List[np.ndarray] = []  # each (n, 3, 3): p0, p1, p2
        self._tri_mats: List[np.ndarray] = []
        self._sph_to_world: List[np.ndarray] = []
        self._sph_mats: List[int] = []
        # material 0 is the reserved null material
        self._kinds = [mat_mod.LAMBERTIAN]
        self._albedo = [(0.0, 0.0, 0.0)]
        self._ior = [1.0]
        self._emission = [(0.0, 0.0, 0.0)]
        self._albedo_tex = [0]
        self._emission_tex = [0]
        # texture 0 is the reserved 1x1 white texel ("no texture")
        self._textures: List[np.ndarray] = [np.ones((1, 1, 3))]

    def _packed_textures(self) -> np.ndarray:
        """All textures in one (NT, TH, TW, 3) array, padded to the largest;
        the true sizes ride in ``tex_hw``."""
        th = max(t.shape[0] for t in self._textures)
        tw = max(t.shape[1] for t in self._textures)
        out = np.zeros((len(self._textures), th, tw, 3))
        for i, t in enumerate(self._textures):
            out[i, : t.shape[0], : t.shape[1]] = t
        return out

    def add_texture(self, texels) -> int:
        """Register an (H, W, 3) texture; returns its id for the material
        channels."""
        t = np.asarray(texels, np.float64)
        if t.ndim != 3 or t.shape[2] != 3:
            raise ValueError(f"texture must be (H, W, 3), got {t.shape}")
        self._textures.append(t)
        return len(self._textures) - 1

    def add_material(self, kind, albedo=(0, 0, 0), ior=1.0, emission=(0, 0, 0),
                     albedo_tex: int = 0, emission_tex: int = 0) -> int:
        self._kinds.append(int(kind))
        self._albedo.append(tuple(float(c) for c in albedo))
        self._ior.append(float(ior))
        self._emission.append(tuple(float(c) for c in emission))
        self._albedo_tex.append(int(albedo_tex))
        self._emission_tex.append(int(emission_tex))
        return len(self._kinds) - 1

    def lambertian(self, albedo, emission=(0, 0, 0), albedo_tex: int = 0,
                   emission_tex: int = 0) -> int:
        return self.add_material(mat_mod.LAMBERTIAN, albedo, emission=emission,
                                 albedo_tex=albedo_tex, emission_tex=emission_tex)

    def mirror(self, albedo=(1, 1, 1)) -> int:
        return self.add_material(mat_mod.SPECULAR_REFLECTION, albedo)

    def glass(self, ior, skin=(1, 1, 1)) -> int:
        return self.add_material(mat_mod.SPECULAR_TRANSMISSION, skin, ior=ior)

    def add_mesh(self, positions, indices, material: int, transform=None):
        """Add a triangle mesh, pre-transformed: `positions` (V, 3), `indices`
        flat (3k,), `transform` an optional (3, 4) matrix."""
        pos = np.asarray(positions, np.float64)
        if transform is not None:
            m = np.asarray(transform, np.float64)
            pos = pos @ m[:, :3].T + m[:, 3]
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        tris = pos[idx]  # (n, 3, 3)
        self._tris.append(tris)
        self._tri_mats.append(np.full((tris.shape[0],), material, np.int64))

    def add_triangle_soup(self, vertices, material: int):
        """Add raw triangles (n, 3, 3)."""
        tris = np.asarray(vertices, np.float64).reshape(-1, 3, 3)
        self._tris.append(tris)
        self._tri_mats.append(np.full((tris.shape[0],), material, np.int64))

    def add_sphere(self, transform, material: int):
        """An affine-transformed unit sphere."""
        self._sph_to_world.append(np.asarray(transform, np.float64).reshape(3, 4))
        self._sph_mats.append(material)

    def finish(self, tri_capacity: Optional[int] = None, light_capacity: Optional[int] = None,
               dtype=torch.float32, device=None) -> Scene:
        """The static-shape :class:`Scene` on `device` (None: the CUDA card;
        ``"cpu"`` on request)."""
        device = resolve_device(device)
        if self._tris:
            tris = np.concatenate(self._tris, axis=0)
            tmat = np.concatenate(self._tri_mats, axis=0)
        else:
            tris = np.zeros((0, 3, 3))
            tmat = np.zeros((0,), np.int64)
        n = tris.shape[0]
        cap = tri_capacity or max(n, 1)
        if n > cap:
            raise ValueError(f"triangle capacity {cap} < {n}")
        p0 = np.zeros((cap, 3))
        e1 = np.zeros((cap, 3))
        e2 = np.zeros((cap, 3))
        nrm = np.zeros((cap, 3))
        nrm[:, 1] = 1.0
        mats = np.zeros((cap,), np.int64)
        if n:
            p0[:n] = tris[:, 0]
            e1[:n] = tris[:, 1] - tris[:, 0]
            e2[:n] = tris[:, 2] - tris[:, 0]
            cr = np.cross(e1[:n], e2[:n])
            ln = np.linalg.norm(cr, axis=-1, keepdims=True)
            nrm[:n] = cr / np.maximum(ln, 1e-30)
            mats[:n] = tmat

        emission = np.asarray(self._emission)
        is_light = np.zeros((cap,), bool)
        if n:
            is_light[:n] = np.abs(emission[mats[:n]]).sum(-1) > 1e-9
        light_idx = np.flatnonzero(is_light)
        areas = 0.5 * np.linalg.norm(np.cross(e1[light_idx], e2[light_idx]), axis=-1)
        lcap = light_capacity or max(light_idx.size, 1)
        li = np.zeros((lcap,), np.int64)
        la = np.zeros((lcap,))
        lm = np.zeros((lcap,), bool)
        li[: light_idx.size] = light_idx
        la[: light_idx.size] = areas
        lm[: light_idx.size] = True

        s = len(self._sph_to_world)
        stw = np.zeros((max(s, 1), 3, 4))
        stl = np.zeros((max(s, 1), 3, 4))
        smat = np.zeros((max(s, 1),), np.int64)
        stw[:, :, :3] = np.eye(3)
        stl[:, :, :3] = np.eye(3)
        for i, m in enumerate(self._sph_to_world):
            stw[i] = m
            rinv = np.linalg.inv(m[:, :3])
            stl[i, :, :3] = rinv
            stl[i, :, 3] = -rinv @ m[:, 3]
            smat[i] = self._sph_mats[i]
        if s == 0:
            # a sphere at infinity, never hit: both translations push it away
            # (rays are intersected in local space)
            stw[:, :, 3] = 1e30
            stl[:, :, 3] = 1e30

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype).to(device)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(device)

        return Scene(
            tri_p0=f(p0), tri_e1=f(e1), tri_e2=f(e2), tri_normal=f(nrm), tri_mat=i(mats),
            sph_to_world=f(stw), sph_to_local=f(stl), sph_mat=i(smat),
            materials=mat_mod.MaterialTable(
                kind=i(self._kinds), albedo=f(self._albedo), ior=f(self._ior), emission=f(emission),
                albedo_tex=i(self._albedo_tex), emission_tex=i(self._emission_tex),
                textures=f(self._packed_textures()),
                tex_hw=i([[t.shape[0], t.shape[1]] for t in self._textures]),
            ),
            light_tri=i(li), light_area=f(la), light_mask=torch.as_tensor(lm).to(device),
        )


def inject_mesh(scene: Scene, vertices: torch.Tensor, valid: torch.Tensor, material: int) -> Scene:
    """Append a device-resident triangle soup to a scene: `vertices` (T, 3, 3)
    (e.g. ``MeshBuffers.vertices``), `valid` (T,) bool. Invalid rows get the
    null material and a zero area; degenerate rows keep the builder's unit-Y
    padding normal. The mesh is taken as non-emissive, so the light list is
    unchanged; the scene's accelerator is dropped (it indexes the old
    triangle array)."""
    p0 = vertices[:, 0]
    e1 = vertices[:, 1] - vertices[:, 0]
    e2 = vertices[:, 2] - vertices[:, 0]
    cr = torch.linalg.cross(e1, e2)
    ok = torch.sum(cr * cr, dim=-1, keepdim=True) > 1e-20
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=cr.dtype, device=cr.device)
    unit_y = torch.tensor([0.0, 1.0, 0.0], dtype=cr.dtype, device=cr.device)
    safe = torch.where(ok, cr, unit_x)
    ln = torch.linalg.norm(safe, dim=-1, keepdim=True)
    nrm = torch.where(ok, safe / torch.clamp(ln, min=1e-30), unit_y)
    validf = valid[:, None].to(p0.dtype)
    mats = torch.where(valid, torch.full_like(valid, material, dtype=torch.int64),
                       torch.zeros_like(valid, dtype=torch.int64))
    return scene._replace(
        tri_p0=torch.cat([scene.tri_p0, p0 * validf]),
        tri_e1=torch.cat([scene.tri_e1, e1 * validf]),
        tri_e2=torch.cat([scene.tri_e2, e2 * validf]),
        tri_normal=torch.cat([scene.tri_normal, torch.where(valid[:, None], nrm, unit_y)]),
        tri_mat=torch.cat([scene.tri_mat, mats]),
        accel=None,
    )


# unit geometry factories

def unit_plane():
    """y = 0 quad spanning [-0.5, 0.5]^2 in xz, +y normal."""
    pos = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]])
    idx = np.array([0, 1, 2, 0, 2, 3])
    return pos, idx


def unit_box():
    pos = np.array(
        [
            [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
            [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
        ]
    )
    idx = np.array(
        [
            0, 3, 1, 3, 2, 1,
            1, 2, 5, 2, 6, 5,
            5, 6, 4, 6, 7, 4,
            4, 7, 0, 7, 3, 0,
            3, 7, 2, 7, 6, 2,
            4, 0, 5, 0, 1, 5,
        ]
    )
    return pos, idx
