"""The comparisons that decide ``correct``: the reference takes the program's
state before a frame that the window ran, runs that frame itself, and
holds the program's answers to its own.

The reference follows the program frame by frame from the program's state:
a simulation of millions of particles is chaotic, so two runs from the
seed part after a few frames by rounding alone. A rendered frame's mesh is
made again from the program's state after the step, and its image from the
program's mesh, so that each stage is judged on its own inputs.

Every number is a gap that is 0 where the two agree; each cell's limits
(``portbench/limits/<cell>.json``) say which it compares:

- ``particles``: the active particles' counts, the difference (exact).
- ``position``: the distance, in cells, from each particle to the nearest
  particle of the other side, both ways, the largest; ``position_p99`` its
  99th percentile. The rows of the two states are in no common order (each
  substep sorts them by cell), so they are matched by position; a particle
  with none within the 27 cells around its own reads one cell.
- ``velocity_p99``, ``affine_p99``: the 99th percentile of the difference
  of a particle's velocity (APIC matrix) from its match's, over the
  reference's largest.
- ``faces_p99``, ``pressure_p99``: the 99th percentile of a grid field's
  difference where either side is not 0, over the reference's largest.
- ``mesh_p99``: as ``position_p99``, over the triangles' corners, in mesher
  cells.
- ``image``: the mean absolute difference of the pixels over the
  reference's mean.

The largest gaps other than ``position`` are not compared: cells that are
fluid on one side and air on the other make their tails swing from seed to
seed, and the lower-precision control does not separate them.
"""

from __future__ import annotations

import itertools

import torch

from portbench.reference import state_io
from portbench.reference.lf.mesher import marching_cubes
from portbench.reference.lf.renderer import accel as accel_mod
from portbench.reference.lf.renderer import pathtrace, scene as scene_mod, scenes
from portbench.reference.lf.sim import step as step_mod

_OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))


def nearest(query: torch.Tensor, points: torch.Tensor, h: float):
    """For each row of `query` (N, 3), the distance to the nearest row of
    `points` (M, 3) among those in the 27 cells of size `h` around its own,
    and that row's index; `h` and index 0 where there is none."""
    n, dev = query.shape[0], query.device
    if n == 0 or points.shape[0] == 0:
        return torch.full((n,), float(h), device=dev), torch.zeros((n,), dtype=torch.long, device=dev)
    lo = torch.minimum(query.amin(0), points.amin(0)) - h
    cq = torch.floor((query - lo) / h).long()
    cp = torch.floor((points - lo) / h).long()
    dims = torch.maximum(cq.amax(0), cp.amax(0)) + 2

    def key(c):
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]

    order = torch.argsort(key(cp))
    ks, ps = key(cp)[order], points[order]
    best = torch.full((n,), float("inf"), dtype=query.dtype, device=dev)
    arg = torch.zeros((n,), dtype=torch.long, device=dev)
    for off in _OFFSETS:
        kq = key(cq + torch.tensor(off, device=dev))
        start = torch.searchsorted(ks, kq)
        count = torch.searchsorted(ks, kq, right=True) - start
        for j in range(int(count.max())):
            rows = torch.nonzero(count > j).squeeze(1)
            idx = start[rows] + j
            d = torch.sum((query[rows] - ps[idx]) ** 2, dim=1)
            better = d < best[rows]
            best[rows] = torch.where(better, d, best[rows])
            arg[rows] = torch.where(better, idx, arg[rows])
    found = torch.isfinite(best)
    dist = torch.where(found, torch.sqrt(best), torch.full_like(best, float(h)))
    return dist, order[torch.where(found, arg, torch.zeros_like(arg))]


def _q(x: torch.Tensor, q: float) -> float:
    """The `q` quantile of `x` (nearest rank; 0 for no element)."""
    if x.numel() == 0:
        return 0.0
    x = torch.sort(x.reshape(-1).double()).values
    return float(x[min(int(q * x.numel()), x.numel() - 1)])


def _p99(err: torch.Tensor, scale: float) -> float:
    """The 99th percentile of `err` over `scale`."""
    return _q(err, 0.99) / (scale if scale > 0 else 1.0)


def _field_p99(got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`_p99` of a grid field's differences where either side is not
    0, over the reference's largest magnitude."""
    live = (got != 0) | (want != 0)
    return _p99((got - want).abs()[live], float(want.abs().max()))


def _matched(p_pos, r_pos, h):
    """The nearest-neighbour distances both ways in units of `h` (program to
    reference, reference to program) and the reference row matched to each
    program row."""
    d_pr, match = nearest(p_pos, r_pos, h)
    d_rp, _ = nearest(r_pos, p_pos, h)
    return d_pr / h, d_rp / h, match


class Reference:
    """The plain reference of one configuration on `device`."""

    def __init__(self, conf: dict, device):
        self.conf, self.device = conf, torch.device(device)
        self.cfg = state_io.sim_config(conf)

    def state(self, host):
        return state_io.from_host(host, self.device)

    def sim_frame(self, pre: dict, post: dict, dt: float) -> dict:
        """The program's state after a frame of `dt` seconds (`post`) against
        the reference's frame, ``step(state, cfg, dt)``, from the program's
        state before it (`pre`)."""
        with torch.no_grad():
            ref, _ = step_mod.step(self.state(pre), self.cfg, dt)
            prog = self.state(post)
            pa, ra = prog.active, ref.active
            out = {"particles": float(abs(int(pa.sum()) - int(ra.sum())))}
            d_pr, d_rp, match = _matched(prog.position[pa], ref.position[ra], self.cfg.cell_size)
            gaps = torch.cat([d_pr, d_rp])
            out["position"] = _q(gaps, 1.0)
            out["position_p99"] = _p99(gaps, 1.0)
            rv, rc = ref.velocity[ra], ref.affine[ra]
            out["velocity_p99"] = _p99(torch.linalg.norm(prog.velocity[pa] - rv[match], dim=-1),
                                       float(torch.linalg.norm(rv, dim=-1).max()))
            if self.cfg.scheme.value == "apic":
                out["affine_p99"] = _p99(torch.linalg.norm((prog.affine[pa] - rc[match]).flatten(1), dim=-1),
                                         float(torch.linalg.norm(rc.flatten(1), dim=-1).max()))
            out["faces_p99"] = max(_field_p99(getattr(prog.grid, a), getattr(ref.grid, a)) for a in "uvw")
            out["pressure_p99"] = _field_p99(prog.pressure, ref.pressure)
        return out

    def mesh(self, post: dict):
        """The reference's mesh of the program's state after the frame."""
        st = self.state(post)
        return marching_cubes.generate_mesh(st.position, st.active, state_io.mesher_config(self.conf))

    def mesh_frame(self, post: dict, mesh: dict) -> dict:
        """The program's mesh against the reference's of the same state."""
        mcfg = state_io.mesher_config(self.conf)
        with torch.no_grad():
            ref = self.mesh(post)
            n_ref, n_prog = int(ref.count), int(mesh["count"])
            verts = mesh["vertices"].to(self.device)
            d_pr, d_rp, _ = _matched(verts[:n_prog].reshape(-1, 3), ref.vertices[:n_ref].reshape(-1, 3),
                                     mcfg.cell_size)
        return {"mesh_p99": _p99(torch.cat([d_pr, d_rp]), 1.0)}

    def base_scene(self):
        """The fluid box around the domain: (the scene without the water,
        its camera, the water's material)."""
        sc = self.conf["scene"]
        b, cam = scenes.fluid_box(tuple(sc["domain_min"]), tuple(sc["domain_max"]), device=self.device)
        water = b.lambertian(tuple(sc["water_albedo"]))
        return b.finish(device=self.device), cam, water

    def scene(self, scene0, vertices, valid, water):
        """`scene0` with the water's triangles and its own accelerator."""
        s = scene_mod.inject_mesh(scene0, vertices, valid, water)
        return s._replace(accel=accel_mod.build(s, res=tuple(self.conf["scene"]["accel_res"]),
                                                device=self.device))

    def trace(self, scene, cam, seed: int):
        """(the image, the rays cast): the persistent tracer."""
        rcfg = state_io.render_config(self.conf)
        img, cast = pathtrace.trace_persistent(scene, cam, rcfg, torch.Generator().manual_seed(seed), True)
        return img / rcfg.samples_per_pixel, cast

    def render(self, mesh: dict, seed: int):
        """The reference's image and rays cast of the program's mesh."""
        scene0, cam, water = self.base_scene()
        verts = mesh["vertices"].to(self.device)
        valid = torch.arange(verts.shape[0], device=self.device) < int(mesh["count"])
        return self.trace(self.scene(scene0, verts, valid, water), cam, seed)

    def render_frame(self, mesh: dict, image: torch.Tensor, seed: int) -> dict:
        """The program's image of its mesh against the reference's."""
        with torch.no_grad():
            ref, _ = self.render(mesh, seed)
            diff = (image.to(self.device) - ref).abs()
            mean = float(ref.abs().mean())
        return {"image": float(diff.mean()) / mean if mean > 0 else float(diff.mean())}
