"""The PyTorch port stands alone (no JAX import), runs the default
simulation options, refuses what it has not ported instead of skipping it,
and dispatches its kernels by device."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from libfluid_tpu_torch import sim
from libfluid_tpu_torch.config import MesherConfig, SimConfig, SolverConfig, TransferScheme
from libfluid_tpu_torch.mesher import generate_mesh, sample_surface
from libfluid_tpu_torch.sim import correction, kernels, multigrid, slotsort, sources, transfers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import libfluid_tpu_torch, libfluid_tpu_torch.sim, libfluid_tpu_torch.convert\n"
        "from libfluid_tpu_torch.sim import slotsort, transfers, multigrid, pressure, step\n"
        "from libfluid_tpu_torch.sim import correction, collisions, sources, jitterhash\n"
        "import libfluid_tpu_torch.mesher, libfluid_tpu_torch.io, libfluid_tpu_torch.testbed\n"
        "import libfluid_tpu_torch.testbed.__main__, libfluid_tpu_torch.math, libfluid_tpu_torch.io.ppm\n"
        "import libfluid_tpu_torch.renderer\n"
        "from libfluid_tpu_torch.renderer import (accel, bdpt, camera, draws, intersect, loops, materials,\n"
        "    pathtrace, render, scene, scenes)\n"
        "from libfluid_tpu_torch import cache, checkpoint, dcc, native, profiling, voxelizer\n"
        "from libfluid_tpu_torch.sim import bigstep, binning, slots\n"
        "import libfluid_tpu_torch.parallel\n"
        "from libfluid_tpu_torch.parallel import distributed, halo, mesh, shard, zshard\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def _cfg(**kw):
    base = dict(
        grid_size=(8, 8, 8), particle_capacity=512, gravity=(0.0, -10.0, 0.0),
        enable_position_correction=False, has_obstacles=False,
    )
    base.update(kw)
    return SimConfig(**base)


def _state(cfg):
    state = sim.new_state(cfg, "cpu")
    return sim.seed_box(state, cfg, (1.0, 1.0, 1.0), (3.0, 3.0, 3.0))


@pytest.mark.parametrize(
    "change",
    [
        dict(scheme=TransferScheme.FLIP),
        dict(solver=SolverConfig(preconditioner_dtype="bfloat16")),
    ],
    ids=["flip", "mg16"],
)
def test_unported_options_raise(change):
    """FLIP and the bfloat16 V-cycle, once refused, now run (tests/
    test_torch_flip.py holds them against the JAX package); so does the
    fluid render scene, once refused: the state's mesh becomes a scene."""
    from libfluid_tpu_torch import testbed

    cfg = dataclasses.replace(_cfg(), **change)
    state, diag = sim.substep(_state(cfg), cfg, 0.01)
    assert bool(torch.isfinite(state.velocity).all())
    assert float(diag.pressure_residual) < cfg.solver.tolerance
    mesh = generate_mesh(state.position, state.active, MesherConfig(grid_size=(16, 16, 16)))
    scene, cam = testbed.fluid_render_scene(mesh, cfg, 0, device="cpu")
    assert scene.tri_p0.shape[0] == int(mesh.count) + 14 and scene.device == cam.device == torch.device("cpu")


def test_default_options_run():
    """The default SimConfig options (position correction, obstacles) with
    a source run substep and step, and the state meshes."""
    cfg = SimConfig(grid_size=(8, 8, 8), particle_capacity=512)
    assert cfg.enable_position_correction and cfg.has_obstacles
    state = _state(cfg)._replace(sources=sources.make_source_set([[6, 6, 6]], (0.0, -5.0, 0.0), device="cpu"))
    n0 = int(state.active.sum())
    state, diag = sim.substep(state, cfg, 0.01)
    state, diag = sim.step(state, cfg, 0.02)
    assert int(diag.particle_count) > n0 and int(diag.correction_uncorrected) == 0
    mesh = generate_mesh(state.position, state.active, MesherConfig(grid_size=(16, 16, 16)))
    assert int(mesh.count) > 0


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions and count no launch; a tensor on
    a device with neither kernel nor plain version raises."""
    cfg = _cfg()
    state = _state(cfg)
    kernels.reset_launches()
    sim.substep(state, cfg, 0.01)
    assert all(v == 0 for v in kernels.LAUNCHES.values())

    meta = torch.empty((16, 4), device="meta")
    with pytest.raises(RuntimeError):
        slotsort.expand(meta, torch.empty(4, dtype=torch.int32, device="meta"),
                        torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError):
        kernels.p2g_faces(torch.empty((16, 1, 8, 8, 8), device="meta"), cfg)
    lvl = multigrid.build_levels(torch.zeros((8, 8, 8), dtype=torch.int8, device="meta"))[0]
    x = torch.empty((8, 8, 8), device="meta")
    with pytest.raises(RuntimeError):
        multigrid.apply_level(lvl, x)
    g = state.grid
    with pytest.raises(RuntimeError):
        transfers.g2p_pic(g._replace(u=g.u.to("meta"), v=g.v.to("meta"), w=g.w.to("meta")),
                          state.position.to("meta"), cfg)
    with pytest.raises(ValueError):  # mixed devices
        transfers.g2p_pic(g, state.position.to("meta"), cfg)
    pos = torch.empty((3, 4, 8, 8, 8), device="meta")
    with pytest.raises(RuntimeError):
        correction._springs(pos, pos[0], 1, (0, 0, 0), 0.5, cfg)
    with pytest.raises(ValueError):
        kernels.correction_springs(torch.zeros(pos.shape), torch.zeros(pos.shape[1:]), 0.5, 1)
    with pytest.raises(RuntimeError):
        sample_surface(torch.empty((4, 3), device="meta"),
                       torch.empty(4, dtype=torch.bool, device="meta"), MesherConfig())


@pytest.mark.parametrize("name", ["p2g_bwd", "correction_bwd", "surface_bwd"])
def test_backward_on_the_card_launches_its_kernel_or_raises(name, monkeypatch):
    """On a CUDA tensor every backward launches its kernel, and a launch that
    fails raises: nothing falls back to the plain version. Without a card the
    dispatch is made to see CUDA tensors and the launches are recorded; the
    forward kernels' launches do nothing (their outputs stay unset), the
    backward kernel's launch fails as it would without a card."""
    from libfluid_tpu_torch.mesher import surface

    launched = []

    def launch(kernel, entry, *args):
        launched.append(kernel)
        if kernel == name:
            raise RuntimeError(f"{kernel} kernel ({entry}) failed: no card")

    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(kernels, "launch", launch)
    cfg = _cfg()
    if name == "p2g_bwd":
        leaf = torch.rand((16, 2, 8, 8, 8)).requires_grad_()
        num, den = kernels.p2g_faces(leaf, cfg)
        out = sum(t.sum() for t in (*num, *den))
    elif name == "correction_bwd":
        leaf = torch.rand((3, 2, 8, 8, 8)).requires_grad_()
        out = correction._springs(leaf, torch.ones((2, 8, 8, 8)), 1, (0, 0, 0), 0.5, cfg).sum()
    else:
        leaf = (torch.rand((40, 3)) * 4.0).requires_grad_()
        out = surface.sample_surface(leaf, torch.ones(40, dtype=torch.bool),
                                     MesherConfig(grid_size=(8, 8, 8))).sum()
    forward = list(launched)
    assert forward and name not in forward
    with pytest.raises(RuntimeError, match=name):
        torch.autograd.grad(out, leaf)
    assert launched[-1] == name


@pytest.mark.parametrize("mode", ["grad", "no_grad", "no_leaf"])
def test_mesh_gradient_launches_the_keep_form_then_surface_bwd_alone(mode, monkeypatch):
    """On "CUDA" tensors a forward whose positions want a gradient launches
    kernel F in the form that keeps the node sums (``surface_keep``), and
    its backward launches ``surface_bwd`` alone: no second node pass. A
    forward under ``no_grad``, or on positions that want no gradient,
    launches the plain ``surface`` and keeps nothing."""
    from libfluid_tpu_torch.mesher import surface

    launched = []
    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(kernels, "launch", lambda kernel, entry, *args: launched.append(kernel))
    pos = torch.rand((40, 3)) * 4.0
    leaf = pos.clone().requires_grad_(mode != "no_leaf")
    act = torch.ones(40, dtype=torch.bool)
    mcfg = MesherConfig(grid_size=(8, 8, 8))
    with torch.set_grad_enabled(mode != "no_grad"):
        out = surface.sample_surface(leaf, act, mcfg)
    if mode != "grad":
        assert launched == ["surface"] and not out.requires_grad
        return
    assert launched == ["surface_keep"]
    torch.autograd.grad(out.sum(), leaf)
    assert launched == ["surface_keep", "surface_bwd"]


def test_backward_wrappers_refuse_cpu_tensors():
    """The backward kernels' wrappers take CUDA tensors only: the dispatch to
    the plain versions is made by the autograd functions above them."""
    from libfluid_tpu_torch.mesher import surface

    cfg = _cfg()
    data = torch.zeros((16, 2, 8, 8, 8))
    faces = [torch.zeros(sh) for sh in kernels.face_shapes(cfg)]
    with pytest.raises(ValueError):
        kernels.p2g_faces_bwd(data, faces, faces, cfg)
    with pytest.raises(ValueError):
        kernels.correction_springs_bwd(data[:3], data[3], data[:3], 0.5, 1)
    mcfg = MesherConfig(grid_size=(8, 8, 8))
    binned = surface.bin_particles(torch.rand((10, 3)), torch.ones(10, dtype=torch.bool), mcfg)
    sums = torch.zeros((9, 9, 9, 4))
    with pytest.raises(ValueError):
        surface.sample_surface_bwd(binned, sums, torch.zeros((9, 9, 9)), mcfg)
    with pytest.raises(ValueError):
        surface.surface_bwd_gather(binned, sums, torch.zeros((9, 9, 9)), mcfg)


def _constructors():
    """name -> constructor taking only `device`, one per constructor that
    allocates the port's tensors."""
    import numpy as np

    import importlib

    from libfluid_tpu_torch import convert, dcc, grids, testbed, voxelizer
    from libfluid_tpu_torch.mesher.marching_cubes import MeshBuffers
    from libfluid_tpu_torch.config import RenderConfig
    from libfluid_tpu_torch.renderer import Camera, accel, scenes
    from libfluid_tpu_torch.sim import jitterhash, state as state_mod

    render_mod = importlib.import_module("libfluid_tpu_torch.renderer.render")

    class _OnDevice:
        """A CPU scene or camera, moved to the constructor's device where
        there is one (None without a card stays on the CPU: the constructor
        under test is the one that must raise)."""

        def __init__(self, thing):
            self.thing = thing

        def to_device(self, device):
            if device is None and not torch.cuda.is_available():
                return self.thing
            dev = torch.device(device or "cuda")
            return type(self.thing)(*(_move(a, dev) for a in self.thing))

    def _evaluated(node):
        node.evaluate()
        return node

    def _move(a, dev):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        if isinstance(a, tuple):
            return type(a)(*(_move(x, dev) for x in a))
        return a

    builder, cam = scenes.cornell_box_one_light(1.0, device="cpu")
    cornell, camera = _OnDevice(builder.finish(device="cpu")), _OnDevice(cam)

    cfg = _cfg()
    arrays = convert.state_to_numpy(sim.new_state(cfg, "cpu"))
    return {
        "new_state": lambda device: sim.new_state(cfg, device).position,
        "empty_sources": lambda device: state_mod.empty_sources(device).cells,
        "grids.zeros": lambda device: grids.zeros(cfg, device).u,
        "state_from_numpy": lambda device: convert.state_from_numpy(arrays, cfg, device).position,
        "build_setup": lambda device: testbed.build_setup(
            4, testbed.default_config(4, capacity=1 << 12), device=device)[1].sources.cells,
        "make_source_set": lambda device: sources.make_source_set(
            np.array([[1, 2, 3]]), (0.0, 1.0, 0.0), device=device).cells,
        "jitter_field": lambda device: jitterhash.jitter_field(
            7, 2, (3, 3, 3), (0, 0, 0), torch.float32, device),
        "SceneBuilder.finish": lambda device: scenes.cornell_box_one_light(
            1.0, device="cpu")[0].finish(device=device).tri_p0,
        "Camera.from_parameters": lambda device: Camera.from_parameters(
            (0, 0, -5), (0, 0, 0), (0, 1, 0), 0.5, 1.0, device=device).position,
        "accel.build": lambda device: accel.build(cornell.to_device(device), res=(4, 4, 4),
                                                  device=device).dist,
        "render": lambda device: render_mod.render(
            cornell.to_device(device), camera.to_device(device),
            RenderConfig(width=2, height=2, samples_per_pixel=1, ray_batch=4),
            torch.Generator().manual_seed(0), device=device),
        "render bdpt": lambda device: render_mod.render(
            cornell.to_device(device), camera.to_device(device),
            RenderConfig(width=2, height=2, samples_per_pixel=1, ray_batch=4, algorithm="bdpt",
                         max_camera_bounces=2, max_light_bounces=2),
            torch.Generator().manual_seed(0), device=device),
        "fluid_render_scene": lambda device: testbed.fluid_render_scene(
            MeshBuffers(torch.zeros((4, 3, 3)), torch.tensor(0)), cfg, 0, device=device)[0].tri_p0,
        "voxelize": lambda device: voxelizer.voxelize(
            np.eye(3), np.array([0, 1, 2]), 1.0, device=device).surface,
        "GridNode": lambda device: _evaluated(dcc.GridNode(grid_size=(8, 8, 8), particle_capacity=64,
                                                           device=device)).state.position,
    }


@pytest.mark.parametrize("name", [
    "new_state", "empty_sources", "grids.zeros", "state_from_numpy", "build_setup",
    "make_source_set", "jitter_field", "SceneBuilder.finish", "Camera.from_parameters",
    "accel.build", "render", "render bdpt", "fluid_render_scene", "voxelize", "GridNode",
])
def test_constructors_default_to_the_card(name):
    """``device=None`` is the CUDA card and never the CPU: without a card it
    raises a RuntimeError that names the argument; ``"cpu"`` builds on the
    CPU."""
    make = _constructors()[name]
    assert make("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=None"):
            make(None)


@pytest.fixture
def one_rank_gloo(tmp_path):
    """A gloo group of one rank in this process, torn down after the test."""
    import torch.distributed as dist

    from libfluid_tpu_torch.parallel import distributed

    distributed.init_distributed(backend="gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                                 num_processes=1, process_id=0, timeout=30)
    yield
    dist.destroy_process_group()


def test_parallel_and_tiled_paths_default_to_the_card(one_rank_gloo):
    """The slab-tiled substep runs where its state lies and the state's
    constructor defaults to the card; a mesh (and so ``zshard_state``'s
    share) defaults to the card too, and a CUDA mesh on a gloo group raises
    instead of moving the tensors to the CPU."""
    from libfluid_tpu_torch.parallel import make_mesh, zshard
    from libfluid_tpu_torch.sim import bigstep

    cfg = _cfg(grid_size=(8, 8, 8))
    state, diag = bigstep.substep_tiled(_state(cfg), cfg, 0.01, 2)
    assert state.position.device.type == "cpu" and int(diag.particle_count) > 0
    share = zshard.zshard_state(_state(cfg), cfg, make_mesh(device="cpu"))
    assert share.position.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=None"):
            make_mesh()
        with pytest.raises(RuntimeError, match="device=None"):
            bigstep.substep_tiled(_state_on(cfg, None), cfg, 0.01, 2)
    with pytest.raises(RuntimeError, match="nccl"):
        make_mesh(device=torch.device("cuda", 0))


def _state_on(cfg, device):
    return sim.seed_box(sim.new_state(cfg, device), cfg, (1.0, 1.0, 1.0), (3.0, 3.0, 3.0))


def test_init_distributed_refuses_nccl_without_a_card(monkeypatch):
    """NCCL is the default backend; without a CUDA card (or an NCCL build)
    it raises and never falls back to gloo."""
    import torch.distributed as dist

    from libfluid_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        distributed.init_distributed("127.0.0.1:29511", 1, 0)
    assert not dist.is_initialized()
