"""The system under test: the entry points of ``libfluid_tpu_torch`` that the
frame actions drive, behind one small interface that the reference's
lower-precision control (:mod:`portbench.reference.control`) mirrors.

A configuration file's groups ("sim", "solver", "mesher", "render",
"scene") are read here into the port's own config objects. Its particles
come from ``"seed_boxes"``, a list of boxes ``{"start", "size"}`` seeded in
order, or from ``"seed_box"``, one such box; the jitter of all of them is
drawn from one generator of the seed.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch


def seed_boxes(conf: dict) -> list:
    """The configuration's seed boxes, in the order they are seeded."""
    if "seed_boxes" in conf and "seed_box" in conf:
        raise ValueError('a configuration gives "seed_boxes" or "seed_box", not both')
    return conf["seed_boxes"] if "seed_boxes" in conf else [conf["seed_box"]]


def fields(group: dict) -> dict:
    """A config object's keyword arguments from a group of a configuration
    file (lists as tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items()}


class Program:
    """``libfluid_tpu_torch`` on `device`. On a CUDA device the constructor
    loads (and on a checkout's first run builds) the kernel library."""

    def __init__(self, device):
        def mod(name):  # by its path: a package may export a function of the same name
            return importlib.import_module(f"libfluid_tpu_torch.{name}")

        config_mod, sim, marching_cubes = mod("config"), mod("sim"), mod("mesher.marching_cubes")
        accel, loops, pathtrace = mod("renderer.accel"), mod("renderer.loops"), mod("renderer.pathtrace")
        scene, scenes, kernels = mod("renderer.scene"), mod("renderer.scenes"), mod("sim.kernels")
        self.device = torch.device(device)
        self._config, self._sim, self._mc = config_mod, sim, marching_cubes
        self._accel, self._loops, self._pathtrace = accel, loops, pathtrace
        self._scene, self._scenes, self._kernels = scene, scenes, kernels
        if self.device.type == "cuda":
            from libfluid_tpu_torch import _build

            _build.load()

    # -- configuration and state -------------------------------------------

    def sim_config(self, conf: dict):
        c = self._config
        sim = fields(conf["sim"])
        sim["scheme"] = c.TransferScheme(sim["scheme"])
        return c.SimConfig(**sim, solver=c.SolverConfig(**conf["solver"]))

    def mesher_config(self, conf: dict):
        return self._config.MesherConfig(**fields(conf["mesher"]))

    def render_config(self, conf: dict):
        return self._config.RenderConfig(**conf["render"])

    def seeded_state(self, cfg, conf: dict, seed: int):
        """The configuration's seed boxes in order, their jitter (one
        generator for all) and the substeps' draws from `seed`."""
        state = self._sim.new_state(cfg, self.device, generator=seed)
        rng = np.random.default_rng(seed)
        for box in seed_boxes(conf):
            state = self._sim.seed_box(state, cfg, tuple(box["start"]), tuple(box["size"]), rng=rng)
        return state

    # -- the frame's stages -------------------------------------------------

    def step(self, state, cfg, dt):
        return self._sim.step(state, cfg, dt)

    def mesh(self, state, mcfg):
        return self._mc.generate_mesh(state.position, state.active, mcfg)

    def base_scene(self, conf: dict):
        """The fluid box around the domain with the water's material: (the
        scene without the water, its camera, the water's material)."""
        sc = conf["scene"]
        b, cam = self._scenes.fluid_box(tuple(sc["domain_min"]), tuple(sc["domain_max"]),
                                        device=self.device)
        water = b.lambertian(tuple(sc["water_albedo"]))
        return b.finish(device=self.device), cam, water

    def scene(self, scene0, mesh, water, accel_res):
        s = self._scene.inject_mesh(scene0, mesh.vertices, mesh.valid, water)
        return s._replace(accel=self._accel.build(s, res=tuple(accel_res), device=self.device))

    def render(self, scene, cam, rcfg, seed: int):
        """(the image, the rays cast): the persistent tracer, the megakernel
        where the scene has an accelerator, its radiance sum over the
        samples divided by their number."""
        img, cast = self._pathtrace.trace_persistent(scene, cam, rcfg, torch.Generator().manual_seed(seed),
                                                     with_stats=True)
        return img / rcfg.samples_per_pixel, cast

    # -- counters -----------------------------------------------------------

    def launches(self) -> dict:
        return dict(self._kernels.LAUNCHES)

    def host_reads(self) -> int:
        return self._loops.HOST_READS["count"]

    @contextlib.contextmanager
    def launch_hook(self, hook):
        """Call ``hook(name, args)`` before every kernel launch while open."""
        kernels = self._kernels
        launch = kernels.launch

        def hooked(name, entry, *args):
            hook(name, args)
            return launch(name, entry, *args)

        kernels.launch = hooked
        try:
            yield
        finally:
            kernels.launch = launch
