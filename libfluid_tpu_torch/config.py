"""Frozen configuration dataclasses (PyTorch port of ``libfluid_tpu.config``).

Field names and defaults are those of the JAX package, so a configuration
carries over field by field (:func:`libfluid_tpu_torch.convert.config_from_fields`).
Only ``dtype`` changes type: it is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """The device a constructor builds on: the CUDA card unless the caller
    names another (``device="cpu"``, as the tests do). ``device=None`` never
    falls back to the CPU: without a card it raises. A CUDA device comes
    back with its index (``cuda`` is the current card), so that it compares
    equal to a tensor's device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None selects the CUDA card, but torch.cuda.is_available() is False; "
                'pass device="cpu" to build on the CPU'
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class TransferScheme(enum.Enum):
    """Particle<->grid transfer scheme."""

    PIC = "pic"
    FLIP = "flip_blend"
    APIC = "apic"


class CellType:
    """Cell-content markers, stored as an int8 grid; out-of-bounds lookups
    behave as SOLID."""

    AIR = 0
    FLUID = 1
    SOLID = 2


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pressure-solver tunables."""

    tolerance: float = 1e-6  # max-norm residual threshold
    max_iterations: int = 200
    preconditioner: str = "mg"  # "mg" (geometric V-cycle) or "jacobi"
    preconditioner_dtype: str = "float32"  # "bfloat16": the "mg16" per-pass V-cycle


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation tunables; see ``libfluid_tpu.config.SimConfig`` for the
    meaning of each field."""

    grid_size: Tuple[int, int, int] = (50, 50, 50)
    cell_size: float = 1.0
    grid_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gravity: Tuple[float, float, float] = (0.0, -981.0, 0.0)

    particle_capacity: int = 1 << 17

    scheme: TransferScheme = TransferScheme.APIC
    blending_factor: float = 1.0
    cfl_number: float = 3.0
    density: float = 1.0
    boundary_skin_width: float = 0.1
    correction_stiffness: float = 5.0
    velocity_extrapolation_iterations: int = 3
    seeding_density: int = 2

    enable_position_correction: bool = True
    enable_collisions: bool = True
    max_neighbors_per_cell: int = 12
    p2g_overflow_capacity: int = 4096
    correction_capacity: int = 12
    correction_overflow_capacity: int = 4096
    exchange_capacity: int = 0
    has_obstacles: bool = True

    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    dtype: torch.dtype = torch.float32

    @property
    def nx(self) -> int:
        return self.grid_size[0]

    @property
    def ny(self) -> int:
        return self.grid_size[1]

    @property
    def nz(self) -> int:
        return self.grid_size[2]

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def domain_min(self) -> Tuple[float, float, float]:
        return self.grid_offset

    @property
    def domain_max(self) -> Tuple[float, float, float]:
        ox, oy, oz = self.grid_offset
        return (
            ox + self.nx * self.cell_size,
            oy + self.ny * self.cell_size,
            oz + self.nz * self.cell_size,
        )


@dataclasses.dataclass(frozen=True)
class MesherConfig:
    """Surface mesher tunables; see ``libfluid_tpu.config.MesherConfig``."""

    grid_size: Tuple[int, int, int] = (64, 64, 64)
    cell_size: float = 0.5
    grid_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    particle_extent: float = 2.0  # kernel support radius, world units
    particle_radius: float = 0.5  # average-radius contribution per particle
    max_triangles: int = 1 << 18  # output capacity of marching cubes


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer tunables; see ``libfluid_tpu.config.RenderConfig``."""

    width: int = 256
    height: int = 256
    samples_per_pixel: int = 16
    algorithm: str = "pt"  # "pt" (naive forward); "bdpt" is not ported yet
    max_bounces: int = 5
    max_camera_bounces: int = 6
    max_light_bounces: int = 6
    ray_batch: int = 1 << 15  # rays traced per strip of the fixed-count tracer
    # Russian roulette from this bounce on (>= max_bounces disables it)
    rr_start: int = 3
    rr_floor: float = 0.05
    # the fixed-count bounce tracer (reverse-differentiable in JAX); False
    # selects the persistent early-exit tracers
    differentiable: bool = True
