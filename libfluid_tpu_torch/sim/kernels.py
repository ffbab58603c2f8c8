"""Dispatch to the hand-written CUDA kernels, and the P2G kernel's wrapper.

Four kernels carry the substep (sources in ``libfluid_tpu_torch/csrc``):

    "expand"   slotsort.expand      slot-grid expand     (csrc/expand.cu)
    "p2g"      kernels.p2g_faces    P2G face sums        (csrc/p2g.cu)
    "stencil"  multigrid.stencil    Poisson stencil      (csrc/stencil.cu)
    "g2p"      transfers.g2p_pic    G2P                  (csrc/g2p.cu)

Every wrapper dispatches on the device of its tensors: a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor launches the kernel (or
raises), any other device raises. There is no fallback from a failed build
or launch to the plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from libfluid_tpu_torch import _build
from libfluid_tpu_torch.config import SimConfig, TransferScheme

# Kernel launches since the last reset; a wrapper adds one where it launches.
LAUNCHES = {"expand": 0, "p2g": 0, "stencil": 0, "g2p": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raises for mixed or other devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[t.device for t in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {dev}")


def check(t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int], name: str) -> None:
    """Raise unless `t` has the dtype, shape and contiguity a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")


def launch(name: str, entry: str, *args) -> None:
    """Call C entry point `entry` on the current stream; tensors are passed
    as device pointers. Raises on a CUDA error, else counts the launch."""
    fn = getattr(_build.load(), entry)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel ({entry}) failed: CUDA error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Kernel B: P2G
# ---------------------------------------------------------------------------


def p2g_faces(data: torch.Tensor, cfg: SimConfig) -> Tuple[tuple, tuple]:
    """UNNORMALIZED face accumulators ((num_u, num_v, num_w), (den_u, den_v,
    den_w)) of the slot payload (16, K, nx, ny, nz), every face included.

    Replaces ``libfluid_tpu/sim/kernels.py:p2g_lo_faces_pallas`` (with
    ``transfers._p2g_hi_plane``). CUDA: ``csrc/p2g.cu``; CPU: the plain
    ``transfers._p2g_slots_torch``.
    """
    from libfluid_tpu_torch.sim import transfers

    if not use_kernel(data):
        return transfers._p2g_slots_torch(data, cfg)
    nx, ny, nz = cfg.grid_size
    k = data.shape[1]
    check(data, torch.float32, (16, k, nx, ny, nz), "slot payload")
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    num = [torch.empty(s, dtype=torch.float32, device=data.device) for s in shapes]
    den = [torch.empty(s, dtype=torch.float32, device=data.device) for s in shapes]
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    launch(
        "p2g", "lf_p2g", data, *num, *den, k, nx, ny, nz,
        float(cfg.cell_size), ox, oy, oz, int(cfg.scheme == TransferScheme.APIC),
    )
    return tuple(num), tuple(den)
