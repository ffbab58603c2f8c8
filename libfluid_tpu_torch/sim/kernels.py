"""Dispatch to the hand-written CUDA kernels, and the wrappers of the P2G
and correction kernels.

Twenty-two kernels carry the substep, the mesher and the gradients of both
(sources in ``libfluid_tpu_torch/csrc``):

    "expand"      slotsort.expand         slot-grid expand     (csrc/expand.cu)
    "p2g"         kernels.p2g_faces       P2G face sums        (csrc/p2g.cu)
    "p2g_overflow", "p2g_normalize"
                  kernels.p2g_overflow    P2G's overflow rows and the
                                          normalisation  (csrc/p2g_overflow.cu)
    "p2g_bwd"     kernels.p2g_faces_bwd   adjoint of P2G       (csrc/p2g_bwd.cu)
    "stencil"     multigrid.stencil       Poisson stencil      (csrc/stencil.cu)
    "stencil16"   multigrid.stencil       the same in bf16     (csrc/stencil.cu)
    "mg_pre"      multigrid.pre_smooth    V-cycle pre-sweeps   (csrc/vcycle.cu)
    "mg_restrict" multigrid.restrict_residual  residual + R    (csrc/vcycle.cu)
    "mg_up"       multigrid.prolong_smooth     P + post-sweeps (csrc/vcycle.cu)
    "mg_coarse"   multigrid.coarse_cycle  small levels' cycle  (csrc/vcycle.cu)
    "mg16_pre", "mg16_restrict", "mg16_up", "mg16_coarse"
                  the same four in bf16, the "mg16" cycle      (csrc/vcycle.cu)
    "g2p"         transfers.g2p_pic       G2P                  (csrc/g2p.cu)
    "g2p_bwd"     transfers.g2p_bwd       adjoint of G2P       (csrc/g2p_bwd.cu)
    "correction"  correction._springs     correction springs   (csrc/correction.cu)
    "correction_bwd"  kernels.correction_springs_bwd  their VJP  (csrc/correction_bwd.cu)
    "surface"     surface.sample_surface  mesher node pass     (csrc/surface.cu)
    "surface_keep"  surface.sample_surface  the same, node sums kept for F'  (csrc/surface.cu)
    "surface_bwd"   surface.sample_surface_bwd  its VJP        (csrc/surface_bwd.cu)

"p2g", "correction" and "surface" are tile kernels: a block brings what its
tile of lattice points, cells or nodes reaches into shared memory once (for
"p2g" and "surface" in chunks, so shared memory caps neither the slots a
cell nor the particles a bin) and tiles away from the fluid return at once.
Their backward kernels are gathers on tiles too, without atomics:
"p2g_bwd" fills the cotangent with zeros and then visits the occupied slots
of each tile of cells with the tile's face cotangents in shared memory;
"correction_bwd" stages the occupied slots of a tile of cells and its halo
with their cotangents, and a warp takes a cell: the neighbours' slots
within reach of the cell's (the others add exact zeros) over the lanes, the
cell's own slots' sums in registers, then a fixed tree over the lanes; "surface_keep" is "surface" that also writes
each node's sums (W, X) for a forward that wants a gradient, from which
"surface_bwd" forms each node's cotangent words as it stages the nodes in
reach of a tile of bins, then gathers them a thread a particle.
"p2g", "correction" and "correction_bwd" take any number of slots a cell (a
word of 32, or of 16 for "correction_bwd", at a time), "surface" and its
backward any support (the box's bin starts and nodes a run at a time where
shared memory runs out). "g2p" and "g2p_bwd" run a thread a particle
(any order of particles): per-axis weight tables, the 24 live face samples
of the 54 in reach, positions and results through shared memory; "g2p_bwd"
merges the face cotangents of a block's particles in a shared-memory box
where the slot order lets it, and adds the rest with global atomics.

Every wrapper dispatches on the device of its tensors: a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor launches the kernel (or
raises), any other device raises. There is no fallback from a failed build
or launch to the plain version, in forward or backward.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from libfluid_tpu_torch import _build
from libfluid_tpu_torch.config import SimConfig, TransferScheme

# Kernel launches since the last reset; a wrapper adds one where it launches.
LAUNCHES = {
    "expand": 0, "p2g": 0, "p2g_overflow": 0, "p2g_normalize": 0, "p2g_bwd": 0, "stencil": 0,
    "stencil16": 0, "mg_pre": 0, "mg_restrict": 0, "mg_up": 0, "mg_coarse": 0, "mg16_pre": 0,
    "mg16_restrict": 0, "mg16_up": 0, "mg16_coarse": 0, "g2p": 0, "g2p_bwd": 0, "correction": 0,
    "correction_bwd": 0, "surface": 0, "surface_keep": 0, "surface_bwd": 0,
}


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
    # None is a null pointer: an output the caller does not ask for
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel ({entry}) failed: CUDA error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Kernel B: P2G
# ---------------------------------------------------------------------------


def face_shapes(cfg: SimConfig):
    """Shapes of the u, v, w face arrays."""
    nx, ny, nz = cfg.grid_size
    return [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]


def _p2g_faces_cuda(data: torch.Tensor, cfg: SimConfig) -> Tuple[tuple, tuple]:
    nx, ny, nz = cfg.grid_size
    k = data.shape[1]
    check(data, torch.float32, (16, k, nx, ny, nz), "slot payload")
    num = [torch.empty(s, dtype=torch.float32, device=data.device) for s in face_shapes(cfg)]
    den = [torch.empty(s, dtype=torch.float32, device=data.device) for s in face_shapes(cfg)]
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    launch(
        "p2g", "lf_p2g", data, *num, *den, k, nx, ny, nz,
        float(cfg.cell_size), ox, oy, oz, int(cfg.scheme == TransferScheme.APIC),
    )
    return tuple(num), tuple(den)


def p2g_faces_bwd(data: torch.Tensor, gnum, gden, cfg: SimConfig) -> torch.Tensor:
    """Kernel B', the adjoint of kernel B on CUDA tensors: the cotangent of
    the slot payload (16, K, nx, ny, nz) from those of the six face arrays
    (rows: position 0-2, mask 3, velocity 4-6, affine 7-15). Empty slots
    get 0; the plain version's autograd gives their mask row a value, which
    expand's backward drops with the slot. Two launches behind one entry
    point: a zero fill of the cotangent, then a block per tile of cells that
    visits the tile's occupied slots with the face cotangents in its reach in
    shared memory. Gather form, no atomics: the same bits from run to run."""
    if not use_kernel(data, *gnum, *gden):
        raise ValueError(f"p2g_faces_bwd takes CUDA tensors, got {data.device}")
    nx, ny, nz = cfg.grid_size
    k = data.shape[1]
    check(data, torch.float32, (16, k, nx, ny, nz), "slot payload")
    gnum = [g.contiguous() for g in gnum]
    gden = [g.contiguous() for g in gden]
    for a, shape in enumerate(face_shapes(cfg)):
        check(gnum[a], torch.float32, shape, f"num cotangent {a}")
        check(gden[a], torch.float32, shape, f"den cotangent {a}")
    out = torch.empty_like(data)
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    launch(
        "p2g_bwd", "lf_p2g_bwd", data, *gnum, *gden, out, k, nx, ny, nz,
        float(cfg.cell_size), ox, oy, oz, int(cfg.scheme == TransferScheme.APIC),
    )
    return out


class _P2GFaces(torch.autograd.Function):
    """Kernel B and its adjoint B' on CUDA tensors; the plain version and its
    autograd (recomputed in backward, as ``transfers._p2g_bwd`` takes
    ``jax.vjp`` of its jnp oracle) on CPU tensors."""

    @staticmethod
    def forward(ctx, data, cfg):
        from libfluid_tpu_torch.sim import transfers

        ctx.cfg = cfg
        ctx.save_for_backward(data)
        if not use_kernel(data):
            num, den = transfers._p2g_slots_torch(data, cfg)
        else:
            num, den = _p2g_faces_cuda(data, cfg)
        return (*num, *den)

    @staticmethod
    def backward(ctx, *grads):
        from libfluid_tpu_torch.sim import transfers

        (data,) = ctx.saved_tensors
        if use_kernel(data):
            return p2g_faces_bwd(data, grads[:3], grads[3:], ctx.cfg), None
        with torch.enable_grad():
            leaf = data.detach().requires_grad_()
            num, den = transfers._p2g_slots_torch(leaf, ctx.cfg)
            (dd,) = torch.autograd.grad((*num, *den), leaf, grads)
        return dd, None


def p2g_faces(data: torch.Tensor, cfg: SimConfig) -> Tuple[tuple, tuple]:
    """UNNORMALIZED face accumulators ((num_u, num_v, num_w), (den_u, den_v,
    den_w)) of the slot payload (16, K, nx, ny, nz), every face included.

    Replaces ``libfluid_tpu/sim/kernels.py:p2g_lo_faces_pallas`` (with
    ``transfers._p2g_hi_plane``) and its ``custom_vjp``. CUDA:
    ``csrc/p2g.cu`` (one block per tile of lattice points with the occupied
    slots of its cells and their halo in shared memory, a chunk at a time,
    32 slots a cell at a time; the same bits from run to run), backward
    ``csrc/p2g_bwd.cu``; CPU: the plain ``transfers._p2g_slots_torch``.
    """
    out = _P2GFaces.apply(data, cfg)
    return tuple(out[:3]), tuple(out[3:])


# ---------------------------------------------------------------------------
# P2G's overflow merge and normalisation
# ---------------------------------------------------------------------------


def _p2g_overflow_cuda(num, den, position, velocity, affine, active, overflow, start, rows,
                       cfg: SimConfig):
    """Add the window's overflow rows to kernel B's sums `num`, `den` in
    place (launch "p2g_overflow"), then normalise them into new u, v, w
    (launch "p2g_normalize")."""
    from libfluid_tpu_torch.sim import transfers

    nx, ny, nz = cfg.grid_size
    n = position.shape[0]
    cap = transfers.overflow_window(cfg, n)
    use_affine = cfg.scheme == TransferScheme.APIC
    shapes = face_shapes(cfg)
    for a, shape in enumerate(shapes):
        check(num[a], torch.float32, shape, f"num {a}")
        check(den[a], torch.float32, shape, f"den {a}")
    check(position, torch.float32, (n, 3), "position")
    check(velocity, torch.float32, (n, 3), "velocity")
    if use_affine:
        check(affine, torch.float32, (n, 3, 3), "affine")
    check(active, torch.bool, (n,), "active")
    check(overflow, torch.bool, (n,), "overflow")
    if (start is None) == (rows is None):
        raise ValueError("p2g_overflow takes the window's start or its rows, one of the two")
    if start is not None:
        check(start, torch.int32, (), "overflow_start")
    else:
        check(rows, torch.int32, (cap,), "overflow rows")
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    launch(
        "p2g_overflow", "lf_p2g_overflow", start, rows, overflow, active, position, velocity,
        affine if use_affine else None, *num, *den, cap, n, nx, ny, nz, float(cfg.cell_size),
        ox, oy, oz, int(use_affine),
    )
    out = [torch.empty(s, dtype=torch.float32, device=position.device) for s in shapes]
    launch("p2g_normalize", "lf_p2g_normalize", *num, *den, *out, *(o.numel() for o in out))
    return tuple(out)


class _P2GOverflow(torch.autograd.Function):
    """The two launches of :func:`p2g_overflow`; the backward recomputes the
    plain merge (``transfers._merge_overflow``) and takes its autograd. With
    no input that wants a gradient, kernel B's sums are added to in place
    and nothing is saved; otherwise the kernels add to copies and B's sums
    are kept for the backward."""

    @staticmethod
    def forward(ctx, num_u, num_v, num_w, den_u, den_v, den_w, position, velocity, affine,
                active, overflow, start, rows, cfg):
        num, den = [num_u, num_v, num_w], [den_u, den_v, den_w]
        ctx.cfg = cfg
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*num, *den, position, velocity, affine, active, overflow, start,
                                  rows)
            num, den = [t.clone() for t in num], [t.clone() for t in den]
        return _p2g_overflow_cuda(num, den, position, velocity, affine, active, overflow, start,
                                  rows, cfg)

    @staticmethod
    def backward(ctx, *grads):
        from libfluid_tpu_torch.sim import transfers

        *inputs, active, overflow, start, rows = ctx.saved_tensors
        needs = ctx.needs_input_grad[: len(inputs)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
            num, den, position, velocity, affine = leaves[:3], leaves[3:6], *leaves[6:]
            idx = transfers._overflow_rows(overflow, position.shape[0], ctx.cfg, start, rows)
            out = transfers._merge_overflow(num, den, position, velocity, affine, active, idx,
                                            ctx.cfg)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grads, allow_unused=True))
        return (*(next(got) if t.requires_grad else None for t in leaves), None, None, None,
                None, None)


def p2g_overflow(num, den, position, velocity, affine, active, overflow, cfg: SimConfig,
                 start=None, rows=None):
    """The normalised (u, v, w) face arrays from kernel B's sums ``num``,
    ``den`` (:func:`p2g_faces`) and the particles past the slot capacity, on
    CUDA tensors: the window of ``transfers.overflow_window`` rows from
    ``start`` (slotsort's ``n_kept``, an int32 scalar on the card, read
    there) or the rows ``rows`` (int32, n where none), each added where it
    is flagged ``overflow`` and ``active``; then num / den where den > 1e-6,
    else 0. Differentiable in the sums, positions, velocities and affine
    matrices (the backward is the plain merge's autograd).

    Stands in for the overflow scatter and ``_normalize`` of
    ``libfluid_tpu/sim/transfers.py:p2g_slots``. CUDA:
    ``csrc/p2g_overflow.cu``, a thread per (row, axis, corner) adding to the
    sums with atomics (their last bits vary from run to run), then a thread
    per face; the host reads nothing and copies nothing to the card. CPU
    tensors take ``transfers._merge_overflow`` in ``transfers.p2g_slots``.
    """
    tensors = [*num, *den, position, velocity, affine, active, overflow]
    tensors += [t for t in (start, rows) if t is not None]
    if not use_kernel(*tensors):
        raise ValueError(f"p2g_overflow takes CUDA tensors, got {position.device}")
    return _P2GOverflow.apply(*num, *den, position.contiguous(), velocity.contiguous(),
                              affine.contiguous(), active, overflow, start, rows, cfg)


# ---------------------------------------------------------------------------
# Kernel E: position-correction springs
# ---------------------------------------------------------------------------


def correction_springs(
    res_pos: torch.Tensor, res_mask: torch.Tensor, re2: float, seed: int, origin=(0, 0, 0)
) -> torch.Tensor:
    """Per-slot correction springs (3, KC, nx, ny, nz) of the resident slots
    ``res_pos`` (3, KC, nx, ny, nz) and ``res_mask`` (KC, nx, ny, nz), CUDA
    tensors; ``correction._springs`` dispatches CPU tensors to the plain
    version.

    Replaces ``libfluid_tpu/sim/kernels.py:correction_springs_pallas``.
    CUDA: ``csrc/correction.cu``, one block per tile of cells with the
    tile's and its halo's occupied slots in shared memory, 32 slots a cell
    at a time. The slot grid's position and mask columns are contiguous when
    KC is the slot capacity; otherwise this takes one contiguous copy of
    each.
    """
    if not use_kernel(res_pos, res_mask):
        raise ValueError(f"correction_springs takes CUDA tensors, got {res_pos.device}")
    kc, nx, ny, nz = res_mask.shape
    res_pos = res_pos.contiguous()
    res_mask = res_mask.contiguous()
    check(res_pos, torch.float32, (3, kc, nx, ny, nz), "res_pos")
    check(res_mask, torch.float32, (kc, nx, ny, nz), "res_mask")
    out = torch.empty((3, kc, nx, ny, nz), dtype=torch.float32, device=res_pos.device)
    ox, oy, oz = (int(o) for o in origin)
    launch(
        "correction", "lf_correction", res_pos, res_mask, out, kc, nx, ny, nz,
        float(re2), int(seed), ox, oy, oz,
    )
    return out


def correction_springs_bwd(
    res_pos: torch.Tensor, res_mask: torch.Tensor, g: torch.Tensor, re2: float, seed: int,
    origin=(0, 0, 0), need_mask: bool = True,
):
    """Kernel E', the vector-Jacobian product of :func:`correction_springs`
    on CUDA tensors: the cotangents of ``res_pos`` (3, KC, nx, ny, nz) and,
    with `need_mask`, of ``res_mask`` (KC, nx, ny, nz), else None, from the
    springs' cotangent ``g`` (3, KC, nx, ny, nz). Empty slots get 0 in both:
    the plain version gives an empty slot's mask a value, which expand's
    backward drops with the slot (it writes back the valid slots only).

    Stands in for ``libfluid_tpu/sim/correction.py:_springs_bwd`` (``jax.vjp``
    of the jnp oracle around ``_correction_kernel``). CUDA:
    ``csrc/correction_bwd.cu``: a block per tile of cells stages the occupied
    slots of the tile and its halo with their cotangents, and a warp takes a
    cell: the neighbours' slots within reach of the cell's over the lanes,
    the cell's own in registers, a fixed tree over the lanes. A gather over
    the symmetric pair set, no atomics, 16 slots a cell staged at a time.
    """
    if not use_kernel(res_pos, res_mask, g):
        raise ValueError(f"correction_springs_bwd takes CUDA tensors, got {res_pos.device}")
    kc, nx, ny, nz = res_mask.shape
    res_pos = res_pos.contiguous()
    res_mask = res_mask.contiguous()
    g = g.contiguous()
    check(res_pos, torch.float32, (3, kc, nx, ny, nz), "res_pos")
    check(res_mask, torch.float32, (kc, nx, ny, nz), "res_mask")
    check(g, torch.float32, (3, kc, nx, ny, nz), "springs cotangent")
    d_pos = torch.empty_like(res_pos)
    d_mask = torch.empty_like(res_mask) if need_mask else None
    ox, oy, oz = (int(o) for o in origin)
    launch(
        "correction_bwd", "lf_correction_bwd", res_pos, res_mask, g, d_pos, d_mask, kc, nx, ny,
        nz, float(re2), int(seed), ox, oy, oz,
    )
    return d_pos, d_mask
