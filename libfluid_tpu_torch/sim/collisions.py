"""Particle/solid collision response (port of ``libfluid_tpu.sim.collisions``).

With obstacles, each particle marches a 3D DDA from its old position to its
new one, stops at the first solid (or out-of-bounds) cell, is pulled back a
skin width before the hit face and loses its remaining motion along that
axis; up to three rounds (one per axis) re-march the shortened segment. A
per-axis skin push-out from adjacent solid cells and the domain walls
follows. The JAX package runs this as jnp (no kernel), so plain PyTorch is
the port: the ``lax.while_loop`` becomes a Python loop over march steps
with a vectorized lane update and one host read per step for its exit test.
"""

from __future__ import annotations

import torch

from libfluid_tpu_torch.config import SimConfig

_BIG = 3.0e38


def _solid_at(solid: torch.Tensor, idx3: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Solid lookup with out-of-bounds = solid."""
    dims = torch.tensor(cfg.grid_size, dtype=torch.int32, device=idx3.device)
    inb = torch.all((idx3 >= 0) & (idx3 < dims), dim=-1)
    c = torch.minimum(torch.clamp(idx3, min=0), dims - 1).long()
    return torch.where(inb, solid[c[..., 0], c[..., 1], c[..., 2]], torch.ones_like(inb))


def _take(a: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """a[lane, dim[lane]] for (N, 3) `a`."""
    return torch.gather(a, 1, dim[:, None].long())[:, 0]


def _march_round(from_w, to_w, need, solid, cfg: SimConfig, max_steps: int):
    """One DDA sweep per lane in `need`; on a hit, the pull-back and axis
    cancellation. Returns (from', to', hit)."""
    h = cfg.cell_size
    dev = from_w.device
    off = torch.tensor(cfg.grid_offset, dtype=from_w.dtype, device=dev)
    skin = cfg.boundary_skin_width

    f = (from_w - off) / h
    tt = (to_w - off) / h
    from_cell = torch.floor(f).to(torch.int32)
    to_cell = torch.floor(tt).to(torch.int32)
    diff = tt - f
    pos_dir = diff > 0.0
    advance = torch.where(pos_dir, 1, -1).to(torch.int32)
    face_pos = pos_dir.to(f.dtype)
    big = torch.full_like(diff, _BIG)
    inv_abs = torch.where(torch.abs(diff) > 1e-30, 1.0 / torch.abs(diff), big)
    t = torch.abs(from_cell.to(f.dtype) + face_pos - f) * inv_abs  # (N, 3)

    n = from_w.shape[0]
    current = from_cell
    active = need & torch.any(from_cell != to_cell, dim=-1)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    hit_dim = torch.zeros((n,), dtype=torch.int32, device=dev)
    hit_t = torch.zeros((n,), dtype=from_w.dtype, device=dev)
    axes = torch.arange(3, device=dev)

    for _ in range(max_steps):
        if not bool(torch.any(active)):
            break
        # min-t axis per lane (the first of equal ones)
        dim = torch.argmin(t, dim=-1)
        mint = _take(t, dim)
        # emergency break on float drift
        alive = active & (mint <= 1.0)
        onehot = (axes[None, :] == dim[:, None]).to(torch.int32)
        cur2 = current + onehot * advance
        is_solid = _solid_at(solid, cur2, cfg)
        newly_hit = alive & is_solid
        hit = hit | newly_hit
        hit_dim = torch.where(newly_hit, dim.to(torch.int32), hit_dim)
        hit_t = torch.where(newly_hit, mint, hit_t)
        # continue marching: advance the crossed axis' t
        go = alive & ~is_solid
        current = torch.where(go[:, None], cur2, current)
        t = torch.where(go[:, None], t + onehot.to(t.dtype) * _take(inv_abs, dim)[:, None], t)
        done = torch.all(current == to_cell, dim=-1)
        active = go & ~done

    # pull back a skin width before the hit face:
    # t += skin / dot(to - from, normal), normal = -advance[dim]
    offset_w = to_w - from_w
    off_dim = _take(offset_w, hit_dim)
    adv_dim = _take(advance, hit_dim).to(from_w.dtype)
    denom = off_dim * (-adv_dim)  # = -|offset[dim]|
    denom = torch.where(torch.abs(denom) > 1e-30, denom, torch.full_like(denom, -1e-30))
    t_new = torch.clamp(hit_t + skin / denom, min=0.0)
    new_from = from_w + t_new[:, None] * offset_w
    # cancel the remaining motion along the hit axis (to[dim] = from[dim])
    axis_mask = (axes[None, :] == hit_dim[:, None]).to(from_w.dtype)
    new_to = to_w * (1.0 - axis_mask) + new_from * axis_mask

    from_w = torch.where(hit[:, None], new_from, from_w)
    to_w = torch.where(hit[:, None], new_to, to_w)
    return from_w, to_w, hit


class _March(torch.autograd.Function):
    """The march with a straight-through gradient (port of
    ``collisions._march``'s ``custom_vjp``): the cotangent passes to
    `position` unchanged and `old_position` gets none."""

    @staticmethod
    def forward(ctx, old_position, position, solid, cfg):
        return _march_plain(old_position, position, solid, cfg)

    @staticmethod
    def backward(ctx, g):
        return None, g, None, None


def _march(old_position, position, solid, cfg: SimConfig) -> torch.Tensor:
    """Full collision march: up to one :func:`_march_round` per axis, each
    re-marching only the lanes that hit; straight-through in backward."""
    return _March.apply(old_position, position, solid, cfg)


def _march_plain(old_position, position, solid, cfg: SimConfig) -> torch.Tensor:
    max_steps = int(3 * max(cfg.cfl_number, 1.0)) + 8
    from_w, to_w = old_position, position
    need = torch.ones((position.shape[0],), dtype=torch.bool, device=position.device)
    for _ in range(3):
        from_w, to_w, hit = _march_round(from_w, to_w, need, solid, cfg, max_steps)
        need = hit
    return to_w


def _cell_frame(pos: torch.Tensor, cfg: SimConfig):
    """(clamped cell index, position within the cell, grid dims)."""
    h = cfg.cell_size
    dev = pos.device
    gpos = pos - torch.tensor(cfg.grid_offset, dtype=pos.dtype, device=dev)
    dims = torch.tensor(cfg.grid_size, dtype=torch.int32, device=dev)
    cell_idx = torch.minimum(torch.clamp(torch.floor(gpos / h).to(torch.int32), min=0), dims - 1)
    return cell_idx, gpos - cell_idx.to(pos.dtype) * h, dims


def resolve_collisions(
    old_position: torch.Tensor,
    position: torch.Tensor,
    solid: torch.Tensor,
    cfg: SimConfig,
) -> torch.Tensor:
    """Pull particles out of solid cells they moved into, then apply the
    boundary skin. `solid` is the (nx, ny, nz) bool mask.

    With ``cfg.has_obstacles=False`` there are no interior solid cells, so
    the march can never hit (advection already clamps into the domain) and
    the skin push-out engages only against the six walls.
    """
    skin = cfg.boundary_skin_width
    cell_skin_max = cfg.cell_size - skin

    if not cfg.has_obstacles:
        cell_idx, cell_pos, dims = _cell_frame(position, cfg)
        zero = torch.zeros_like(cell_pos)
        neg_blocked = cell_idx == 0
        pos_blocked = cell_idx + 1 >= dims
        d = torch.where((cell_pos < skin) & neg_blocked, skin - cell_pos, zero)
        d = d + torch.where(
            (cell_pos > cell_skin_max) & pos_blocked, cell_skin_max - cell_pos, zero
        )
        return position + d

    pos = _march(old_position, position, solid, cfg)

    # skin push-out from adjacent solid cells / domain walls, per axis
    cell_idx, cell_pos, dims = _cell_frame(pos, cfg)
    deltas = []
    for dim in range(3):
        off = torch.zeros((3,), dtype=torch.int32, device=pos.device)
        off[dim] = 1
        cp = cell_pos[..., dim]
        zero = torch.zeros_like(cp)
        neg_blocked = (cell_idx[..., dim] == 0) | _solid_at(solid, cell_idx - off, cfg)
        pos_blocked = (cell_idx[..., dim] + 1 >= cfg.grid_size[dim]) | _solid_at(
            solid, cell_idx + off, cfg
        )
        d = torch.where((cp < skin) & neg_blocked, skin - cp, zero)
        d = d + torch.where((cp > cell_skin_max) & pos_blocked, cell_skin_max - cp, zero)
        deltas.append(d)
    return pos + torch.stack(deltas, dim=-1)
