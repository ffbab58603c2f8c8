"""The reference's correction springs in x-slabs (``_springs_torch``) equal
the springs of the whole grid at once, bit for bit, at 16^3 on the CPU:
the slabs change which cells a pass holds, never an element's arithmetic
or a reduction's order."""

import pytest
import torch
import torch.nn.functional as F

from portbench.reference.lf.config import SimConfig
from portbench.reference.lf.sim import correction, jitterhash
from portbench.reference.lf.sim import slots as slots_mod


def shifted(arr, off, cfg):
    """Cells' view of neighbour cell ``c + off`` (the grid's dims last),
    zero-padded at the domain boundary."""
    nx, ny, nz = cfg.grid_size
    p = F.pad(arr, (1, 1, 1, 1, 1, 1))
    ox, oy, oz = off
    return p[..., 1 + ox: 1 + ox + nx, 1 + oy: 1 + oy + ny, 1 + oz: 1 + oz + nz]


def unblocked(res_pos, res_mask, re2, seed, cfg, origin=(0, 0, 0)):
    """The springs of the whole grid in one pass of each offset: the
    reference's correction as it was before it was blocked."""
    kc = res_pos.shape[1]
    wsum = torch.zeros_like(res_mask)
    wnbr = torch.zeros_like(res_pos)
    coincident = torch.zeros_like(res_mask)
    eye = torch.eye(kc, dtype=res_pos.dtype, device=res_pos.device).reshape(kc, kc, 1, 1, 1)
    for d in slots_mod.NEIGHBOR_OFFSETS:
        nbr_pos = shifted(res_pos, d, cfg)
        nbr_mask = shifted(res_mask, d, cfg)
        sq = sum((res_pos[i][:, None] - nbr_pos[i][None, :]) ** 2 for i in range(3))
        pair = res_mask[:, None] * nbr_mask[None, :]
        if d == (0, 0, 0):
            pair = pair * (1.0 - eye)
        w = correction._pair_weight(sq, re2) * pair
        wsum += torch.sum(w, dim=1)
        wnbr += torch.stack([torch.sum(w * nbr_pos[i][None, :], dim=1) for i in range(3)])
        coincident += torch.sum(torch.where(sq < 1e-12, pair, torch.zeros_like(pair)), dim=1)
    springs = res_pos * wsum[None] - wnbr
    jitter = jitterhash.jitter_field(seed, kc, tuple(res_pos.shape[2:]), origin, res_pos.dtype, res_pos.device)
    return springs + coincident[None] * jitter


def slot_grid(n: int, k: int, kc: int, seed: int):
    """Slot positions and masks (3, KC, n, n, n) and (KC, n, n, n), cut from
    a grid of K slots a cell as the correction cuts them: each slot at a
    random place in its cell, about a third of them empty, some pairs of a
    cell exactly coincident."""
    g = torch.Generator().manual_seed(seed)
    cell = torch.stack(torch.meshgrid(*[torch.arange(n, dtype=torch.float32)] * 3, indexing="ij"))
    pos = cell[:, None] + torch.rand((3, k, n, n, n), generator=g)
    pos[:, 1::5] = pos[:, 0::5][:, : pos[:, 1::5].shape[1]]  # coincident with the slot before
    mask = (torch.rand((k, n, n, n), generator=g) > 0.3).to(torch.float32)
    data = torch.zeros((16, k, n, n, n))
    data[0:3], data[3] = pos * mask, mask
    sg = slots_mod.SlotGrid(data=data, slot_of=None, overflow=None)
    return sg.position[:, :kc], sg.mask[:kc]


@pytest.mark.parametrize("slab", [1, 3, 16])
@pytest.mark.parametrize("origin", [(0, 0, 0), (32, 0, 16)])
def test_slabs_equal_the_whole_grid(slab, origin, monkeypatch):
    """With the pair tensors' bytes set to `slab` planes' worth."""
    n, kc = 16, 12
    cfg = SimConfig(grid_size=(n, n, n))
    res_pos, res_mask = slot_grid(n, k=14, kc=kc, seed=5)
    re2 = cfg.cell_size * cfg.cell_size / 2.0
    want = unblocked(res_pos, res_mask, re2, 123457, cfg, origin)
    monkeypatch.setattr(correction, "_PAIR_BYTES", slab * kc * kc * n * n * 4)
    got = correction._springs_torch(res_pos, res_mask, re2, 123457, origin)
    assert torch.count_nonzero(want).item() > want.numel() // 2
    assert torch.equal(got, want)


def test_the_default_slab_keeps_a_pair_tensor_within_its_bytes(monkeypatch):
    """With the pair tensors' bytes set to three planes' worth, the default
    slab takes three planes and the springs are those of the whole grid."""
    n, kc = 16, 12
    cfg = SimConfig(grid_size=(n, n, n))
    res_pos, res_mask = slot_grid(n, k=kc, kc=kc, seed=9)
    monkeypatch.setattr(correction, "_PAIR_BYTES", 3 * kc * kc * n * n * 4 + 1)
    seen = []
    jitter_field = jitterhash.jitter_field

    def recording(seed, kc, shape, origin, dtype, device=None):
        seen.append(shape[0])
        return jitter_field(seed, kc, shape, origin, dtype, device)

    monkeypatch.setattr(jitterhash, "jitter_field", recording)
    got = correction._springs_torch(res_pos, res_mask, 0.5, 77)
    assert seen == [3, 3, 3, 3, 3, 1]
    assert torch.equal(got, unblocked(res_pos, res_mask, 0.5, 77, cfg))
