"""The port's slab-tiled substep on the paths off its plain run: the G2P
branch past ``_G2P_TILED_THRESHOLD`` (forced), the springs of rows past the
correction window (``_overflow_springs_lazy``), sources. Against the JAX
package's ``substep_tiled`` and the port's dense substep, as
``test_torch_bigstep.py`` (whose helpers these are; a file of its own so
that each stays near a minute in one worker)."""

import dataclasses

import numpy as np
import pytest
import torch

from libfluid_tpu.config import TransferScheme
from libfluid_tpu.sim import bigstep as j_bigstep
from libfluid_tpu.sim.sources import make_source_set
from libfluid_tpu_torch.sim import bigstep, slotsort
from test_torch_bigstep import _assert_matches_dense, _assert_matches_jax, _jax_and_port, _mk
from test_torch_substep import _port

torch.set_num_threads(1)


@pytest.mark.parametrize("scheme", [TransferScheme.APIC, TransferScheme.FLIP], ids=["apic", "flip"])
def test_tiled_g2p_slab_path_matches_jax(monkeypatch, scheme):
    """The threshold at 0: JAX builds its G2P table slab by slab, and FLIP
    takes the combined grid new - blend * old in both packages."""
    monkeypatch.setattr(j_bigstep, "_G2P_TILED_THRESHOLD", 0)
    monkeypatch.setattr(bigstep, "_G2P_TILED_THRESHOLD", 0)
    cfg, st = _mk(2, scheme)
    j, t, d = _jax_and_port(cfg, st)
    _assert_matches_jax(cfg, j, t)
    _assert_matches_dense(t, d)


def test_tiled_overflow_springs_clustered():
    """Two interleaved seedings (16 particles a cell, past
    correction_capacity 8): springs of the rows past the window come from
    _overflow_springs_lazy."""
    cfg, st = _mk(3, boxes=(((1.0, 1.0, 1.0), (8.0, 6.0, 6.0)), ((1.2, 1.2, 1.2), (8.2, 6.2, 6.2))))
    cfg = dataclasses.replace(cfg, correction_capacity=8)
    j, t, d = _jax_and_port(cfg, st)
    tcfg, tst = _port(cfg, st)
    counts = slotsort.sort_rank_major(tst, tcfg).counts
    assert int(counts.max()) > cfg.correction_capacity, "cluster failed to overflow"
    _assert_matches_jax(cfg, j, t)
    _assert_matches_dense(t, d)


def test_tiled_sources_match_jax():
    """A coercing source seeds with JAX's draw in both packages; the tiled
    and dense paths seed the same rows."""
    cfg, st = _mk(4)
    src = make_source_set([[12, 12, 8], [13, 12, 8]], (0.0, -40.0, 0.0), coerce_velocity=True)
    st = st._replace(sources=src)
    n0 = int(np.asarray(st.active).sum())
    j, t, d = _jax_and_port(cfg, st)
    assert int(t[1].particle_count) == int(j[1].particle_count) > n0
    _assert_matches_jax(cfg, j, t)
    _assert_matches_dense(t, d)
