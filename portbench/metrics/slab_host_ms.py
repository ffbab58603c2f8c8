"""``slab_host_ms``: host ms per substep of the ``slab`` spans of the traced
replay: each slab's pass of the slab-tiled substep (``bigstep.substep_tiled``)
in P2G (kernel B and the adds of its face sums) and in the correction
(kernel E and the copy of its springs), their enqueue. Nothing where the
replay holds no ``slab`` span: the dense substep, or a program that records
none."""

from portbench.spans import ms_per_substep, replay_frames


def read(run):
    frames = replay_frames(run)
    if not frames or not any(f.named("slab") for f in frames):
        return None
    return ms_per_substep(run, "slab")
