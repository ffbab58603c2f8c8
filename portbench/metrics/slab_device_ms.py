"""``slab_device_ms``: device ms per substep of the kernels that the slab loop
of the slab-tiled substep (``bigstep.substep_tiled``) launches, by the
Python stack of each launch: for each slab, kernel A's window of the slot
grid (``slotsort.py``'s ``expand_range``, where its copies of the window's
table land, and ``_expand_cuda``, where kernel ``expand`` lands), kernel B
and the adds of its face sums (``bigstep.py``'s ``p2g_slab``), kernel E
(``correction.py``'s ``forward``, the springs' autograd Function) and the
copy of its interior springs (``bigstep.py``'s ``springs_slab``). Nothing
where no launch is placed in ``p2g_slab`` or ``springs_slab``: the dense
substep, which launches kernels A and E from the same two functions of
``slotsort.py`` and ``correction.py``, or a replay without stacks."""

LOOP = {("bigstep.py", "p2g_slab"), ("bigstep.py", "springs_slab"), ("slotsort.py", "expand_range"),
        ("slotsort.py", "_expand_cuda"), ("correction.py", "forward")}


def read(run):
    prof = run.profile
    kernels = prof.get("kernels", []) if prof else []
    if not any(k["module"] == "bigstep.py" and k["function"] in ("p2g_slab", "springs_slab") for k in kernels):
        return None
    substeps = sum(c.get("substeps", 0.0) for c in prof["counts"])
    s = sum(k["s"] for k in kernels if (k["module"], k["function"]) in LOOP)
    return 1e3 * s / substeps if substeps else None
