"""A frozen copy of the plain paths of ``libfluid_tpu_torch``: the
simulator's substep and CFL step, the mesher and the renderer's forward
path, as the port runs them on CPU tensors.

The copy is the benchmark's reference: it runs on the card as well, so the
port's kernels are held to the plain versions that its own CPU tests hold
to the JAX package. It imports nothing of ``libfluid_tpu_torch``, nothing
of ``jax`` and no kernel: ``sim/kernels.py`` here sends every stage to its
plain version, and the kernels' wrappers, autograd Functions and backward
passes are left out. Everything else is the port's code as it stood when
the benchmark was written, with its imports renamed, but for one change of
schedule: the correction's springs (``sim/correction.py:_springs_torch``)
go over x-slabs of cells, so that a 256^3 grid's pair tensors fit on the
card, with each element's arithmetic and each reduction as before.
"""
