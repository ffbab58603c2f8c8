"""The benchmark's plain reference (``lf/``, a frozen copy of the port's
plain paths), the comparisons that decide ``correct`` (:mod:`compare`) and
the lower-precision control (:mod:`control`). Nothing here imports
``libfluid_tpu_torch``, ``libfluid_tpu`` or ``jax``."""
