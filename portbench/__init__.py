"""The benchmark of ``libfluid_tpu_torch`` on one CUDA card.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything
that belongs to one configuration, traffic mix, frame action, metric or
kernel sits in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``actions/<action>.py``,
``metrics/<metric>.py``, ``roofline/<kernel>.py`` and ``limits/<cell>.json``.
"""
