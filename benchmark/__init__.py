"""The port's benchmark: ``python3 benchmark/run.py --workload <cell> ...``.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration (``configs/<config>.json`` and ``configs/<config>.py``), the
traffic mix (``traffic/<traffic>.json``, read by the loop it names in
``loops/``) and each metric (``metrics/<metric>.py``).
"""
