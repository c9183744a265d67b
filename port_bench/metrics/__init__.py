"""Per-layer metrics, one file each, found by the metric's name in
``BENCHMARK.json``.  Each defines ``read(ctx)``: the metric's value from
the traced run's spans, counters and profiler trace (``ctx``, built in
``run.py``), or None where it finds nothing to read."""
