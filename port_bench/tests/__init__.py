"""CPU tests of the benchmark (``python -m pytest port_bench/tests``); the
``cuda``-marked ones run on a card and skip elsewhere."""
