"""The benchmark of the PyTorch and CUDA port (``incagg_gnn_tpu_torch``):
one cell a run on one H100, driven by ``BENCHMARK.json`` at the root
(``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  See ``run.py``."""
