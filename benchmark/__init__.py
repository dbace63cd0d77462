"""The benchmark of the PyTorch and CUDA port (``ac3acm_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md says
how it is laid out and how a cell, a configuration or a metric is added.
"""
