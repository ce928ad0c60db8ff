"""portbench: the benchmark of ``pyfft_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``README.md`` says how
cells, configurations, traffic mixes and metrics are added as files.
"""
