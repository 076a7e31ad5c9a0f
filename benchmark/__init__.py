"""The benchmark of ``subgraph_sketching_tpu_torch`` on one NVIDIA H100.

Run one cell with ``python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the repository root
names the cells and metrics, and ``benchmark/README.md`` says how a
configuration, a traffic mix or a metric is added.
"""
