"""Benchmark of the PyTorch and CUDA port of GraftDB (``graftdb_torch``).

Run one cell once: ``python3 -m graftbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root.
"""
