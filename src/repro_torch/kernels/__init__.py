"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``hash_probe`` (the fused-lens probes and the batch insert),
``fused_chain`` (the morsel stage chain), ``seg_aggregate`` (the grouped
sum), ``flash_attention`` and ``linrec`` (the linear recurrence) each pair
CUDA kernels from ``csrc/`` with plain versions; ``ops`` wraps them for
callers outside the engine; ``ref`` holds independent oracles for the
tests; ``_build`` compiles the sources at first use and counts launches.
"""
