"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``hash_probe`` (the fused-lens probes and the batch insert),
``fused_chain`` (the morsel stage chain) and ``seg_aggregate`` (the
grouped sum) each pair CUDA kernels from ``csrc/`` with plain versions;
``ops`` wraps them for callers outside the engine; ``_build`` compiles
the sources at first use and counts launches.
"""
