"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``hash_probe`` (the fused-lens probes) and ``fused_chain`` (the morsel
stage chain) each pair a CUDA kernel from ``csrc/`` with a plain version;
``_build`` compiles the sources at first use and counts launches.
"""
