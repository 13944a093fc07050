"""repro_torch: the PyTorch/CUDA port of the GraftDB reproduction.

The supported public surface is the ``graftdb_torch`` package
(``repro_torch.api`` re-exported). The port keeps the reference package's
module names and layout; the host-side engine stays NumPy, and the data
plane (state mirrors and the probe / fused-chain kernels) runs on a CUDA
card through hand-written kernels in ``repro_torch.kernels``.
"""
