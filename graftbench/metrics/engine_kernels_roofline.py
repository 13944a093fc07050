"""B1-B4's bytes over the HBM bandwidth, as a share of their device time."""

from graftbench.readings import engine_kernels_roofline as read  # noqa: F401
