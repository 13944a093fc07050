"""Peaks of one NVIDIA H100 SXM5 (80 GB HBM3), the card the cells run on.

Frozen from the port's ``launch/roofline.py`` (NVIDIA H100 Tensor Core
GPU datasheet, at the 700 W power limit)."""

H100_HBM_BW = 3.35e12  # HBM3 bytes/s
