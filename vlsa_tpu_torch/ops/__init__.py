"""Masked pooling primitives and the co-attention, ABMIL and flash
self-attention kernels."""
