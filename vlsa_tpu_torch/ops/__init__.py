"""Masked pooling primitives and the co-attention and ABMIL kernels."""
