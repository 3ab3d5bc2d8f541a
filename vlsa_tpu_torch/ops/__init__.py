"""Masked pooling primitives and the co-attention kernel."""
