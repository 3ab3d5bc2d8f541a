"""PyTorch/CUDA port of vlsa_tpu: VLSA serving on an NVIDIA Hopper card.

The JAX package `vlsa_tpu` is the reference this package is held against;
nothing here imports it.  Entry points run on CUDA unless the caller passes
`device="cpu"`.
"""
