"""PyTorch/CUDA port of vlsa_tpu on an NVIDIA Hopper card: the flagship VLSA (on
the CONCH, CLIP or HF-CLIP text tower) and the SA baseline (DeepMIL/ABMIL)
serve and train, the same networks classify slides (CLF), and CONCH
extracts the patch features they read.

The JAX package `vlsa_tpu` is the reference this package is held against;
nothing here imports it.  Entry points run on CUDA unless the caller passes
`device="cpu"`.
"""
