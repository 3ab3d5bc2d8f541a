"""Tokenizers (CONCH, CLIP, HF-CLIP), text towers, prompt learners, VLFAN
and the assembled VLSA; DeepMIL and its registry; the vision towers (CONCH,
CLIP's ViT and ModifiedResNet); CoCa's caption decoder and caption
generation (`multimodal`, `generation`)."""
from .multimodal import MultimodalDecoder, coca_generate  # noqa: F401
