"""The assembled VLSA model (counterpart of vlsa_tpu/models/vlsa.py).

    text_features  = CoOp prompts through the frozen text tower, the
                     PromptAdapter's heads over frozen prompt features, or
                     prompts precomputed once (frozen CoOp)
    query          = the TaskRes query adapter over frozen prior sentences
    image_features = VLFAN over the patch bag with those queries,
                     DeepMIL or DSMIL, or FeatMIL (zero-shot: per-patch
                     features)
    logits         = logit_scale.exp() * norm(img) @ norm(text)^T

In zero-shot mode (FeatMIL's identity pooling) every patch is scored and
the per-patch logits are pooled by MI-Zero's `logit_pooling`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.coattn import dequantize_feats
from ..ops.masked import l2_normalize
from .mil import DSMIL, VLFAN, DeepMIL, FeatMIL, logit_pooling
from .prompt_learners import PlainPromptLearner, PromptAdapter
from .text_encoder import TextTower

CLIP_LOGIT_SCALE_INIT = float(np.log(1.0 / 0.07))


class VLSA(nn.Module):
    accepts_x_scale = True  # VLFAN takes the int8 scales and host 1/||x|| rows
    uses_vl = True

    def __init__(self, mil_encoder: Union[VLFAN, DeepMIL, DSMIL, FeatMIL],
                 prompt_encoder: Optional[TextTower] = None,
                 prompt_learner: Optional[PlainPromptLearner] = None,
                 prompt_adapter: Optional[PromptAdapter] = None,
                 query_adapter: Optional[PromptAdapter] = None,
                 pooling: str = "logit_mean",
                 logit_scale_init: float = CLIP_LOGIT_SCALE_INIT,
                 pretrained_text_features: Optional[np.ndarray] = None,
                 text_trim_len: Optional[int] = None):
        super().__init__()
        self.prompt_encoder = prompt_encoder
        self.mil_encoder = mil_encoder
        self.prompt_learner = prompt_learner
        self.prompt_adapter = prompt_adapter
        self.query_adapter = query_adapter
        self.pooling = pooling  # zero-shot logit pooling
        # frozen CoOp prompts encoded once: a constant, not a parameter, so
        # not in the state dict (vlsa_tpu's tree has no such leaf)
        self.register_buffer("pretrained_text_features", None if pretrained_text_features
                             is None else torch.as_tensor(np.asarray(
                                 pretrained_text_features, np.float32)), persistent=False)
        # static trimmed prompt length: with causal attention the cls readout
        # is the same when trailing padding is dropped (None = full length)
        self.text_trim_len = text_trim_len
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))

    def get_logit_scale(self) -> torch.Tensor:
        return torch.exp(self.logit_scale)

    def forward_text_only(self) -> torch.Tensor:
        """Text prototypes [K, E]: precomputed, from the CoOp prompts, or
        from the PromptAdapter."""
        if self.pretrained_text_features is not None:
            return self.pretrained_text_features
        if self.prompt_learner is not None:
            embeds = self.prompt_learner()
            pseudo = self.prompt_learner.pseudo_sentence_tokens
            if self.text_trim_len is not None:
                embeds = embeds[:, :self.text_trim_len]
                pseudo = pseudo[:, :self.text_trim_len]
            return self.prompt_encoder(prompts_embedding=embeds, prompts_pseudo_tokens=pseudo)
        if self.prompt_adapter is not None:
            return self.prompt_adapter()
        raise ValueError("no text path configured")

    def get_query(self) -> Optional[torch.Tensor]:
        return self.query_adapter() if self.query_adapter is not None else None

    def query_div_loss(self, **kws) -> torch.Tensor:
        """The network's prompt-diversity regulariser (the QueryDiv loss)."""
        return self.mil_encoder.query_div_loss(query=self.get_query(), **kws)

    def text_precompute(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(text_features, query) for fixed parameters: a serving pass
        computes them once, not once per request."""
        return self.forward_text_only(), self.get_query()

    def encode_instances(self, X, mask=None, query=None, x_scale=None, x_inv=None,
                         ret_with_attn: bool = False, train: bool = False):
        """The MIL encoder's image features; with `ret_with_attn` (VLFAN,
        DeepMIL, DSMIL), (features, its attention), and `train` turns its
        Dropout on."""
        enc = self.mil_encoder
        if isinstance(enc, (FeatMIL, DSMIL)) and X.dtype == torch.int8:
            # these take features: int8 dequantized to bf16, no sidecars
            X = dequantize_feats(X, x_scale).to(torch.bfloat16)
        if isinstance(enc, FeatMIL):
            return enc(X, mask)
        if isinstance(enc, DSMIL):
            return enc(X, mask, ret_with_attn=ret_with_attn, train=train)
        if isinstance(enc, DeepMIL):
            return enc(X, mask, x_scale=x_scale, ret_with_attn=ret_with_attn, train=train)
        if enc.query == "Text" and query is None:
            query = self.get_query()
        return enc(X, mask, query=query, x_scale=x_scale, x_inv=x_inv,
                   ret_with_attn=ret_with_attn, train=train)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                text_features: Optional[torch.Tensor] = None,
                query: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None, train: bool = False):
        """X [B, N, D], mask [B, N] -> (logits [B, K], image features, text
        features).  `text_features`/`query` take `text_precompute`'s values;
        `train` turns the MIL encoder's Dropout on.

        bf16 image features are normalised as vlsa_tpu's compiled program
        does (`normalize_rows`) and meet the f32 text side in f32."""
        if text_features is None:
            text_features = self.forward_text_only()
        text_n = l2_normalize(text_features, dim=-1)
        image = self.encode_instances(X, mask, query=query, x_scale=x_scale, x_inv=x_inv,
                                      train=train)
        img_n = normalize_rows(image)
        if image.dim() == 3:  # zero-shot: per-patch logits, MI-Zero pooling
            patch_logits = self.get_logit_scale() * torch.einsum("bne,ke->bnk", img_n, text_n)
            _, logits = logit_pooling(patch_logits, self.pooling, mask)
        else:
            logits = self.get_logit_scale() * img_n @ text_n.T
        return logits, image, text_features


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """`l2_normalize` over the last axis, f32 out.  bf16 rows as vlsa_tpu's
    compiled program normalises them: the sum of the exact f32 squares
    rounded to bf16, its floor eps^2 and its square root rounded to bf16,
    the division in f32 (XLA drops the rounding of the quotient, which then
    only widens again for the f32 product with the text side)."""
    if x.dtype == torch.float32:
        return l2_normalize(x, dim=-1, eps=eps)
    xf = x.float()
    sq = torch.sum(xf * xf, dim=-1, keepdim=True).to(x.dtype)
    norm = torch.sqrt(torch.clamp(sq, min=eps * eps).float()).to(x.dtype)
    return xf / norm.float()


def trim_length(pseudo_sentence_tokens: np.ndarray, max_num_tokens: int) -> Optional[int]:
    """Exact-safe prompt trim: the longest real sentence plus the one trailing
    pad the cls mask attends to, rounded up to a multiple of 8; None when
    that is no shorter than the full length."""
    max_real = int(np.asarray(pseudo_sentence_tokens).max())
    trim = min(-(-(max_real + 1) // 8) * 8, max_num_tokens)
    return trim if trim < max_num_tokens else None

