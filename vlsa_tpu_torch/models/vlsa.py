"""The assembled VLSA model (counterpart of vlsa_tpu/models/vlsa.py).

    text_features  = CoOp rank prompts through the frozen text tower
    query          = the TaskRes query adapter over frozen prior sentences
    image_features = VLFAN over the patch bag with those queries
    logits         = logit_scale.exp() * norm(img) @ norm(text)^T
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.masked import l2_normalize
from .mil import VLFAN
from .prompt_learners import PlainPromptLearner, PromptAdapter
from .text_encoder import TextTower

CLIP_LOGIT_SCALE_INIT = float(np.log(1.0 / 0.07))


class VLSA(nn.Module):
    accepts_x_scale = True  # VLFAN takes the int8 scales and host 1/||x|| rows
    uses_vl = True

    def __init__(self, mil_encoder: VLFAN, prompt_encoder: Optional[TextTower] = None,
                 prompt_learner: Optional[PlainPromptLearner] = None,
                 query_adapter: Optional[PromptAdapter] = None,
                 logit_scale_init: float = CLIP_LOGIT_SCALE_INIT,
                 text_trim_len: Optional[int] = None):
        super().__init__()
        self.prompt_encoder = prompt_encoder
        self.mil_encoder = mil_encoder
        self.prompt_learner = prompt_learner
        self.query_adapter = query_adapter
        # static trimmed prompt length: with causal attention the cls readout
        # is the same when trailing padding is dropped (None = full length)
        self.text_trim_len = text_trim_len
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))

    def get_logit_scale(self) -> torch.Tensor:
        return torch.exp(self.logit_scale)

    def forward_text_only(self) -> torch.Tensor:
        """Text prototypes [K, E] from the CoOp prompts."""
        if self.prompt_learner is None:
            raise ValueError("no text path configured")
        embeds = self.prompt_learner()
        pseudo = self.prompt_learner.pseudo_sentence_tokens
        if self.text_trim_len is not None:
            embeds = embeds[:, :self.text_trim_len]
            pseudo = pseudo[:, :self.text_trim_len]
        return self.prompt_encoder(prompts_embedding=embeds, prompts_pseudo_tokens=pseudo)

    def get_query(self) -> Optional[torch.Tensor]:
        return self.query_adapter() if self.query_adapter is not None else None

    def query_div_loss(self, **kws) -> torch.Tensor:
        """The network's prompt-diversity regulariser (the QueryDiv loss)."""
        return self.mil_encoder.query_div_loss(query=self.get_query(), **kws)

    def text_precompute(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(text_features, query) for fixed parameters: a serving pass
        computes them once, not once per request."""
        return self.forward_text_only(), self.get_query()

    def encode_instances(self, X, mask=None, query=None, x_scale=None, x_inv=None):
        if self.mil_encoder.query == "Text" and query is None:
            query = self.get_query()
        return self.mil_encoder(X, mask, query=query, x_scale=x_scale, x_inv=x_inv)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                text_features: Optional[torch.Tensor] = None,
                query: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None,
                x_inv: Optional[torch.Tensor] = None):
        """X [B, N, D], mask [B, N] -> (logits [B, K], image features, text
        features).  `text_features`/`query` take `text_precompute`'s values."""
        if text_features is None:
            text_features = self.forward_text_only()
        text_n = l2_normalize(text_features, dim=-1)
        image = self.encode_instances(X, mask, query=query, x_scale=x_scale, x_inv=x_inv)
        logits = self.get_logit_scale() * l2_normalize(image, dim=-1) @ text_n.T
        return logits, image, text_features


def trim_length(pseudo_sentence_tokens: np.ndarray, max_num_tokens: int) -> Optional[int]:
    """Exact-safe prompt trim: the longest real sentence plus the one trailing
    pad the cls mask attends to, rounded up to a multiple of 8; None when
    that is no shorter than the full length."""
    max_real = int(np.asarray(pseudo_sentence_tokens).max())
    trim = min(-(-(max_real + 1) // 8) * 8, max_num_tokens)
    return trim if trim < max_num_tokens else None

