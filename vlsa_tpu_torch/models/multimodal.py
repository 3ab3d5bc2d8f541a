"""CoCa's caption decoder and caption generation (counterpart of
vlsa_tpu/models/multimodal.py).

`MultimodalDecoder` is CoCa's MultimodalTransformer: per layer a causal
self-attention block over the text tower's per-token outputs, then a
cross-attention block over the image's caption-pooled tokens
(`ConchVisualModel`'s second output); ln_final and a projection to the
vocabulary.  torch ops in f32 (TF32 off on the card,
`utils.device.disable_tf32`): vlsa_tpu computes it with XLA ops, not with a
kernel of its own.

`coca_generate` decodes captions as vlsa_tpu does, step for step: one step
re-feeds the whole fixed [R, seq_len] token buffer, padded, through the text
tower and the decoder (causal masking makes the positions past the current
one inert for the logits read at t - 1); the logits go to the host as f32,
where `models.generation`'s numpy processors, warpers and grouped beam
search choose the next tokens.

Parameters keep vlsa_tpu's names (`resblocks.<i>`, `cross_<i>`,
`ln_final`, `text_projection`), so `utils.weights.state_dict_from_jax` maps a
vlsa_tpu decoder tree one to one; `load_multimodal_state` reads CONCH's
`text_decoder.*` tensors.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .generation import (beam_search, min_length_process, repetition_penalty_process,
                         top_k_warp, top_p_warp)
from .text_encoder import ResidualAttentionBlock, TextTower, causal_mask

GENERATION_TYPES = ("beam_search", "top_k", "top_p")


def _normal(shape, std, generator):
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


class TorchCrossAttention(nn.Module):
    """torch nn.MultiheadAttention(d, h) used across modalities: the fused
    in_proj rows split into q (the text) and k, v (the image)."""

    def __init__(self, width: int, heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        D = width
        self.heads = heads
        self.in_proj_weight = _normal((3 * D, D), D ** -0.5, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * D))
        self.out_proj_weight = _normal((D, D), D ** -0.5, generator)
        self.out_proj_bias = nn.Parameter(torch.zeros(D))

    def forward(self, q_x: torch.Tensor, kv_x: torch.Tensor) -> torch.Tensor:
        B, L, D = q_x.shape
        S, H = kv_x.shape[1], self.heads
        hd = D // H
        w, b = self.in_proj_weight, self.in_proj_bias
        q = (q_x @ w[:D].T + b[:D]).reshape(B, L, H, hd).transpose(1, 2)
        k = (kv_x @ w[D:2 * D].T + b[D:2 * D]).reshape(B, S, H, hd).transpose(1, 2)
        v = (kv_x @ w[2 * D:].T + b[2 * D:]).reshape(B, S, H, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(B, L, D)
        return ctx @ self.out_proj_weight.T + self.out_proj_bias


class CrossResidualAttentionBlock(nn.Module):
    """A residual block with cross attention: ln_1 on the queries, ln_1_kv on
    the image tokens, an exact-GELU MLP; LayerNorm eps 1e-5."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, hid = width, int(width * mlp_ratio)
        self.ln_1 = nn.LayerNorm(D, eps=1e-5)
        self.ln_1_kv = nn.LayerNorm(D, eps=1e-5)
        self.attn = TorchCrossAttention(D, heads, generator)
        self.ln_2 = nn.LayerNorm(D, eps=1e-5)
        self.c_fc_weight = _normal((hid, D), (2 * D) ** -0.5, generator)
        self.c_fc_bias = nn.Parameter(torch.zeros(hid))
        self.c_proj_weight = _normal((D, hid), D ** -0.5, generator)
        self.c_proj_bias = nn.Parameter(torch.zeros(D))

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), self.ln_1_kv(kv))
        hid = F.gelu(self.ln_2(x) @ self.c_fc_weight.T + self.c_fc_bias)
        return x + (hid @ self.c_proj_weight.T + self.c_proj_bias)


class MultimodalDecoder(nn.Module):
    """CoCa's MultimodalTransformer (CONCH: width 768, 12 heads, 12 layers,
    context 128, a vocabulary of 32007)."""

    def __init__(self, width: int = 768, heads: int = 12, layers: int = 12,
                 context_length: int = 128, output_dim: int = 32007,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = layers
        self.context_length = context_length
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, quick_gelu=False, generator=generator)
            for _ in range(layers))
        for i in range(layers):
            self.add_module(f"cross_{i}", CrossResidualAttentionBlock(width, heads,
                                                                      generator=generator))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = _normal((width, output_dim), width ** -0.5, generator)

    def forward(self, image_embs: torch.Tensor, text_embs: torch.Tensor) -> torch.Tensor:
        """image_embs [B, S, W] (caption-pooled image tokens), text_embs [B,
        L, W] -> logits [B, L, vocab]."""
        L = text_embs.shape[1]
        if L > self.context_length:
            raise ValueError(f"at most {self.context_length} text tokens, got {L}")
        mask = causal_mask(L, text_embs.device)
        x = text_embs
        for i, blk in enumerate(self.resblocks):
            x = getattr(self, f"cross_{i}")(blk(x, mask), image_embs)
        return self.ln_final(x) @ self.text_projection


def load_multimodal_state(state: dict, layers: int, prefix: str = "text_decoder.") -> dict:
    """A CONCH checkpoint's MultimodalTransformer tensors (`<prefix>
    resblocks.<i>.*`, `cross_attn.<i>.*`, `ln_final.*`, `text_projection`)
    -> this package's `MultimodalDecoder` state dict, f32, for
    `load_state_dict(..., strict=True)`."""
    def g(k):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(state[prefix + k], np.float32)))

    sd = {"ln_final.weight": g("ln_final.weight"), "ln_final.bias": g("ln_final.bias"),
          "text_projection": g("text_projection")}
    names = {"ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
             "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
             "attn.in_proj_weight": "attn.in_proj_weight",
             "attn.in_proj_bias": "attn.in_proj_bias",
             "attn.out_proj_weight": "attn.out_proj.weight",
             "attn.out_proj_bias": "attn.out_proj.bias",
             "c_fc_weight": "mlp.c_fc.weight", "c_fc_bias": "mlp.c_fc.bias",
             "c_proj_weight": "mlp.c_proj.weight", "c_proj_bias": "mlp.c_proj.bias"}
    cross = dict(names, **{"ln_1_kv.weight": "ln_1_kv.weight", "ln_1_kv.bias": "ln_1_kv.bias"})
    for i in range(layers):
        for ours, theirs in names.items():
            sd[f"resblocks.{i}.{ours}"] = g(f"resblocks.{i}.{theirs}")
        for ours, theirs in cross.items():
            sd[f"cross_{i}.{ours}"] = g(f"cross_attn.{i}.{theirs}")
    return sd


def caption_logits(text_tower: TextTower, decoder: MultimodalDecoder,
                   image_embs: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """The decode step: token ids [R, L] (a padded buffer; image_embs [R, S,
    W]) -> logits [R, L, vocab] at every position.  The ids are their own
    pseudo tokens, as vlsa_tpu feeds them: for CONCH the <cls> row then
    skips the pad keys."""
    _pooled, tokens = text_tower(prompts_embedding=text_tower.embed_tokens(buf),
                                 prompts_pseudo_tokens=buf, return_tokens=True)
    return decoder(image_embs, tokens)


def coca_generate(text_tower: TextTower, decoder: MultimodalDecoder, image_embs,
                  seq_len: int = 30, sot_token_id: int = 1, eos_token_id: int = 2,
                  pad_token_id: int = 0, generation_type: str = "beam_search",
                  top_k: int = 1, top_p: float = 0.1, temperature: float = 1.0,
                  min_seq_len: int = 5, repetition_penalty: float = 1.0,
                  num_beams: int = 6, num_beam_groups: int = 3,
                  diversity_penalty: float = 0.0, seed: int = 0, device=None,
                  timings: Optional[dict] = None) -> np.ndarray:
    """Captions of the caption-pooled image tokens `image_embs` [B, S, W] ->
    token ids [B, <= seq_len] (int64, numpy).

    `generation_type`: "beam_search" (the default; grouped beams,
    `models.generation.beam_search`), "top_k" (greedy when top_k is 1,
    else top-k sampling) or "top_p" (nucleus sampling); MinLength, then
    RepetitionPenalty, then the warper, then the temperature.  The sampling
    paths force <eos> at seq_len - 1, give a finished row pads and stop when
    every row has finished, the buffer keeping its full width; their draws
    come from `np.random.default_rng(seed)`, one `choice` a row a step,
    finished rows included.

    Runs on `device` (the card unless "cpu" is asked for), where the text
    tower and the decoder must already be.  `timings`, if given, receives
    the steps run, `step_s` (the decode steps with the logits' copy to the
    host, host clock) and `host_s` (the rest: processors, sampling, beam
    bookkeeping)."""
    device = resolve_device(device)
    for name, module in (("text_tower", text_tower), ("decoder", decoder)):
        where = next(module.parameters()).device
        if where.type != device.type:
            raise ValueError(f"{name} is on {where}; move it to {device} to generate there")
    if generation_type not in GENERATION_TYPES:
        raise ValueError("generation_type has to be one of | beam_search | top_k | top_p |.")
    embs = torch.as_tensor(image_embs, device=device).float()
    B = embs.shape[0]
    clock = {"steps": 0, "step_s": 0.0}
    t_start = time.perf_counter()

    def step_logits(embs_r: torch.Tensor, buf: np.ndarray, t: int) -> np.ndarray:
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = caption_logits(text_tower, decoder, embs_r,
                                    torch.from_numpy(buf).to(device))[:, t - 1]
            out = logits.float().cpu().numpy()
        clock["steps"] += 1
        clock["step_s"] += time.perf_counter() - t0
        return out

    if generation_type == "beam_search":
        R = B * num_beams
        embs_r = embs.repeat_interleave(num_beams, dim=0)

        def step_fn(ids: np.ndarray) -> np.ndarray:
            t = ids.shape[1]
            buf = np.full((R, seq_len), pad_token_id, np.int64)
            buf[:, :t] = ids
            return step_logits(embs_r, buf, t)

        out = beam_search(
            step_fn, B, seq_len, sot_token_id=sot_token_id,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            num_beams=num_beams, num_beam_groups=num_beam_groups,
            min_seq_len=min_seq_len, repetition_penalty=repetition_penalty,
            diversity_penalty=diversity_penalty)
    else:
        rng = np.random.default_rng(seed)
        out = np.full((B, seq_len), pad_token_id, np.int64)
        out[:, 0] = sot_token_id
        finished = np.zeros(B, bool)
        for t in range(1, seq_len):
            logits = step_logits(embs, out, t)  # [B, V]
            logits = min_length_process(logits, t, min_seq_len, eos_token_id)
            logits = repetition_penalty_process(logits, out[:, :t], repetition_penalty)
            if generation_type == "top_p":
                logits = top_p_warp(logits, top_p)
            else:
                logits = top_k_warp(logits, top_k)
            if t == seq_len - 1:
                nxt = np.full(B, eos_token_id)
            elif generation_type == "top_k" and top_k <= 1:
                nxt = np.argmax(logits, axis=-1)
            else:
                filt = logits / temperature
                p = np.exp(filt - filt.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                nxt = np.array([rng.choice(len(pi), p=pi) for pi in p])
            nxt = np.where(finished, pad_token_id, nxt)
            out[:, t] = nxt
            finished |= (nxt == eos_token_id)
            if finished.all():
                break
    if timings is not None:
        timings.update(steps=clock["steps"], step_s=clock["step_s"],
                       host_s=time.perf_counter() - t_start - clock["step_s"])
    return out
