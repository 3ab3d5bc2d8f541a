"""Host construction of the prompt learners' constants (counterpart of
vlsa_tpu/models/prompt_build.py): sentence templates, pseudo tokens, context
and rank embeddings from the tokenizer and the tower's embedding table, and
the PromptAdapter's frozen text features encoded through the tower."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..data.io import load_init_prompt, load_init_text
from .prompt_learners import (PlainPromptLearner, PromptAdapter, RankPromptLearner,
                              create_interpolation_weights)
from .tokenizer import Tokenizer


def create_context_embeds(tokenizer: Tokenizer, embedding_table, num_ranks,
                          num_context_tokens, init_context, rank_specific_context,
                          embedding_dim):
    if init_context is not None:
        tokens, n_ctx = tokenizer(init_context.replace("_", " "),
                                  return_raw_tokens=True, return_num_tokens=True)
        context = embedding_table[np.asarray(tokens)]
        num_context_tokens = int(n_ctx)
        if rank_specific_context:
            context = np.repeat(context[None], num_ranks, axis=0)
    else:
        rng = np.random.default_rng(0)
        shape = ((num_ranks, num_context_tokens, embedding_dim)
                 if rank_specific_context else (num_context_tokens, embedding_dim))
        context = rng.normal(0, 0.02, size=shape).astype(np.float32)
    return context, num_context_tokens


def create_rank_embeds(tokenizer: Tokenizer, embedding_table, num_ranks,
                       num_tokens_per_rank, init_rank_names, num_context_tokens,
                       max_num_tokens, embedding_dim):
    if init_rank_names is not None:
        num_can = len(init_rank_names)
        if num_can > num_ranks:
            sel = np.linspace(0, num_can - 1, num_ranks).astype(np.int32)
            names = [init_rank_names[i] for i in sel]
        elif num_can < num_ranks:
            len_sec = num_ranks // num_can
            names = [init_rank_names[min(i // len_sec, num_can - 1)]
                     for i in range(num_ranks)]
        else:
            names = list(init_rank_names)
        tokens, counts = tokenizer(names, return_raw_tokens=True, return_num_tokens=True)
        num_tokens_per_rank = [int(c) for c in counts]
        if max(num_tokens_per_rank) > max_num_tokens - num_context_tokens - 3:
            raise ValueError(f"The rank name is too long: "
                             f"{names[int(np.argmax(num_tokens_per_rank))]}.")
        return embedding_table[np.asarray(tokens)], num_tokens_per_rank
    if isinstance(num_tokens_per_rank, int):
        num_tokens_per_rank = [num_tokens_per_rank] * num_ranks
    max_ntr = max(num_tokens_per_rank)
    if max_num_tokens < num_context_tokens + max_ntr + 3:
        raise ValueError(f"num_tokens_per_rank too large: {max_ntr}")
    rng = np.random.default_rng(1)
    embeds = rng.normal(0, 0.02, size=(num_ranks, max_ntr, embedding_dim)).astype(np.float32)
    return embeds, num_tokens_per_rank


def create_pseudo_sentence_tokens(num_tokens_per_rank, num_context_tokens, num_ranks,
                                  max_num_tokens) -> np.ndarray:
    """<sot> <ctx...> <rank_i...> <.> <eot> positions."""
    pseudo = np.zeros((num_ranks, max_num_tokens), dtype=np.int64)
    for i in range(num_ranks):
        ntr = (num_tokens_per_rank[i] if isinstance(num_tokens_per_rank, (list, tuple))
               else num_tokens_per_rank)
        length = 1 + num_context_tokens + ntr + 1 + 1
        pseudo[i, :length] = np.arange(length) + 1
    return pseudo


def create_sentence_embeds_template(tokenizer: Tokenizer, embedding_table, num_ranks,
                                    pseudo_sentence_tokens, max_num_tokens) -> np.ndarray:
    """Pad-filled template with sot, eot and full-stop embeddings."""
    ids, n = tokenizer("X.", return_raw_tokens=False, return_num_tokens=True)
    if n != 2 or ids[0] != tokenizer.bos_token_id or ids[3] != tokenizer.eos_token_id:
        raise ValueError("expected `X.` to encode as <sot> X . <eot>")
    pad, sot = embedding_table[tokenizer.pad_token_id], embedding_table[ids[0]]
    eot, full_stop = embedding_table[ids[3]], embedding_table[ids[2]]
    sentence = np.repeat(pad[None, None], num_ranks, axis=0)
    sentence = np.repeat(sentence, max_num_tokens, axis=1).astype(np.float32)
    eot_idx = pseudo_sentence_tokens.argmax(axis=-1)
    for i in range(num_ranks):
        sentence[i, 0] = sot
        sentence[i, eot_idx[i]] = eot
        sentence[i, eot_idx[i] - 1] = full_stop
    return sentence


def build_prompt_learner(method: str, cfg: dict, tokenizer: Tokenizer,
                         embedding_table: np.ndarray, max_num_tokens: int,
                         embedding_dim: int, generator: Optional[torch.Generator] = None):
    """A Plain or Rank CoOp prompt learner with its host-built constants."""
    num_ranks = cfg["num_ranks"]
    init_context, init_rank_names = load_init_prompt(
        cfg.get("init_prompt_path"), cfg.get("init_prompt_context_idx", 0),
        cfg.get("init_prompt_rank_idx", 0))
    rank_specific = bool(cfg.get("rank_specific_context", False))
    ctx, num_context_tokens = create_context_embeds(
        tokenizer, embedding_table, num_ranks, cfg.get("num_context_tokens", 8),
        init_context, rank_specific, embedding_dim)
    common = dict(rank_tokens_position=cfg.get("rank_tokens_position", "tail"),
                  rank_specific_context=rank_specific, embedding_dim=embedding_dim,
                  context_init=ctx, generator=generator)
    if method == "plain":
        ranks, ntr = create_rank_embeds(
            tokenizer, embedding_table, num_ranks, cfg.get("num_tokens_per_rank", 4),
            init_rank_names, num_context_tokens, max_num_tokens, embedding_dim)
        pseudo = create_pseudo_sentence_tokens(ntr, num_context_tokens, num_ranks,
                                               max_num_tokens)
        template = create_sentence_embeds_template(tokenizer, embedding_table, num_ranks,
                                                   pseudo, max_num_tokens)
        return PlainPromptLearner(num_ranks, num_context_tokens, ntr, template, pseudo,
                                  rank_init=ranks, **common)
    if method == "rank":
        num_base_ranks = cfg.get("num_base_ranks", 4)
        ranks, base_ntr = create_rank_embeds(
            tokenizer, embedding_table, num_base_ranks, cfg.get("num_tokens_per_rank", 4),
            init_rank_names, num_context_tokens, max_num_tokens, embedding_dim)
        ntr = [max(base_ntr)] * num_ranks  # every rank takes the longest base name
        pseudo = create_pseudo_sentence_tokens(ntr, num_context_tokens, num_ranks,
                                               max_num_tokens)
        template = create_sentence_embeds_template(tokenizer, embedding_table, num_ranks,
                                                   pseudo, max_num_tokens)
        interp = create_interpolation_weights(num_base_ranks, num_ranks,
                                              cfg.get("interpolation_type", "linear"))
        return RankPromptLearner(num_ranks, num_context_tokens, ntr, template, pseudo,
                                 rank_init=ranks, num_base_ranks=num_base_ranks,
                                 interpolation_weights=interp, **common)
    raise ValueError(f"unknown prompt learner method {method}")


def build_prompt_adapter(cfg: dict, tokenizer: Tokenizer,
                         encode_texts: Callable[[np.ndarray], np.ndarray],
                         generator: Optional[torch.Generator] = None) -> PromptAdapter:
    """A PromptAdapter whose frozen prompt features are the init sentences
    encoded once through the frozen tower (`encode_texts(ids) -> [P, D]`)."""
    num_prompts = cfg["num_prompts"]
    if cfg.get("pretrained_prompt_features") is not None:
        features = np.asarray(cfg["pretrained_prompt_features"])
        if len(features) != num_prompts:
            raise ValueError(f"expected {num_prompts} pretrained prompt features")
    else:
        if cfg.get("init_prompt_path"):
            _, texts = load_init_prompt(cfg["init_prompt_path"],
                                        cfg.get("init_prompt_context_idx", 0),
                                        cfg.get("init_prompt_rank_idx", 0), replace=True)
        elif cfg.get("load_path"):
            texts = load_init_text(cfg["load_path"], key=str(cfg.get("load_idx", 0)))
        else:
            raise ValueError("Specify `init_prompt_path` or `load_path`.")
        if len(texts) != num_prompts:
            raise ValueError(f"Expected {num_prompts} initial prompts, but got {len(texts)}.")
        features = np.asarray(encode_texts(
            tokenizer(texts, return_raw_tokens=False, return_num_tokens=False)))
    neg = None
    if cfg.get("load_negative_prompts"):
        if cfg.get("load_path") is None:
            raise ValueError("Found null `load_path`.")
        neg_texts = load_init_text(cfg["load_path"],
                                   key=cfg.get("load_negative_idx", "prompt_normal_tissue"))
        neg = np.asarray(encode_texts(tokenizer(
            neg_texts, return_raw_tokens=False, return_num_tokens=False))).mean(0, keepdims=True)
    return PromptAdapter(features, method=cfg.get("method", "default"),
                         num_prompts=num_prompts, neg_prompt_features=neg,
                         dim_reduction=cfg.get("dim_reduction", 4),
                         keep_ratio=cfg.get("keep_ratio", 0.8),
                         res_ratio=cfg.get("res_ratio", 0.5), generator=generator)
