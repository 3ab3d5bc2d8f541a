"""Decode-time logits processing and grouped beam search for CoCa caption
generation (counterpart of vlsa_tpu/models/generation.py, kept as this
package's own host code).

The processors follow the HuggingFace ones CoCa's `generate` wires in
(MinLengthLogitsProcessor, RepetitionPenaltyLogitsProcessor, the TopK and
TopP logits warpers); `beam_search` is open_clip's `generate_beamsearch`
with HF `BeamSearchScorer` bookkeeping (length_penalty 1.0,
early_stopping False, 2 * group_size candidates a step, eos-terminated
hypotheses, per-group reordering).  Everything here is numpy on the host,
as in vlsa_tpu, with its dtypes, its `np.argpartition` then stable sort and
its order of tie-breaks, so that the same logits give the same tokens.

No diversity term is applied between groups by default (open_clip installs
no HammingDiversityLogitsProcessor); `diversity_penalty > 0` turns on the
HF Hamming diversity semantics.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

NEG_INF = float("-inf")


# ---------------------------------------------------------------- processors

def min_length_process(logits: np.ndarray, cur_len: int, min_len: int,
                       eos_token_id: int) -> np.ndarray:
    """MinLengthLogitsProcessor: forbid <eos> while cur_len < min_len."""
    if cur_len < min_len:
        logits = logits.copy()
        logits[:, eos_token_id] = NEG_INF
    return logits


def repetition_penalty_process(logits: np.ndarray, prev_ids: np.ndarray,
                               penalty: float) -> np.ndarray:
    """RepetitionPenaltyLogitsProcessor: for every token already generated
    in its row, score/penalty if positive else score*penalty."""
    if penalty == 1.0:
        return logits
    logits = logits.copy()
    for b in range(logits.shape[0]):
        ids = np.unique(prev_ids[b])
        s = logits[b, ids]
        logits[b, ids] = np.where(s < 0, s * penalty, s / penalty)
    return logits


def top_k_warp(logits: np.ndarray, top_k: int,
               min_tokens_to_keep: int = 1) -> np.ndarray:
    """TopKLogitsWarper: mask everything below the k-th largest logit."""
    k = min(max(top_k, min_tokens_to_keep), logits.shape[-1])
    kth = np.partition(logits, -k, axis=-1)[:, -k][:, None]
    return np.where(logits < kth, NEG_INF, logits)


def top_p_warp(logits: np.ndarray, top_p: float,
               min_tokens_to_keep: int = 1) -> np.ndarray:
    """TopPLogitsWarper: keep the smallest prefix of descending-probability
    tokens whose cumulative probability exceeds top_p (ascending sort,
    remove while cumprob <= 1-top_p, always keep the `min_tokens_to_keep`
    most probable)."""
    sort_idx = np.argsort(logits, axis=-1)              # ascending
    sorted_logits = np.take_along_axis(logits, sort_idx, axis=-1)
    m = sorted_logits.max(-1, keepdims=True)
    p = np.exp(sorted_logits - m)
    p /= p.sum(-1, keepdims=True)
    cum = np.cumsum(p, axis=-1)
    remove = cum <= (1.0 - top_p)
    remove[:, -min_tokens_to_keep:] = False
    mask = np.zeros_like(remove)
    np.put_along_axis(mask, sort_idx, remove, axis=-1)
    return np.where(mask, NEG_INF, logits)


def log_softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max(-1, keepdims=True)
    z = logits - m
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


# --------------------------------------------------------------- beam search

class _BeamHypotheses:
    """HF BeamHypotheses with length_penalty=1.0, early_stopping=False."""

    def __init__(self, num_beams: int):
        self.num_beams = num_beams
        self.beams: List[Tuple[float, np.ndarray]] = []
        self.worst_score = 1e9

    def add(self, hyp: np.ndarray, sum_logprobs: float) -> None:
        score = sum_logprobs / max(hyp.shape[-1], 1) ** 1.0
        if len(self.beams) < self.num_beams or score > self.worst_score:
            self.beams.append((score, hyp))
            if len(self.beams) > self.num_beams:
                worst = min(range(len(self.beams)),
                            key=lambda i: self.beams[i][0])
                del self.beams[worst]
                self.worst_score = min(s for s, _ in self.beams)
            else:
                self.worst_score = min(score, self.worst_score)

    def is_done(self, best_sum_logprobs: float, cur_len: int) -> bool:
        if len(self.beams) < self.num_beams:
            return False
        return self.worst_score >= best_sum_logprobs / cur_len ** 1.0


def beam_search(step_fn: Callable[[np.ndarray], np.ndarray],
                batch_size: int,
                seq_len: int,
                sot_token_id: int = 1,
                eos_token_id: int = 2,
                pad_token_id: int = 0,
                num_beams: int = 6,
                num_beam_groups: int = 3,
                min_seq_len: int = 5,
                repetition_penalty: float = 1.0,
                diversity_penalty: float = 0.0) -> np.ndarray:
    """Grouped beam search.

    `step_fn(ids [R, L]) -> next-token logits [R, V]` is called once a
    position on all R = batch * num_beams rows.  Returns [batch, <=seq_len]
    sequences: the best finished hypothesis of each batch element.
    """
    assert num_beams % num_beam_groups == 0, \
        "num_beams must be divisible by num_beam_groups"
    group_size = num_beams // num_beam_groups
    R = batch_size * num_beams

    ids = np.full((R, 1), sot_token_id, np.int64)
    beam_scores = np.full((batch_size, num_beams), -1e9, np.float64)
    beam_scores[:, ::group_size] = 0.0   # one live beam per group
    beam_scores = beam_scores.reshape(R)

    hyps = [[_BeamHypotheses(group_size) for _ in range(num_beam_groups)]
            for _ in range(batch_size)]
    done = np.zeros((batch_size, num_beam_groups), bool)

    cur_len = 1
    while cur_len < seq_len and not done.all():
        logits = np.asarray(step_fn(ids), np.float64)         # [R, V]
        V = logits.shape[-1]
        current_tokens = np.zeros(R, np.int64)
        new_ids = np.concatenate(
            [ids, np.full((R, 1), pad_token_id, np.int64)], axis=1)

        for g in range(num_beam_groups):
            g0 = g * group_size
            rows = np.concatenate(
                [b * num_beams + g0 + np.arange(group_size)
                 for b in range(batch_size)])               # [B*group_size]
            group_ids = ids[rows]
            scores = log_softmax(logits[rows])               # [B*gs, V]
            scores = min_length_process(scores, cur_len, min_seq_len,
                                        eos_token_id)
            scores = repetition_penalty_process(scores, group_ids,
                                                repetition_penalty)
            if diversity_penalty > 0.0 and g > 0:
                # HammingDiversityLogitsProcessor: penalize tokens already
                # chosen by earlier groups at this position
                for b in range(batch_size):
                    prev = current_tokens[b * num_beams: b * num_beams + g0]
                    counts = np.bincount(prev, minlength=V)
                    sl = slice(b * group_size, (b + 1) * group_size)
                    scores[sl] -= diversity_penalty * counts

            cand = scores + beam_scores[rows][:, None]       # [B*gs, V]
            cand = cand.reshape(batch_size, group_size * V)
            k = 2 * group_size
            top_idx = np.argpartition(cand, -k, axis=1)[:, -k:]
            top_val = np.take_along_axis(cand, top_idx, axis=1)
            order = np.argsort(-top_val, axis=1, kind="stable")
            top_val = np.take_along_axis(top_val, order, axis=1)
            top_idx = np.take_along_axis(top_idx, order, axis=1)
            next_beam = top_idx // V                          # in-group beam
            next_tok = top_idx % V

            # BeamSearchScorer.process
            for b in range(batch_size):
                brow = b * num_beams
                if done[b, g]:
                    beam_scores[brow + g0: brow + g0 + group_size] = 0.0
                    new_ids[brow + g0: brow + g0 + group_size, -1] = pad_token_id
                    current_tokens[brow + g0: brow + g0 + group_size] = pad_token_id
                    continue
                kept = 0
                kept_scores = np.zeros(group_size)
                kept_rows = np.zeros(group_size, np.int64)
                kept_toks = np.zeros(group_size, np.int64)
                for rank in range(k):
                    tok = int(next_tok[b, rank])
                    sc = float(top_val[b, rank])
                    src = int(next_beam[b, rank])
                    if tok == eos_token_id:
                        if rank >= group_size:
                            continue  # only top group_size eos finalize
                        hyps[b][g].add(
                            group_ids[b * group_size + src].copy(), sc)
                    else:
                        kept_scores[kept] = sc
                        kept_rows[kept] = src
                        kept_toks[kept] = tok
                        kept += 1
                    if kept == group_size:
                        break
                assert kept == group_size, "beam candidates exhausted"
                dst = slice(brow + g0, brow + g0 + group_size)
                beam_scores[dst] = kept_scores
                src_rows = rows[b * group_size + kept_rows]
                new_ids[dst, :-1] = ids[src_rows]
                new_ids[dst, -1] = kept_toks
                current_tokens[dst] = kept_toks
                done[b, g] = hyps[b][g].is_done(
                    float(top_val[b].max()), cur_len)

        ids = new_ids
        cur_len += 1

    # finalize: open beams of unfinished groups become hypotheses
    for b in range(batch_size):
        for g in range(num_beam_groups):
            if done[b, g]:
                continue
            for j in range(group_size):
                row = b * num_beams + g * group_size + j
                hyps[b][g].add(ids[row, :].copy(), float(beam_scores[row]))

    # best hypothesis per batch element, padded to a rectangle
    best: List[np.ndarray] = []
    for b in range(batch_size):
        pool = [beam for g in range(num_beam_groups)
                for beam in hyps[b][g].beams]
        best.append(max(pool, key=lambda x: x[0])[1])
    max_len = min(max(h.shape[-1] for h in best) + 1, seq_len)
    out = np.full((batch_size, max_len), pad_token_id, np.int64)
    for b, h in enumerate(best):
        L = min(h.shape[-1], max_len)
        out[b, :L] = h[:L]
        if L < max_len:
            out[b, L] = eos_token_id
    return out
