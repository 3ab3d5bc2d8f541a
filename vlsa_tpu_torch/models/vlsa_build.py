"""VLSA construction (counterpart of vlsa_tpu/models/vlsa_build.py): the
CoOp rank prompt learner through the frozen CONCH tower, and VLFAN with
TaskRes text queries.

Weights come from a seeded `torch.Generator` on the CPU, so one seed gives
the same model on every device; `state_dict` (for example one bridged from
a vlsa_tpu parameter tree by utils.weights) replaces them, the tower's
before any text is encoded through it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import fetch_kws
from ..utils.device import disable_tf32, resolve_device
from .mil import VLFAN
from .precision import cast_frozen_tower_weights
from .prompt_build import build_prompt_adapter, build_prompt_learner
from .text_encoder import generate_pseudo_tokens, make_text_tower
from .tokenizer import Tokenizer
from .vlsa import CLIP_LOGIT_SCALE_INIT, VLSA, trim_length

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _prefixed(cfg: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in cfg.items() if k.startswith(prefix + "_")}


def build_mil_encoder(image_encoder_cfg: dict,
                      generator: Optional[torch.Generator] = None) -> VLFAN:
    name = image_encoder_cfg["name"]
    if name != "VLFAN":
        raise NotImplementedError(f"MIL encoder {name!r}: this port has VLFAN only")
    # dim_hid and drop_rate configure the attention query poolings, which
    # this port does not have yet
    return VLFAN(dim_in=image_encoder_cfg.get("dim_in", 512),
                 use_feat_proj=image_encoder_cfg.get("use_feat_proj", False),
                 query=image_encoder_cfg.get("query", "Parameter"),
                 num_query=int(image_encoder_cfg.get("num_query") or 10),
                 gated_query=bool(image_encoder_cfg.get("gated_query", False)),
                 query_pooling=image_encoder_cfg.get("query_pooling", "mean"),
                 pred_head=image_encoder_cfg.get("pred_head", "default"),
                 generator=generator)


def build_vlsa(text_encoder_cfg: dict, image_encoder_cfg: dict, prompt_learner_cfg: dict,
               vlsa_api: str = "CONCH", tower_overrides: Optional[dict] = None,
               seed: int = 0, device=None,
               state_dict: Optional[dict] = None) -> Tuple[VLSA, Tokenizer]:
    """Build the VLSA model on `device` (CUDA unless "cpu" is asked for)."""
    if vlsa_api != "CONCH":
        raise NotImplementedError(f"vlsa_api {vlsa_api!r}: this port has CONCH only")
    if prompt_learner_cfg["name"] != "CoOp" or prompt_learner_cfg.get("pretrained"):
        raise NotImplementedError("this port builds a CoOp prompt learner from scratch only")
    device = resolve_device(device)
    disable_tf32()
    generator = torch.Generator().manual_seed(seed)

    overrides = dict(tower_overrides or {})
    dtype = overrides.pop("dtype", None) or text_encoder_cfg.get("dtype") or "float32"
    overrides.pop("scan_layers", None)  # an XLA compile-time layout, same math
    tower = make_text_tower(generator=generator, compute_dtype=COMPUTE_DTYPES[dtype],
                            **overrides)
    if state_dict is not None:
        tower.load_state_dict({k[len("prompt_encoder."):]: v for k, v in state_dict.items()
                               if k.startswith("prompt_encoder.")})
    frozen = text_encoder_cfg.get("frozen", True)
    if frozen:
        tower.requires_grad_(False)
        if dtype == "bfloat16":
            cast_frozen_tower_weights(tower)
    emb_table = tower.token_embedding.detach().float().numpy()
    tower.to(device)
    tokenizer = Tokenizer()

    def encode_texts(token_ids: np.ndarray) -> np.ndarray:
        token_ids = np.asarray(token_ids)
        pseudo = generate_pseudo_tokens(token_ids[:, :-1], tokenizer.pad_token_id)
        with torch.inference_mode():
            out = tower(prompts_text=torch.as_tensor(token_ids, device=device),
                        prompts_pseudo_tokens=torch.as_tensor(pseudo, device=device))
        return out.float().cpu().numpy()

    prompt_learner = build_prompt_learner(
        prompt_learner_cfg.get("method", "rank"), prompt_learner_cfg, tokenizer, emb_table,
        tower.max_num_tokens, tower.width, generator=generator)
    mil_encoder = build_mil_encoder(image_encoder_cfg, generator=generator)
    query_adapter = None
    if mil_encoder.query == "Text":
        q_cfg = _prefixed(image_encoder_cfg, "query_text")
        q_cfg.update(num_prompts=mil_encoder.num_query,
                     load_negative_prompts=mil_encoder.gated_query)
        query_adapter = build_prompt_adapter(q_cfg, tokenizer, encode_texts,
                                             generator=generator)
    text_trim_len = None
    if prompt_learner_cfg.get("trim_prompts", True):
        text_trim_len = trim_length(prompt_learner.pseudo_sentence_tokens.numpy(),
                                    tower.max_num_tokens)
    model = VLSA(mil_encoder, prompt_encoder=tower, prompt_learner=prompt_learner,
                 query_adapter=query_adapter, logit_scale_init=CLIP_LOGIT_SCALE_INIT,
                 text_trim_len=text_trim_len)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval(), tokenizer


def build_vlsa_from_config(cfg: dict, seed: Optional[int] = None, device=None,
                           state_dict: Optional[dict] = None) -> Tuple[VLSA, Tokenizer]:
    """Build from a flat experiment config (the `vlsa_*` keys of
    configs/IFMLE/<cohort>/cfg_vlsa_conch.yaml, placeholders filled)."""
    arch = cfg["arch"].lower()
    pmt_name = cfg[f"{arch}_pmt_learner_name"]
    prompt_learner_cfg = fetch_kws(cfg, prefix=f"{arch}_pmt_learner_{pmt_name.lower()}")
    prompt_learner_cfg["name"] = pmt_name
    prompt_learner_cfg["pretrained"] = cfg.get(f"{arch}_pmt_learner_pretrained", False)
    return build_vlsa(
        text_encoder_cfg=fetch_kws(cfg, prefix=f"{arch}_txt_encoder"),
        image_encoder_cfg=fetch_kws(cfg, prefix=f"{arch}_img_encoder"),
        prompt_learner_cfg=prompt_learner_cfg, vlsa_api=cfg[f"{arch}_api"],
        tower_overrides=cfg.get("_test_tower_overrides"),
        seed=cfg.get("seed", 0) if seed is None else seed, device=device,
        state_dict=state_dict)
