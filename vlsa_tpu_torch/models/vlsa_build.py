"""VLSA construction (counterpart of vlsa_tpu/models/vlsa_build.py): the
CONCH text tower, random or imported from a released checkpoint; a CoOp
prompt learner (plain or rank, optionally warm-started from a
CoOp-pretrained checkpoint) through the tower, or, with both of its
embeddings frozen, its prompts encoded once; or the PromptAdapter over the
template prompts; VLFAN with TaskRes text queries, or FeatMIL for zero-shot
scoring.

Weights come from a seeded `torch.Generator` on the CPU, so one seed gives
the same model on every device.  `vl_weights` (utils.torch_import's import
of a released checkpoint) replaces the tower's before any text is encoded
through it and sets the initial logit scale; `state_dict` (for example one
bridged from a vlsa_tpu parameter tree by utils.weights) replaces the
model's, its `prompt_encoder.*` entries the tower's first.  The tower is a
submodule only when the CoOp prompts run through it at every call.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import fetch_kws
from ..utils.device import disable_tf32, resolve_device
from ..utils.torch_import import load_torch_state_dict
from .mil import DSMIL, VLFAN, DeepMIL, FeatMIL
from .mil_ext import ILRA, TransMIL
from .precision import cast_frozen_tower_weights
from .prompt_build import build_prompt_adapter, build_prompt_learner
from .text_encoder import generate_pseudo_tokens, make_text_tower
from .tokenizer import Tokenizer
from .vlsa import CLIP_LOGIT_SCALE_INIT, VLSA, trim_length

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOWER = "prompt_encoder."


def _prefixed(cfg: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in cfg.items() if k.startswith(prefix + "_")}


def build_mil_encoder(image_encoder_cfg: dict, generator: Optional[torch.Generator] = None,
                      seed: int = 0) -> Union[VLFAN, DeepMIL, DSMIL, FeatMIL, TransMIL, ILRA]:
    """The MIL encoder of the image-encoder config; `seed` seeds its
    Dropout."""
    name = image_encoder_cfg["name"]
    if name == "FeatMIL":
        return FeatMIL(pooling=image_encoder_cfg.get("feat_pooling", "identity"))
    common = dict(dim_in=image_encoder_cfg.get("dim_in", 512),
                  dim_hid=image_encoder_cfg.get("dim_hid", 256),
                  use_feat_proj=image_encoder_cfg.get("use_feat_proj", False),
                  drop_rate=image_encoder_cfg.get("drop_rate", 0.25),
                  generator=generator, dropout_seed=seed)
    if name == "VLFAN":
        return VLFAN(**common, query=image_encoder_cfg.get("query", "Parameter"),
                     num_query=int(image_encoder_cfg.get("num_query") or 10),
                     gated_query=bool(image_encoder_cfg.get("gated_query", False)),
                     query_pooling=image_encoder_cfg.get("query_pooling", "mean"),
                     pred_head=image_encoder_cfg.get("pred_head", "default"))
    if name == "DeepMIL":
        return DeepMIL(**common, num_cls=image_encoder_cfg.get("num_cls", 2),
                       pooling=image_encoder_cfg.get("mil_pooling", "attention"),
                       pred_head=image_encoder_cfg.get("pred_head", "default"),
                       dim_reduction=image_encoder_cfg.get("dim_reduction", 4),
                       keep_ratio=image_encoder_cfg.get("keep_ratio", 0.8))
    if name == "DSMIL":
        return DSMIL(**common, num_cls=image_encoder_cfg.get("num_cls", 2))
    if name == "TransMIL":
        return TransMIL(dim_in=common["dim_in"], dim_hid=common["dim_hid"],
                        num_cls=image_encoder_cfg.get("num_cls", 2), generator=generator,
                        dropout_seed=seed)
    if name == "ILRA":  # vlsa_tpu builds it with ILRA's defaults
        return ILRA(dim_in=common["dim_in"], dim_hid=common["dim_hid"],
                    num_cls=image_encoder_cfg.get("num_cls", 2), generator=generator)
    raise ValueError(f"Got an invalid MIL encoder name: {name}.")


def build_vlsa(text_encoder_cfg: dict, image_encoder_cfg: dict, prompt_learner_cfg: dict,
               vlsa_api: str = "CONCH", tower_overrides: Optional[dict] = None,
               seed: int = 0, device=None, state_dict: Optional[dict] = None,
               vl_weights: Optional[dict] = None,
               pretrained_prompt_learner_cfg: Optional[dict] = None) -> Tuple[VLSA, Tokenizer]:
    """Build the VLSA model on `device` (CUDA unless "cpu" is asked for).
    `pretrained_prompt_learner_cfg["ckpt"]`: the CoOp-pretrained checkpoint
    a `pretrained` CoOp learner starts from."""
    if vlsa_api != "CONCH":
        raise NotImplementedError(f"vlsa_api {vlsa_api!r}: this port has CONCH only "
                                  f"(ROADMAP.md §A.15)")
    pmt_name = prompt_learner_cfg["name"]
    if pmt_name not in ("CoOp", "Adapter"):
        raise ValueError(f"{pmt_name} is not a valid name of prompt learner.")
    device = resolve_device(device)
    disable_tf32()
    generator = torch.Generator().manual_seed(seed)

    overrides = dict(tower_overrides or {})
    dtype = overrides.pop("dtype", None) or text_encoder_cfg.get("dtype") or "float32"
    overrides.pop("scan_layers", None)  # an XLA compile-time layout, same math
    tower = make_text_tower(generator=generator, compute_dtype=COMPUTE_DTYPES[dtype],
                            **overrides)
    if vl_weights is not None:
        tower.load_state_dict(vl_weights["text_state"], strict=True)
    if state_dict is not None and any(k.startswith(_TOWER) for k in state_dict):
        tower.load_state_dict({k[len(_TOWER):]: v for k, v in state_dict.items()
                               if k.startswith(_TOWER)})
    if text_encoder_cfg.get("frozen", True):
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

    prompt_learner = prompt_adapter = pretrained_text_features = None
    if pmt_name == "CoOp":
        warm = {}
        if prompt_learner_cfg.get("pretrained"):
            # warm start from a CoOp-pretrained run's checkpoint (its "model")
            if not (pretrained_prompt_learner_cfg or {}).get("ckpt"):
                raise ValueError("Found null ckpt path.")
            ckpt = load_torch_state_dict(pretrained_prompt_learner_cfg["ckpt"])
            warm = {"context_init": ckpt["prompt_learner.context_embeds"].numpy(),
                    "rank_init": ckpt["prompt_learner.rank_embeds"].numpy()}
        prompt_learner = build_prompt_learner(
            prompt_learner_cfg.get("method", "rank"), prompt_learner_cfg, tokenizer,
            emb_table, tower.max_num_tokens, tower.width, generator=generator, **warm)
        if (prompt_learner_cfg.get("pretrained")
                and prompt_learner_cfg.get("frozen_context_embeds")
                and prompt_learner_cfg.get("frozen_rank_embeds")):
            # nothing of the prompts trains: encode them once (full length)
            prompt_learner.to(device)
            with torch.inference_mode():
                pretrained_text_features = tower(
                    prompts_embedding=prompt_learner(),
                    prompts_pseudo_tokens=prompt_learner.pseudo_sentence_tokens
                ).float().cpu().numpy()
            prompt_learner = None
    else:
        adapter_cfg = dict(prompt_learner_cfg, num_prompts=prompt_learner_cfg["num_ranks"])
        prompt_adapter = build_prompt_adapter(adapter_cfg, tokenizer, encode_texts,
                                              generator=generator)

    mil_encoder = build_mil_encoder(image_encoder_cfg, generator=generator, seed=seed)
    query_adapter = None
    if isinstance(mil_encoder, VLFAN) and mil_encoder.query == "Text":
        q_cfg = _prefixed(image_encoder_cfg, "query_text")
        q_cfg.update(num_prompts=mil_encoder.num_query,
                     load_negative_prompts=mil_encoder.gated_query)
        query_adapter = build_prompt_adapter(q_cfg, tokenizer, encode_texts,
                                             generator=generator)
    text_trim_len = None
    if prompt_learner is not None and prompt_learner_cfg.get("trim_prompts", True):
        text_trim_len = trim_length(prompt_learner.pseudo_sentence_tokens.numpy(),
                                    tower.max_num_tokens)
    logit_scale_init = (vl_weights or {}).get("logit_scale", CLIP_LOGIT_SCALE_INIT)
    model = VLSA(mil_encoder, prompt_encoder=tower if prompt_learner is not None else None,
                 prompt_learner=prompt_learner, prompt_adapter=prompt_adapter,
                 query_adapter=query_adapter,
                 pooling=image_encoder_cfg.get("pooling", "logit_mean"),
                 logit_scale_init=logit_scale_init,
                 pretrained_text_features=pretrained_text_features,
                 text_trim_len=text_trim_len)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval(), tokenizer


def build_vlsa_from_config(cfg: dict, seed: Optional[int] = None, device=None,
                           state_dict: Optional[dict] = None,
                           vl_weights: Optional[dict] = None,
                           pretrained_prompt_learner_cfg: Optional[dict] = None
                           ) -> Tuple[VLSA, Tokenizer]:
    """Build from a flat experiment config (the `vlsa_*` keys of
    configs/IFMLE/<cohort>/cfg_vlsa_conch.yaml, placeholders filled);
    `vl_weights` and the CoOp checkpoint are the runner's to resolve
    (runner.vlsa.build_model)."""
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
        state_dict=state_dict, vl_weights=vl_weights,
        pretrained_prompt_learner_cfg=pretrained_prompt_learner_cfg)
