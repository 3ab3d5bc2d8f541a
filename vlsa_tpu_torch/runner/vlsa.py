"""The VLSA handler (counterpart of vlsa_tpu/runner/vlsa.py): the
flagship's run with ordinal rank prompts, the VL or VL-IF evaluator, the
QueryDiv loss bound to the live model, and the training losses computed
again on the predictions with the live logit scale exp(logit_scale).  The
config's freeze flags (the text tower, and optionally the MIL encoder, the
logit scale, CoOp's embeddings) are applied by runner.train.frozen_paths.
With `num_shot` > 0 the run trains on the few-shot sample that
runner.train's Trainer draws with `seed_shot`
(vlsa_tpu/runner/vlsa.py:134-139); with `num_shot: 0` it trains nothing and
evaluates the test split zero-shot (runner.base).

`build_model` resolves what the model is built from: the released text
tower of `path_clip_model` and, for a `pretrained` CoOp learner, the
checkpoint `vlsa_pmt_learner_coop_ckpt` names.
"""
from __future__ import annotations

import os.path as osp
from typing import Optional

from ..config import fetch_kws
from ..eval import load_evaluator
from ..models.vlsa_build import build_vlsa_from_config
from ..utils.torch_import import import_text_tower_from_checkpoint
from . import sa
from .base import BaseHandler

# loss -> (net_output_converter, evaluator) it needs (vlsa_tpu/runner/vlsa.py:27-33)
_LOSS_PAIRING = {"SurvMLE": ("sigmoid", "VL"), "SurvIFMLE": ("softmax", "VL-IF")}


def clip_checkpoint_path(cfg: dict) -> Optional[str]:
    """The released checkpoint of `path_clip_model`: the first file that
    exists of the path itself, `<path>/pytorch_model.bin` and
    `<path>/<txt_encoder_name>/pytorch_model.bin`; None when the key is
    unset.  A path that names none of them raises (vlsa_tpu then carries on
    with a random tower)."""
    root = cfg.get("path_clip_model")
    if not root:
        return None
    arch = cfg["arch"].lower()
    candidates = [root, osp.join(root, "pytorch_model.bin"),
                  osp.join(root, cfg.get(f"{arch}_txt_encoder_name") or "", "pytorch_model.bin")]
    found = next((c for c in candidates if osp.isfile(c)), None)
    if found is None:
        raise FileNotFoundError(f"path_clip_model {root!r}: none of {candidates} is a file")
    return found


def coop_checkpoint_cfg(cfg: dict) -> Optional[dict]:
    """The `vlsa_pmt_learner_coop_*` keys with `ckpt` formatted by the fold
    (`data_split_seed`) and the CoOp method, for a `pretrained` learner;
    else None."""
    if not cfg.get("vlsa_pmt_learner_pretrained"):
        return None
    out = fetch_kws(cfg, prefix="vlsa_pmt_learner_coop")
    if not out.get("ckpt"):
        raise ValueError("Found null ckpt path.")
    out["ckpt"] = out["ckpt"].format(cfg["data_split_seed"], out.get("method"))
    return out


def build_model(cfg: dict, device=None, state_dict: Optional[dict] = None):
    """The config's VLSA model: the text tower imported from
    `path_clip_model` when it is set, a `pretrained` CoOp learner
    warm-started from its checkpoint."""
    path = clip_checkpoint_path(cfg)
    vl_weights = None
    if path is not None:
        vl_weights = import_text_tower_from_checkpoint(path, api=cfg[f"{cfg['arch'].lower()}_api"])
        print(f"[setup] frozen text-tower weights imported from {path}")
    model, _tok = build_vlsa_from_config(cfg, device=device, state_dict=state_dict,
                                         vl_weights=vl_weights,
                                         pretrained_prompt_learner_cfg=coop_checkpoint_cfg(cfg))
    return model


class VLSAHandler(BaseHandler):
    def __init__(self, cfg, device=None, state_dict=None):
        if cfg["task"] != "vlsa":
            raise ValueError(f"Expected task = `vlsa` but got {cfg['task']}.")
        super().__init__(cfg, device=device, state_dict=state_dict)

    def _check_arguments(self, cfg):
        sa.check_arguments(cfg, _LOSS_PAIRING)

    def func_load_evaluator(self, cfg, meta_data=None):
        assert cfg["evaluator"] in ("VL", "VL-IF")
        evaluator = load_evaluator(cfg["task"], cfg["evaluator"],
                                   backend="SurvivalEVAL", meta_data=meta_data)
        return evaluator, evaluator.valid_metrics, ["c_index", "loss"]

    def add_network_loss(self, cfg):
        """Bind QueryDiv to the live model's prompt-diversity regulariser."""
        if "QueryDiv" in self.loss:
            assert self.loss["QueryDiv"] is None
            kws = fetch_kws(cfg, prefix="loss_querydiv")
            kws.pop("weight", None)  # the objective's weight, not the regulariser's
            model = self.model

            def qd(**extra):
                return model.query_div_loss(**{**kws, **extra})

            self.loss["QueryDiv"] = qd

    def eval_kws(self) -> dict:
        return {"kws_ext_loss": self.loss, "loss_weight": self.loss_weight,
                "logit_scale": self.get_logit_scale_value()}
