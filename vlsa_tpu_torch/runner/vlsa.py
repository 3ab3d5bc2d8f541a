"""The VLSA handler (counterpart of vlsa_tpu/runner/vlsa.py): the flagship's
run with ordinal rank prompts, the VL or VL-IF evaluator, the QueryDiv loss
bound to the live model, and the training losses computed again on the
predictions with the live logit scale exp(logit_scale).  The config's
freeze flags (the text tower, and optionally the MIL encoder, the logit
scale, CoOp's embeddings) are applied by runner.train.frozen_paths.  With
`num_shot` > 0 the run trains on the few-shot sample that runner.train's
Trainer draws with `seed_shot` (vlsa_tpu/runner/vlsa.py:134-139)."""
from __future__ import annotations

from ..config import fetch_kws
from ..eval import load_evaluator
from . import sa
from .base import BaseHandler

# loss -> (net_output_converter, evaluator) it needs (vlsa_tpu/runner/vlsa.py:27-33)
_LOSS_PAIRING = {"SurvMLE": ("sigmoid", "VL"), "SurvIFMLE": ("softmax", "VL-IF")}


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
