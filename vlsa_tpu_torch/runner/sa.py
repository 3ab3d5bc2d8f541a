"""The SA handler (counterpart of vlsa_tpu/runner/sa.py) and its rules as
plain functions: labels, the head's width, the loss/converter pairing and
the DeepMIL model of a `task: sa` config
(configs/IFMLE/<cohort>/cfg_sa_base_conch.yaml).
"""
from __future__ import annotations

from ..config import fetch_kws, parse_str_dims
from ..data.label_converter import MetaSurvData
from ..eval import load_evaluator
from ..models.mil import DeepMIL
from ..models.registry import load_model
from .base import BaseHandler

# loss -> (net_output_converter, evaluator) it needs (vlsa_tpu/runner/sa.py:42-51)
_LOSS_PAIRING = {"SurvMLE": ("sigmoid", "NLL"), "SurvIFMLE": ("softmax", "NLL-IF"),
                 "SurvPLE": (None, "Cox")}


def build_surv_meta(cfg: dict, data_split: dict) -> MetaSurvData:
    """The label table: `time_format` interval or quantile gives discrete
    bins from the training split (and sets `time_bins` to their count),
    origin the times and ratio the times over the training split's largest,
    clipped at 1."""
    time_format = cfg["time_format"]
    if time_format not in ("origin", "ratio", "interval", "quantile"):
        raise ValueError(f"time_format must be origin, ratio, interval or quantile, "
                         f"got {time_format!r}")
    meta = MetaSurvData(cfg["path_table"], data_split=data_split)
    if time_format in ("origin", "ratio"):
        meta.generate_continuous_label(normalize=time_format == "ratio")
        return meta
    meta.generate_discrete_label(num_bins=cfg.get("time_bins"),
                                 use_quantiles=time_format == "quantile")
    if cfg.get("time_bins") not in (None, meta.num_bins):
        raise ValueError(f"time_bins {cfg['time_bins']} != the {meta.num_bins} bins made")
    cfg["time_bins"] = meta.num_bins
    return meta


def check_arguments(cfg: dict, pairing: dict = _LOSS_PAIRING) -> None:
    """Each survival loss pins its output converter and evaluator."""
    for loss, (converter, evaluator) in pairing.items():
        if loss in cfg["loss_type"]:
            if cfg.get("net_output_converter") != converter or cfg.get("evaluator") != evaluator:
                raise ValueError(f"{loss} needs net_output_converter={converter} and "
                                 f"evaluator={evaluator}")
            return


def correct_net_dims(cfg: dict, num_bins: int) -> None:
    """The head's width is the bin count: `net_dims` "512-256-4" becomes
    "512-256-<num_bins>"."""
    dims = parse_str_dims(cfg["net_dims"])
    if dims[-1] != num_bins:
        cfg["net_dims"] = "-".join(str(d) for d in dims[:-1]) + f"-{num_bins}"


def load_meta(cfg: dict, data_split: dict) -> MetaSurvData:
    """The fold's labels, with `net_dims` corrected to their bin count when
    they are discrete."""
    check_arguments(cfg)
    meta = build_surv_meta(cfg, data_split)
    if "discrete" in meta.label_format:
        correct_net_dims(cfg, meta.num_bins)
    return meta


def build_model(cfg: dict, device=None, state_dict=None) -> DeepMIL:
    """The config's DeepMIL (`arch: DeepMIL`, the `deepmil_*` keys, `net_dims`)
    with random weights from its seed, on `device`."""
    if cfg["arch"] != "DeepMIL":
        raise NotImplementedError(f"arch {cfg['arch']!r}: the SA path builds DeepMIL")
    arch_cfg = fetch_kws(cfg, prefix=cfg["arch"].lower())
    return load_model(cfg["arch"], parse_str_dims(cfg["net_dims"]), seed=cfg.get("seed", 0),
                      device=device, state_dict=state_dict, **arch_cfg)


class SAHandler(BaseHandler):
    """The SA baseline's run: DeepMIL with the NLL, NLL-IF, Cox or Reg
    evaluator, each training loss also computed again on the predictions
    (`load_meta` checks the loss/converter/evaluator pairing)."""

    def __init__(self, cfg, device=None, state_dict=None):
        if cfg["task"] != "sa":
            raise ValueError(f"Expected task = `sa` but got {cfg['task']}.")
        super().__init__(cfg, device=device, state_dict=state_dict)

    def func_load_evaluator(self, cfg, meta_data=None):
        assert cfg["evaluator"] in ("Reg", "NLL", "NLL-IF", "Cox")
        kws = {"backend": "SurvivalEVAL", "meta_data": meta_data}
        if cfg["evaluator"] == "Reg":
            kws = {"end_time": meta_data.max_t}
        evaluator = load_evaluator(cfg["task"], cfg["evaluator"], **kws)
        return evaluator, evaluator.valid_metrics, ["c_index", "loss"]

    def eval_kws(self) -> dict:
        if hasattr(self.evaluator, "_eval_ext_loss"):
            return {"kws_ext_loss": self.loss, "loss_weight": self.loss_weight}
        return {}
