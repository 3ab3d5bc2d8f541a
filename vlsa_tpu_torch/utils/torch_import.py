"""Reference torch checkpoints -> this package's state dicts (counterpart of
vlsa_tpu/utils/torch_import.py, whose output is a Flax tree).

  * `load_torch_state_dict`: a checkpoint file -> {name: f32 tensor}, the
    one loader of the package (the text tower, the CONCH visual model, CoOp
    warm starts);
  * `import_text_tower_state` / `import_text_tower_from_checkpoint`: the
    text tower of a released checkpoint (mahmoodlab/conch
    `pytorch_model.bin`, a CoCa state dict with the tower under `text.*`,
    or an OpenAI-CLIP-style one with it at the top level and no `cls_emb`,
    the CLIP and HF apis') -> `TextTower`'s names;
  * `import_vlsa_learnable_state`: the reference's learnable-parameter
    training checkpoint (logit scale, CoOp embeddings, VLFAN's adapter,
    TaskRes query residuals, ...) onto a VLSA state dict;
  * `import_deepmil_state`: a reference DeepMIL/ABMIL checkpoint -> the SA
    baseline's state dict.

The results load with `strict=True`, so a tower whose width or depth
differs from the checkpoint's raises there (vlsa_tpu installs whatever
shapes the file has).  DSMIL's reference keys, which vlsa_tpu maps
nowhere either, raise, as does any other key with no counterpart; vlsa_tpu
prints a warning and drops them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

# reference-name prefixes of DSMIL's checkpoint keys: vlsa_tpu's importer
# maps none of them (it warns and drops them), so neither does this one
_UNMAPPED = ("i_classifier.", "b_classifier.")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint -> {name: f32 tensor on the CPU}: the `model` entry
    of a training checkpoint ({"model": ..., "epoch": ...}) or the state
    dict itself; entries that are not tensors are dropped.

    Read with `weights_only=True`, which unpickles tensors, containers and
    plain values only: a released `pytorch_model.bin` and a reference
    training checkpoint load; a file that pickles code objects (a whole
    `nn.Module`, an optimizer class, an argparse Namespace, numpy arrays)
    is refused by `torch.load`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().float() for k, v in state.items() if isinstance(v, torch.Tensor)}


def _refuse(key: str, what: str) -> None:
    for prefix in _UNMAPPED:
        if key.startswith(prefix) or f".{prefix}" in key:
            raise NotImplementedError(f"{what} key {key!r} is a reference DSMIL key: vlsa_tpu "
                                      f"maps no DSMIL key either (it warns and drops them)")
    raise ValueError(f"{what} key {key!r} has no counterpart in this package")


def import_text_tower_state(state: Mapping[str, torch.Tensor], layers: int,
                            prefix: str = "") -> Dict[str, torch.Tensor]:
    """CONCH/CLIP text-transformer keys (under `prefix`) -> `TextTower`'s
    state dict for `layers` blocks; `cls_emb` when the checkpoint has one."""
    def g(k):
        return state[prefix + k].contiguous()

    out = {"token_embedding": g("token_embedding.weight"),
           "positional_embedding": g("positional_embedding"),
           "text_projection": g("text_projection"),
           "ln_final.weight": g("ln_final.weight"), "ln_final.bias": g("ln_final.bias")}
    if prefix + "cls_emb" in state:
        out["cls_emb"] = g("cls_emb")
    names = {"ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
             "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
             "attn.in_proj_weight": "attn.in_proj_weight",
             "attn.in_proj_bias": "attn.in_proj_bias",
             "attn.out_proj_weight": "attn.out_proj.weight",
             "attn.out_proj_bias": "attn.out_proj.bias",
             "c_fc_weight": "mlp.c_fc.weight", "c_fc_bias": "mlp.c_fc.bias",
             "c_proj_weight": "mlp.c_proj.weight", "c_proj_bias": "mlp.c_proj.bias"}
    for i in range(layers):
        for ours, theirs in names.items():
            out[f"resblocks.{i}.{ours}"] = g(f"transformer.resblocks.{i}.{theirs}")
    return out


def import_text_tower_from_checkpoint(path: str, api: str = "CONCH") -> dict:
    """The frozen text tower of a released checkpoint file: {"text_state":
    TextTower's state dict, "logit_scale": the checkpoint's (log) logit
    scale, when it has one}.  The tower's keys are under `text.` when any
    key is (CoCa), else at the top level (CLIP); the block count is read
    from the keys; `visual.*`, `text_decoder.*` and every other key are
    ignored."""
    if api not in ("CONCH", "CLIP", "HF"):
        raise ValueError(f"Got an invalid api ({api}).")
    state = load_torch_state_dict(path)
    prefix = "text." if any(k.startswith("text.") for k in state) else ""
    marker = prefix + "transformer.resblocks."
    layer_ids = {int(k[len(marker):].split(".")[0]) for k in state if k.startswith(marker)}
    if not layer_ids:
        raise ValueError(f"no text-transformer blocks in {path}")
    out = {"text_state": import_text_tower_state(state, max(layer_ids) + 1, prefix)}
    if "logit_scale" in state:
        out["logit_scale"] = float(state["logit_scale"].reshape(()))
    return out


# reference name -> this package's (VLSA), torch layouts on both sides
_VLSA_NAMES = {
    "logit_scale": "logit_scale",
    "prompt_learner.context_embeds": "prompt_learner.context_embeds",
    "prompt_learner.rank_embeds": "prompt_learner.rank_embeds",
    "mil_encoder.visual_adapter.weight": "mil_encoder.visual_adapter.weight",
    "mil_encoder.visual_adapter.bias": "mil_encoder.visual_adapter.bias",
    "mil_encoder.Q.residual_features": "query_adapter.residual_features",
    "mil_encoder.Q.neg_residual_features": "query_adapter.neg_residual_features",
    "mil_encoder.Q": "mil_encoder.Q",
    "mil_encoder.feat_proj.projecter.0.weight": "mil_encoder.feat_proj.linear.weight",
    "mil_encoder.feat_proj.projecter.0.bias": "mil_encoder.feat_proj.linear.bias",
    "mil_encoder.feat_proj.projecter.1.weight": "mil_encoder.feat_proj.norm.weight",
    "mil_encoder.feat_proj.projecter.1.bias": "mil_encoder.feat_proj.norm.bias",
    "mil_encoder.query_pooling": "mil_encoder.query_pool_weight",
}


def import_vlsa_learnable_state(state_dict: Mapping[str, torch.Tensor],
                                ref_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state_dict` (a VLSA model's) with the reference checkpoint's
    learnable parameters put in place of their counterparts, each in the
    dtype of the entry it replaces; a new dict."""
    out = dict(state_dict)
    for k, v in ref_state.items():
        if k not in _VLSA_NAMES:
            _refuse(k, "VLSA")
        name = _VLSA_NAMES[k]
        if name not in out:
            raise KeyError(f"{k} maps to {name}, which the model does not have")
        out[name] = v.detach().to(out[name].dtype).clone()
    return out


def import_deepmil_state(ref_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference DeepMIL/ABMIL checkpoint -> the SA baseline's state dict
    (`models.mil.DeepMIL`; the ABMIL pooling keeps vlsa_tpu's [in, out]
    kernels, the gated pooling's Linears torch's [out, in])."""
    direct = {"feat_proj.projecter.0.weight": "feat_proj.linear.weight",
              "feat_proj.projecter.0.bias": "feat_proj.linear.bias",
              "feat_proj.projecter.1.weight": "feat_proj.norm.weight",
              "feat_proj.projecter.1.bias": "feat_proj.norm.bias",
              "sigma.attention.0.bias": "sigma.fc1_bias",
              "sigma.attention.2.bias": "sigma.fc2_bias",
              "sigma.fc1.0.weight": "sigma.fc1.weight", "sigma.fc1.0.bias": "sigma.fc1.bias",
              "sigma.score.0.weight": "sigma.score.weight",
              "sigma.score.0.bias": "sigma.score.bias",
              "sigma.fc2.weight": "sigma.fc2.weight", "sigma.fc2.bias": "sigma.fc2.bias",
              "g.weight": "g.weight", "g.bias": "g.bias",
              "visual_adapter.fc.0.weight": "visual_adapter.fc1.weight",
              "visual_adapter.fc.2.weight": "visual_adapter.fc2.weight"}
    transposed = {"sigma.attention.0.weight": "sigma.fc1_kernel",
                  "sigma.attention.2.weight": "sigma.fc2_kernel"}
    out: Dict[str, torch.Tensor] = {}
    for k, v in ref_state.items():
        if k in direct:
            out[direct[k]] = v.detach().float().contiguous()
        elif k in transposed:
            out[transposed[k]] = v.detach().float().T.contiguous()
        else:
            _refuse(k, "DeepMIL")
    return out

