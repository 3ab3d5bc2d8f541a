"""Multi-process runs of the port (vlsa_tpu_torch/parallel) against
vlsa_tpu's mesh on the 8 virtual CPU devices tests/conftest.py sets up.

Four gloo ranks on the CPU (torch.multiprocessing, spawned once for the
module, joined through a file) run, on a data x model grid of {data: 2, model: 2},
{data: 1, model: 4} or {data: 4, model: 1}:

  (a) the sequence-parallel pools, `coattn_pool_sp` (the plain versions of
      rows 1, 5 and 6 on each rank's chunk, merged) and `abmil_pool_sp`
      (rows 7 and 8), f32 and bf16 storage, on bags with 10% of the patches
      masked, an empty bag and one whose valid patches all lie in the first
      rank's chunk: the output and the gradients against
      `vlsa_tpu.parallel.coattn_pool_sp` / `abmil_pool_sp` and against the
      port's single-process plain pool;
  (b) the SA train step (DeepMIL/ABMIL, ABMIL routed on a model axis)
      against vlsa_tpu's TrainEngine on the same mesh
      (tests/test_parallel.py::test_sa_train_step_model_axis_matches_dp),
      also with SurvPLE (a loss that couples the bags) on a ragged batch;
  (c) the tiny flagship VLSA on {data: 2, model: 2} with the text tower
      tensor parallel, the co-attention sequence parallel and QueryDiv in
      the loss, against vlsa_tpu's mesh step and the port's single-process
      step, with the tower in f32 and in bf16 (there beside vlsa_tpu's own
      gap between its mesh and its one device);
  (d) BagBatcher's per-rank slices against vlsa_tpu's, batch for batch;
  (e) what a mesh ran only on one device before (ROADMAP.md §A.18): an
      adahessian step of the SA model on {data: 4, model: 1} and of the
      tiny flagship on {data: 2, model: 2} with TP and SP (its Hessian
      estimate through the collectives' own derivatives and the SP pools'
      plain shard_fn), z drawn from vlsa_tpu's key as
      tests/test_torch_adahessian.py draws it; and SurvPLE (a loss that
      couples the bags) with accum_steps 2 on {4, 1} and {2, 2} and 4 on
      {4, 1} (micro-batches of 2 rows, fewer than the data ranks), each
      rank fed its shares of vlsa_tpu's contiguous micro-batches
      (`BagBatcher.micro_rows`), and SurvIFMLE (a loss of each bag) through
      the same layout; each against vlsa_tpu's TrainEngine (or its
      Hutchinson estimate) on the same mesh.

The rank workers are module-level functions and import nothing of JAX:
vlsa_tpu is imported in the test bodies only.
"""
import functools
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# (a): co-attention q [P, C] x [B, N, C]; ABMIL x [B, N, D], W1 [HID, D]
B, N, C, P, SCALE = 4, 64, 16, 5, 3.0
D_AB, HID = 32, 16
POOL_CASES = [(pool, dt, dx) for pool in ("coattn", "abmil") for dt in ("f32", "bf16")
              for dx in (False, True)]
# (b): vlsa_tpu's SA mesh test: K bins, D features, B bags of N patches
SA_K, SA_D, SA_B, SA_N, SA_LR = 4, 32, 8, 256, 1e-2
SA_CASES = [("SurvIFMLE", False), ("SurvPLE", True)]
# (c): the tiny flagship tower of tests/test_torch_vlsa.py
TOWER = {"dtype": "float32", "width": 64, "heads": 4, "layers": 2, "output_dim": 512}
TOWERS = {"f32": TOWER, "bf16": dict(TOWER, dtype="bfloat16")}
VL_B, VL_N, VL_LR = 4, 64, 1.0
# vlsa_tpu's gradients are read off one SGD step of this rate: p0 - p1 = rate * g,
# so the rounding of p1 is a 6e-8 share of the gradient
JAX_GRAD_LR = 1e4
VL_LOSSES = {"loss_type": ["SurvIFMLE", "SurvEMD", "QueryDiv"], "SurvIFMLE": {},
             "SurvEMD": {"p": 2}, "QueryDiv": {}}
VL_WEIGHTS = {"SurvIFMLE": 1.0, "SurvEMD": 1.0, "QueryDiv": 0.5}
LEARNED = ("prompt_learner.context_embeds", "prompt_learner.rank_embeds",
           "query_adapter.residual_features", "mil_encoder.visual_adapter.weight",
           "logit_scale")
# (e): adahessian's rate and weight decay (tests/test_torch_adahessian.py's),
# the step's key (its z from fold_in(key, 7), as vlsa_tpu's engine draws it),
# the flagship estimate's key, and the accumulation cases (grid, accum_steps)
H_LR, H_WD, H_STEP_KEY, H_VL_KEY = 2e-4, 1e-5, 1, 4
NOISE_LEAF = "sigma.fc2_bias"  # b2: cancels in the softmax (test_torch_adahessian.py)
# (grid, accum_steps, ragged batch): at accum_steps 4 the ragged batch's last
# micro-batch (rows 6, 7) holds only padding, where SurvPLE is NaN in
# vlsa_tpu as in the port (a Cox likelihood of no bag), so that case takes
# the full batch
ACCUM_CASES = [("4x1", 2, True), ("2x2", 2, True), ("4x1", 4, False)]
# a per-bag loss takes the same micro-batch layout: accum_steps 4 on {4, 1}
# (mb = 2 < 4 ranks) and 2 on {2, 2} over the ragged batch
PER_BAG_ACCUM_CASES = [("4x1", 4, False), ("2x2", 2, True)]


def flagship_cfgs(asset_root: str):
    image = {"name": "VLFAN", "dim_in": 512, "dim_hid": 256, "use_feat_proj": False,
             "drop_rate": 0.25, "pred_head": "default", "query": "Text", "num_query": 12,
             "query_pooling": "mean", "gated_query": False,
             "query_text_method": "TaskRes", "query_text_res_ratio": 0.5,
             "query_text_load_path": asset_root + "/tools/survival_text_prototypes.json",
             "query_text_load_idx": "tcga_blca_0"}
    prompt = {"name": "CoOp", "method": "rank", "pretrained": False, "num_ranks": 12,
              "num_base_ranks": 4, "num_tokens_per_rank": 4, "num_context_tokens": 8,
              "rank_tokens_position": "tail",
              "init_prompt_path": asset_root + "/tools/survival_prompts.json",
              "init_prompt_context_idx": 0, "init_prompt_rank_idx": 0,
              "rank_specific_context": False}
    return {"name": "mahmoodlab/conch", "frozen": True}, image, prompt


def pool_inputs() -> dict:
    """The pools' inputs: 10% of the patches masked, bag 1 empty, bag 2's
    valid patches all in the first 16 (one rank's chunk on every grid)."""
    rng = np.random.default_rng(0)
    mask = rng.random((B, N)) > 0.1
    mask[1] = False
    mask[2, 16:] = False
    return {"q": rng.normal(size=(P, C)).astype(np.float32),
            "x": rng.normal(size=(B, N, C)).astype(np.float32), "mask": mask,
            "g": rng.normal(size=(B, P, C)).astype(np.float32),
            "xa": rng.normal(size=(B, N, D_AB)).astype(np.float32),
            "w1": (0.2 * rng.normal(size=(HID, D_AB))).astype(np.float32),
            "b1": (0.1 * rng.normal(size=HID)).astype(np.float32),
            "w2": rng.normal(size=HID).astype(np.float32),
            "ga": rng.normal(size=(B, D_AB)).astype(np.float32)}


def sa_batch(ragged: bool) -> dict:
    rng = np.random.default_rng(5)
    batch = {"feats": rng.normal(size=(SA_B, SA_N, SA_D)).astype(np.float32),
             "mask": np.ones((SA_B, SA_N), bool),
             "t": rng.integers(0, SA_K, size=SA_B).astype(np.float32),
             "e": rng.integers(0, 2, size=SA_B).astype(np.float32),
             "valid": np.ones(SA_B, bool)}
    batch["mask"][:, SA_N - 40:] = rng.random((SA_B, 40)) > 0.5
    if ragged:  # the last three rows are padding
        batch["valid"][5:] = False
        batch["feats"][5:], batch["mask"][5:] = 0.0, False
    return batch


def vl_batch() -> dict:
    rng = np.random.default_rng(9)
    mask = rng.random((VL_B, VL_N)) > 0.1
    return {"feats": rng.normal(size=(VL_B, VL_N, 512)).astype(np.float32), "mask": mask,
            "t": rng.integers(0, 12, size=VL_B).astype(np.float32),
            "e": (rng.random(VL_B) < 0.6).astype(np.float32), "valid": np.ones(VL_B, bool)}


def _dtype(name):
    return torch.bfloat16 if name == "bf16" else torch.float32


def sgd(model, lr):
    """Plain SGD over the trainable parameters, with the names the engine
    reads from each group."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return torch.optim.SGD([{"params": [p for _, p in named], "names": [n for n, _ in named]}],
                           lr=lr)


def port_pool(pool, dtype, dx, inp, mesh=None):
    """(out, {gradient name: value}) of one pool, on the rank's slice of a
    mesh (parallel.*_sp) or on the whole batch (the plain single-process
    pool)."""
    from vlsa_tpu_torch.ops.abmil import abmil_pool
    from vlsa_tpu_torch.ops.coattn import coattn_pool
    from vlsa_tpu_torch.parallel import abmil_pool_sp, coattn_pool_sp
    rows, cols = slice(None), slice(None)
    if mesh is not None:
        lb, n = B // mesh.n_data, N // mesh.n_model
        rows = slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)
        cols = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    mask = torch.from_numpy(inp["mask"][rows, cols].copy())
    if pool == "coattn":
        q = torch.tensor(inp["q"], requires_grad=True)
        x = torch.tensor(inp["x"][rows, cols]).to(_dtype(dtype)).requires_grad_(dx)
        out = (coattn_pool_sp(q, x, mask, SCALE, mesh) if mesh is not None
               else coattn_pool(q, x, mask, SCALE))
        (out * torch.from_numpy(inp["g"][rows])).sum().backward()
        grads = {"dq": q.grad}
    else:
        w1, b1, w2 = (torch.tensor(inp[k], requires_grad=True) for k in ("w1", "b1", "w2"))
        x = torch.tensor(inp["xa"][rows, cols]).to(_dtype(dtype)).requires_grad_(dx)
        out = (abmil_pool_sp(x, mask, w1, b1, w2, mesh) if mesh is not None
               else abmil_pool(x, mask, w1, b1, w2))
        (out * torch.from_numpy(inp["ga"][rows])).sum().backward()
        grads = {"dW1": w1.grad, "db1": b1.grad, "dw2": w2.grad}
    if dx:
        grads["dX"] = x.grad.float()
    return out.detach(), grads


class _Rows:
    """A dataset of n rows, as `BagBatcher.micro_rows` needs one."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def rank_rows(mesh, batch_size, accum=1) -> np.ndarray:
    """The global batch's rows of the rank's batch: its contiguous slice, or
    with accum_steps > 1 its shares of the micro-batches as the batcher
    lays them out (-1 a row of padding)."""
    from vlsa_tpu_torch.data.pipeline import BagBatcher
    if accum == 1:
        lb = batch_size // mesh.n_data
        return np.arange(mesh.data_index * lb, (mesh.data_index + 1) * lb)
    return BagBatcher(_Rows(batch_size), batch_size, num_shards=mesh.n_data,
                      shard_index=mesh.data_index, fixed_bucket=SA_N,
                      micro_batches=accum).micro_rows()


def take_rows(batch: dict, rows) -> dict:
    """batch's rows `rows`, -1 a row of zeros (not valid)."""
    rows = np.asarray(rows)
    out = {k: v[np.maximum(rows, 0)].copy() for k, v in batch.items()}
    for v in out.values():
        v[rows < 0] = 0
    return out


def sa_step(init, batch, loss_name, mesh=None, accum=1, hessian_z=None):
    """(loss, logits, state after the step, gradients) of one SGD step of
    the small DeepMIL/ABMIL on `batch` (the rank's rows on a mesh, `rank_rows`),
    `accum` micro-batches; with `hessian_z` ({name: z}) an adahessian step
    with that z."""
    from vlsa_tpu_torch.losses import load_loss
    from vlsa_tpu_torch.models.registry import load_model
    from vlsa_tpu_torch.optim import create_optimizer
    from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
    from vlsa_tpu_torch.runner.train import route_seq_parallel
    K = 1 if loss_name == "SurvPLE" else SA_K
    model = load_model("DeepMIL", [SA_D, 16, K], device="cpu", state_dict=init,
                       network="ABMIL", pooling="attention", use_feat_proj=False, drop_rate=0.0)
    model.train()
    routed, partial = False, ()
    if mesh is not None and mesh.n_model > 1:
        routed, partial = route_seq_parallel(model, mesh)
        assert routed and model.sp_mesh is mesh
    objective = make_objective(load_loss("sa", loss_type=[loss_name], **{loss_name: {}}),
                               {loss_name: 1.0},
                               make_output_converter(None if K == 1 else "softmax"))
    hessian = hessian_z is not None
    opt = (create_optimizer("adahessian", H_LR, H_WD, model) if hessian
           else sgd(model, SA_LR))
    engine = TrainEngine(model, opt, objective, mesh=mesh, seq_parallel=routed,
                         model_partial=partial, accum_steps=accum, needs_hessian=hessian)
    if mesh is not None:
        batch = take_rows(batch, rank_rows(mesh, SA_B, accum))
    z = [hessian_z[n] for n in engine._trainable()[0]] if hessian else None
    loss, raw = engine.train_step({k: torch.from_numpy(np.ascontiguousarray(v))
                                   for k, v in batch.items()}, hessian_z=z)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return float(loss), raw, model.state_dict(), grads


class _KeepHessian(torch.optim.SGD):
    """SGD at rate 0 that keeps the Hessian estimate its step is handed (the
    engine's adahessian step calls `step(hessian=)`)."""

    def step(self, closure=None, hessian=None):
        self.hessian = hessian
        return super().step(closure)


def vl_hessian(init, batch, mesh, hessian_z):
    """(loss, gradients, Hessian estimates) of the tiny flagship's adahessian
    step (its f32 tower; on a mesh TP and SP, as `vl_step`), z from
    `hessian_z` ({name: z})."""
    from vlsa_tpu_torch.losses import load_loss
    from vlsa_tpu_torch.models.vlsa_build import build_vlsa
    from vlsa_tpu_torch.optim import frozen_mask_from_cfg
    from vlsa_tpu_torch.parallel import shard_params
    from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
    from vlsa_tpu_torch.runner.train import route_seq_parallel
    text, image, prompt = flagship_cfgs("vlsa_tpu/assets")
    model, _tok = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                             state_dict=init)
    model.train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    routed, partial = route_seq_parallel(model, mesh)
    partial += shard_params(model, mesh, tensor_parallel=True)
    objective = make_objective(load_loss("vlsa", **VL_LOSSES), VL_WEIGHTS,
                               make_output_converter("softmax"))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = _KeepHessian([{"params": [p for _, p in named], "names": [n for n, _ in named]}],
                       lr=0.0)
    engine = TrainEngine(model, opt, objective, mesh=mesh, seq_parallel=routed,
                         model_partial=partial, needs_hessian=True)
    batch = take_rows(batch, rank_rows(mesh, VL_B))
    loss, _raw = engine.train_step({k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in batch.items()},
                                   hessian_z=[hessian_z[n] for n, _ in named])
    return (float(loss), {n: p.grad.clone() for n, p in named},
            {n: opt.hessian[p].clone() for n, p in named})


def vl_step(init, batch, mesh=None, tower="f32"):
    """(loss, gradients) of one step of the tiny flagship: SurvIFMLE +
    SurvEMD + QueryDiv, the text tower frozen (f32 or bf16); on a mesh the
    tower tensor parallel and the co-attention sequence parallel."""
    from vlsa_tpu_torch.losses import load_loss
    from vlsa_tpu_torch.models.vlsa_build import build_vlsa
    from vlsa_tpu_torch.optim import frozen_mask_from_cfg
    from vlsa_tpu_torch.parallel import shard_params
    from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
    from vlsa_tpu_torch.runner.train import route_seq_parallel
    text, image, prompt = flagship_cfgs("vlsa_tpu/assets")
    model, _tok = build_vlsa(text, image, prompt, tower_overrides=TOWERS[tower], device="cpu",
                             state_dict=init)
    model.train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    routed, partial = False, ()
    if mesh is not None:
        routed, partial = route_seq_parallel(model, mesh)
        partial += shard_params(model, mesh, tensor_parallel=True)
        assert routed and len(partial) == 3 * TOWER["layers"]
    objective = make_objective(load_loss("vlsa", **VL_LOSSES), VL_WEIGHTS,
                               make_output_converter("softmax"))
    engine = TrainEngine(model, sgd(model, VL_LR), objective, mesh=mesh, seq_parallel=routed,
                         model_partial=partial)
    if mesh is not None:
        batch = take_rows(batch, rank_rows(mesh, VL_B))
    loss, _raw = engine.train_step({k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in batch.items()})
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _rank(rank: int, world: int, rendezvous: str, root: str) -> None:
    """One rank: every pool case on {2, 2} and {1, 4}, the SA steps on
    {2, 2} and {4, 1}, the flagship step on {2, 2}; its results to
    <root>/rank<r>.pt."""
    import torch.distributed as dist
    from vlsa_tpu_torch.parallel import make_mesh
    from vlsa_tpu_torch.parallel.multihost import init_local_rank
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(1)  # four ranks share the host's cores
    init_local_rank(rank, world, rendezvous, "cpu")
    try:
        meshes = {name: make_mesh(*shape) for name, shape in MESHES.items()}
        given = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        inp, out = pool_inputs(), {"rank": rank}
        for name in ("2x2", "1x4"):
            for case in POOL_CASES:
                out[("pool", name) + case] = port_pool(*case, inp, meshes[name])
        for name in ("2x2", "4x1"):
            for loss_name, ragged in SA_CASES:
                out[("sa", name, loss_name)] = sa_step(given["sa", loss_name],
                                                       sa_batch(ragged), loss_name, meshes[name])
        for tower in TOWERS:
            out[("vl", "2x2", tower)] = vl_step(given["vl", tower], vl_batch(), meshes["2x2"],
                                               tower)
        out["sa_hessian", "4x1"] = sa_step(given["sa", "SurvIFMLE"], sa_batch(False),
                                           "SurvIFMLE", meshes["4x1"],
                                           hessian_z=given["sa_hessian_z"])
        out["vl_hessian", "2x2"] = vl_hessian(given["vl", "f32"], vl_batch(), meshes["2x2"],
                                              given["vl_hessian_z"])
        for name, accum, ragged in ACCUM_CASES:
            out["accum", name, accum] = sa_step(given["sa", "SurvPLE"], sa_batch(ragged),
                                                "SurvPLE", meshes[name], accum=accum)
        for name, accum, ragged in PER_BAG_ACCUM_CASES:
            out["accum_per_bag", name, accum] = sa_step(given["sa", "SurvIFMLE"],
                                                        sa_batch(ragged), "SurvIFMLE",
                                                        meshes[name], accum=accum)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, root: str) -> None:
    """`world` ranks of `fn(rank, world, rendezvous, root)`, joined through a
    file in `root` (no port to race another process for)."""
    from vlsa_tpu_torch.parallel.multihost import local_rendezvous
    mp.start_processes(fn, args=(world, local_rendezvous(root), root), nprocs=world, join=True,
                       start_method="spawn")


def rel(a, b) -> float:
    a, b = (np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float64)
            for t in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------- the JAX side

def _jax_sa(loss_name, ragged, mesh_shape, accum=1, hessian=False):
    """vlsa_tpu's SA step on its mesh: (initial params as a state dict,
    loss, logits, state dict after one SGD step), the step over `accum`
    micro-batches, or with `hessian` one adahessian step."""
    import jax
    import jax.numpy as jnp
    import optax
    from vlsa_tpu.losses import load_loss
    from vlsa_tpu.models import DeepMIL
    from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
    from vlsa_tpu.parallel import make_mesh
    from vlsa_tpu.runner.base import BaseHandler
    from vlsa_tpu.runner.engine import TrainEngine, make_objective, make_output_converter
    from vlsa_tpu_torch.utils.weights import state_dict_from_jax
    K = 1 if loss_name == "SurvPLE" else SA_K
    model = DeepMIL(dim_in=SA_D, dim_hid=16, num_cls=K, use_feat_proj=False, drop_rate=0.0,
                    pooling="attention")
    base = sa_batch(ragged)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(base["feats"]),
                        jnp.asarray(base["mask"]))["params"]
    init = state_dict_from_jax(jax.tree.map(np.asarray, params))
    if mesh_shape is None:
        return init
    objective = make_objective(load_loss("sa", loss_type=[loss_name], **{loss_name: {}}),
                               {loss_name: 1.0}, make_output_converter(
                                   None if K == 1 else "softmax"), uses_vl=False)
    nd, nm = mesh_shape
    mesh = make_mesh(n_data=nd, n_model=nm)
    sp = nm > 1
    m = BaseHandler._route_seq_parallel(model, mesh) if sp else model
    tx = (jax_create_optimizer("adahessian", H_LR, H_WD, params) if hessian
          else optax.sgd(SA_LR))
    eng = TrainEngine(m, tx, objective, uses_vl=False, mesh=mesh, tensor_parallel=False,
                      seq_parallel=sp, accum_steps=accum, needs_hessian=hessian)
    p = eng.shard_params(params)
    o = eng.init_opt_state(p)
    batch = eng.shard_batch({**base, "idx": np.arange(SA_B, dtype=np.int32)})
    p2, _, loss, raw = eng.train_step()(p, o, batch, jax.random.PRNGKey(H_STEP_KEY))
    return init, float(loss), np.asarray(raw), state_dict_from_jax(jax.tree.map(np.asarray, p2))


def _jax_z(params, rng) -> dict:
    """z of vlsa_tpu's Hutchinson estimate from `rng`
    (tests/test_torch_adahessian.py's `_jax_z`), by the port's names."""
    import jax
    from test_torch_adahessian import _jax_z as draw
    from vlsa_tpu_torch.utils.weights import state_dict_from_jax
    return state_dict_from_jax(jax.tree.map(np.asarray, draw(params, rng)))


def _jax_sa_hessian_z() -> dict:
    """The z vlsa_tpu's adahessian step draws at the SA step's key."""
    import jax
    import jax.numpy as jnp
    from vlsa_tpu.models import DeepMIL
    from vlsa_tpu_torch.utils.weights import state_dict_from_jax  # noqa: F401
    base = sa_batch(False)
    model = DeepMIL(dim_in=SA_D, dim_hid=16, num_cls=SA_K, use_feat_proj=False, drop_rate=0.0,
                    pooling="attention")
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(base["feats"]),
                        jnp.asarray(base["mask"]))["params"]
    return _jax_z(params, jax.random.fold_in(jax.random.PRNGKey(H_STEP_KEY), 7))


@functools.lru_cache(maxsize=None)
def _jax_vl_hessian():
    """vlsa_tpu's Hutchinson estimate of the tiny flagship's loss (f32 tower)
    on {data: 2, model: 2} with TP and SP, as its adahessian step forms it
    (`disable_pallas`), at key H_VL_KEY: (z by the port's names, the
    estimates of the learned leaves)."""
    import jax
    import jax.numpy as jnp
    from vlsa_tpu.losses import load_loss
    from vlsa_tpu.models.vlsa_build import build_vlsa
    from vlsa_tpu.ops.flags import disable_pallas
    from vlsa_tpu.optim import frozen_mask_from_cfg
    from vlsa_tpu.optim.extra import hutchinson_hessian_diag
    from vlsa_tpu.parallel import make_mesh
    from vlsa_tpu.runner.base import BaseHandler
    from vlsa_tpu.runner.engine import TrainEngine, make_objective, make_output_converter
    from vlsa_tpu_torch.utils.weights import state_dict_from_jax
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text, image, prompt = flagship_cfgs(os.path.join(repo, "vlsa_tpu", "assets"))
    jmodel, params, _tok = build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    params = jax.tree.map(np.asarray, dict(params))
    frozen = frozen_mask_from_cfg(params, ["prompt_encoder"])
    objective = make_objective(load_loss("vlsa", **VL_LOSSES), VL_WEIGHTS,
                               make_output_converter("softmax"), uses_vl=True)
    mesh = make_mesh(n_data=2, n_model=2)
    m = BaseHandler._route_seq_parallel(jmodel, mesh)
    eng = TrainEngine(m, None, objective, uses_vl=True, has_query_div=True, frozen=frozen,
                      mesh=mesh, tensor_parallel=True, seq_parallel=True)
    p = eng.shard_params(jax.tree.map(jnp.asarray, params))
    rng = jax.random.PRNGKey(H_VL_KEY)
    batch = {k: jnp.asarray(v) for k, v in vl_batch().items()}

    def loss_fn(pp):  # vlsa_tpu/runner/engine.py's loss_fn (train=True, dropout key 0)
        pp = jax.tree.map(lambda v, f: jax.lax.stop_gradient(v) if f else v, pp, frozen)
        out = m.apply({"params": pp}, batch["feats"], mask=batch["mask"], train=True,
                      rngs={"dropout": jax.random.PRNGKey(0)})
        raw = out[0] if isinstance(out, tuple) else out
        return objective(raw, batch["t"], batch["e"], batch["valid"].astype(raw.dtype),
                         logit_scale=jnp.exp(pp["logit_scale"]),
                         query_div_fn=lambda: m.apply({"params": pp}, method=m.query_div_loss))
    with disable_pallas():
        diag = jax.jit(lambda pp: hutchinson_hessian_diag(loss_fn, pp, rng))(p)
    diag = state_dict_from_jax(jax.tree.map(np.asarray, diag))
    return _jax_z(params, rng), {n: diag[n] for n in LEARNED}


@functools.lru_cache(maxsize=None)
def _jax_vl(tower="f32", grid=True):
    """vlsa_tpu's tiny flagship (its tower f32 or bf16): (initial state
    dict, and on {data: 2, model: 2} with TP and SP, or on one device: loss,
    gradients of the learned leaves)."""
    import jax
    import jax.numpy as jnp
    import optax
    from vlsa_tpu.losses import load_loss
    from vlsa_tpu.models.vlsa_build import build_vlsa
    from vlsa_tpu.optim import frozen_mask_from_cfg
    from vlsa_tpu.parallel import make_mesh
    from vlsa_tpu.runner.base import BaseHandler
    from vlsa_tpu.runner.engine import TrainEngine, make_objective, make_output_converter
    from vlsa_tpu_torch.utils.weights import state_dict_from_jax
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text, image, prompt = flagship_cfgs(os.path.join(repo, "vlsa_tpu", "assets"))
    jmodel, params, _tok = build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWERS[tower])
    params = jax.tree.map(np.asarray, dict(params))
    init = state_dict_from_jax(params)
    frozen = frozen_mask_from_cfg(params, ["prompt_encoder"])
    objective = make_objective(load_loss("vlsa", **VL_LOSSES), VL_WEIGHTS,
                               make_output_converter("softmax"), uses_vl=True)
    mesh = make_mesh(n_data=2, n_model=2) if grid else None
    m = BaseHandler._route_seq_parallel(jmodel, mesh) if grid else jmodel
    eng = TrainEngine(m, optax.sgd(JAX_GRAD_LR), objective, uses_vl=True, has_query_div=True,
                      frozen=frozen, mesh=mesh, tensor_parallel=grid, seq_parallel=grid)
    p = eng.shard_params(jax.tree.map(jnp.asarray, params))
    o = eng.init_opt_state(p)
    batch = eng.shard_batch({**vl_batch(), "idx": np.arange(VL_B, dtype=np.int32)})
    p2, _, loss, _raw = eng.train_step()(p, o, batch, jax.random.PRNGKey(1))
    after = state_dict_from_jax(jax.tree.map(np.asarray, p2))
    grads = {n: (init[n].double() - after[n].double()) / JAX_GRAD_LR for n in LEARNED}
    return init, float(loss), grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results and the JAX side's initial weights."""
    root = str(tmp_path_factory.mktemp("ranks"))
    given = {("sa", name): _jax_sa(name, ragged, None) for name, ragged in SA_CASES}
    for tower in TOWERS:
        given["vl", tower] = _jax_vl(tower)
    given["sa_hessian_z"] = _jax_sa_hessian_z()
    given["vl_hessian_z"] = _jax_vl_hessian()[0]
    torch.save({k: v if k[0] != "vl" else v[0] for k, v in given.items()},
               os.path.join(root, "inputs.pt"))
    spawn(_rank, WORLD, root)
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)], given


def _assemble(results, key, shape):
    """The whole batch's output and gradients from the ranks of a grid:
    the outputs of each data group's model rank 0 stacked by bags (every
    model rank holding the same), the replicated inputs' gradients summed
    over the data ranks (the engine's data-group sum), dX's chunks placed
    by (bags, patches)."""
    nd, nm = shape
    rank = {(r // nm, r % nm): results[r][key] for r in range(nd * nm)}
    for d in range(nd):
        for m in range(1, nm):
            assert torch.equal(rank[d, m][0], rank[d, 0][0])
            for g in rank[d, 0][1]:
                if g != "dX":
                    assert torch.equal(rank[d, m][1][g], rank[d, 0][1][g])
    out = torch.cat([rank[d, 0][0] for d in range(nd)])
    grads = {g: sum(rank[d, 0][1][g] for d in range(nd)) for g in rank[0, 0][1] if g != "dX"}
    if "dX" in rank[0, 0][1]:
        grads["dX"] = torch.cat([torch.cat([rank[d, m][1]["dX"] for m in range(nm)], 1)
                                 for d in range(nd)])
    return out, grads


@functools.lru_cache(maxsize=None)
def _jax_pool(pool, dtype, grid):
    """vlsa_tpu's pool on its grid: (out, gradients, dX included), jitted."""
    import jax
    import jax.numpy as jnp
    from vlsa_tpu.parallel import make_mesh
    from vlsa_tpu.parallel.abmil_sp import abmil_pool_sp
    from vlsa_tpu.parallel.coattn_sp import coattn_pool_sp
    inp = pool_inputs()
    mesh = make_mesh(n_data=MESHES[grid][0], n_model=MESHES[grid][1])
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    mask = jnp.asarray(inp["mask"])
    if pool == "coattn":
        x = jnp.asarray(inp["x"]).astype(jdt)

        def f(q, x):
            out = coattn_pool_sp(q, x, mask, SCALE, mesh, axis="model", batch_axis="data")
            return jnp.sum(out * inp["g"]), out
        (_, out), gr = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jnp.asarray(inp["q"]), x)
        grads = {"dq": gr[0]}
    else:
        x = jnp.asarray(inp["xa"]).astype(jdt)

        def f(x, w1, b1, w2):
            out = abmil_pool_sp(x, mask, w1, b1, w2, mesh, axis="model", batch_axis="data")
            return jnp.sum(out * inp["ga"]), out
        (_, out), gr = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True))(
            x, *(jnp.asarray(inp[k]) for k in ("w1", "b1", "w2")))
        grads = {"dW1": gr[1], "db1": gr[2], "dw2": gr[3]}
    grads["dX"] = gr[1] if pool == "coattn" else gr[0]
    to_np = (lambda a: np.asarray(jnp.asarray(a, jnp.float32)))
    return to_np(out), {k: to_np(v) for k, v in grads.items()}


# Tolerances, max|a - b| / max|b|.  The merge reorders f32 sums only: 1e-5
# against vlsa_tpu, 1e-6 against the port's own single-process plain pool
# (measured: 7.4e-7 and 6.4e-7 at most).  bf16 storage: both packages
# compute in f32 from the bf16 values, but the per-rank plain versions round
# where the kernels round, which vlsa_tpu's SP einsum does not: ABMIL's W1 to
# bf16 in the forward (every ABMIL quantity against vlsa_tpu), dz to bf16
# in dW1 and dX, and the co-attention dX's logit cotangent and weights to
# bf16 (those against the autograd plain pool too): 1e-2 there (measured:
# 5.3e-3 at most).
TOL = {"jax": 1e-5, "plain": 1e-6}
TOL_BF16_ROUNDED = 1e-2
ROUNDED = {"jax": {("coattn", "dX"), ("abmil", "out"), ("abmil", "dW1"), ("abmil", "db1"),
                   ("abmil", "dw2"), ("abmil", "dX")},
           "plain": {("coattn", "dX"), ("abmil", "dW1"), ("abmil", "dX")}}


def _tol(pool, dtype, what, vs):
    if dtype == "bf16" and (pool, what) in ROUNDED[vs]:
        return TOL_BF16_ROUNDED
    return TOL[vs]


@pytest.mark.parametrize("grid", ["2x2", "1x4"])
@pytest.mark.parametrize("pool,dtype,dx", POOL_CASES)
def test_sp_pool_matches_jax_and_the_single_process_pool(ranks, grid, pool, dtype, dx):
    results, _given = ranks
    inp = pool_inputs()
    out, grads = _assemble(results, ("pool", grid, pool, dtype, dx), MESHES[grid])
    assert out.shape == ((B, P, C) if pool == "coattn" else (B, D_AB))
    assert torch.all(out[1] == 0)  # the empty bag
    want_out, want = _jax_pool(pool, dtype, grid)
    plain_out, plain = port_pool(pool, dtype, dx, inp)
    assert set(grads) == set(plain) <= set(want) and ("dX" in grads) == dx
    assert rel(out, want_out) <= _tol(pool, dtype, "out", "jax")
    assert rel(out, plain_out) <= _tol(pool, dtype, "out", "plain")
    for g in grads:
        assert rel(grads[g], want[g]) <= _tol(pool, dtype, g, "jax"), (g, rel(grads[g], want[g]))
        assert rel(grads[g], plain[g]) <= _tol(pool, dtype, g, "plain"), \
            (g, rel(grads[g], plain[g]))


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
@pytest.mark.parametrize("loss_name,ragged", SA_CASES)
def test_sa_step_on_a_mesh_matches_jax(ranks, grid, loss_name, ragged):
    """Loss at rtol 1e-5, the parameters after one SGD step at rtol 1e-4 /
    atol 1e-5 (vlsa_tpu's own limits), against vlsa_tpu's step on the same
    grid and the port's single-process step; every rank ends with the same
    parameters."""
    results, given = ranks
    init = given["sa", loss_name]
    _init, jloss, jraw, jstate = _jax_sa(loss_name, ragged, MESHES[grid])
    loss1, raw1, state1, _g = sa_step(init, sa_batch(ragged), loss_name)
    runs = [r[("sa", grid, loss_name)] for r in results]
    for loss, raw, state, _grads in runs:
        assert loss == runs[0][0]
        for k in state:
            assert torch.equal(state[k], runs[0][2][k]), k
    loss, raw, state, _grads = runs[0]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    np.testing.assert_allclose(raw.numpy(), jraw, rtol=1e-4, atol=1e-5)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), jstate[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(v.numpy(), state1[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        # fc2's bias cancels in the softmax; the Cox likelihood is blind to g's
        if k != "sigma.fc2_bias" and not (k == "g.bias" and loss_name == "SurvPLE"):
            assert not torch.equal(v, init[k]), k


def test_flagship_step_with_tp_sp_and_query_div(ranks):
    """The tiny flagship on {data: 2, model: 2}: every rank's loss and
    gradients the same; against vlsa_tpu's mesh step (its gradients from one
    SGD step of rate 1) and the port's single-process step, the loss at
    rtol 1e-5 and each learned leaf's gradient within 1e-4 of its largest."""
    results, given = ranks
    init, jloss, jgrads = given["vl", "f32"]
    loss1, grads1 = vl_step(init, vl_batch())
    runs = [r[("vl", "2x2", "f32")] for r in results]
    for loss, grads in runs[1:]:
        assert loss == runs[0][0] and set(grads) == set(runs[0][1])
        for n in grads:
            assert torch.equal(grads[n], runs[0][1][n]), n
    loss, grads = runs[0]
    assert not any(n.startswith("prompt_encoder.") for n in grads)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    for n in LEARNED:
        assert rel(grads[n], jgrads[n]) <= 1e-4, (n, rel(grads[n], jgrads[n]))
        assert rel(grads[n], grads1[n]) <= 1e-4, (n, rel(grads[n], grads1[n]))


# The bf16 tower on a grid: the tensor-parallel MLP sums its partial products
# in another order than one rank does, which moves some bf16 roundings of the
# next operands (and, backward, of the cotangents) by an ulp.  vlsa_tpu's own
# mesh step moves them too.  Measured here, max|a - b| / max|b| of each learned
# leaf's gradient (the loss: equal on the grid and on one device in both):
#                        port grid-one  vlsa_tpu mesh-one  port bf16-f32 (one)
#   context_embeds       8.86e-2        3.97e-2            1.07e-1
#   rank_embeds          1.23e-2        1.03e-2            1.88e-2
#   residual_features    3.44e-6        3.27e-6            5.22e-2
#   visual_adapter       1.88e-6        1.62e-6            2.16e-2
#   logit_scale          3.90e-7        2.72e-6            1.53e-1
# So the port's grid gap is held within 3x vlsa_tpu's own (2.23x at most), and,
# as in vlsa_tpu, within the whole bf16 effect: the one-rank bf16 step's gap
# from the f32 tower's (the limit chip_smoke.py phase 3t holds on the card).
TP_BF16_VS_JAX = 3.0


def test_flagship_step_with_a_bf16_tower(ranks):
    """The tiny flagship with its text tower in bf16 on {data: 2, model:
    2}: every rank's loss and gradients the same; the loss against the
    port's single-process step at rtol 1e-5 and vlsa_tpu's mesh step at
    rtol 1e-4; each learned leaf's gradient off the single-process step's by
    at most TP_BF16_VS_JAX times vlsa_tpu's own gap between its mesh and its
    one device, and, as vlsa_tpu's is, by no more than bf16 moves the
    single-process step from the f32 tower's."""
    results, given = ranks
    init, jloss, jgrads = given["vl", "bf16"]
    _i, jloss1, jgrads1 = _jax_vl("bf16", grid=False)
    _i, jloss_f32, jgrads_f32 = _jax_vl("f32", grid=False)
    loss1, grads1 = vl_step(init, vl_batch(), tower="bf16")
    loss_f32, grads_f32 = vl_step(given["vl", "f32"][0], vl_batch())
    runs = [r[("vl", "2x2", "bf16")] for r in results]
    for loss, grads in runs[1:]:
        assert loss == runs[0][0] and set(grads) == set(runs[0][1])
        for n in grads:
            assert torch.equal(grads[n], runs[0][1][n]), n
    loss, grads = runs[0]
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert abs(loss - loss1) <= abs(loss1 - loss_f32)
    assert abs(jloss - jloss1) <= abs(jloss1 - jloss_f32)
    for n in LEARNED:
        port_gap, jax_gap = rel(grads[n], grads1[n]), rel(jgrads[n], jgrads1[n])
        assert port_gap <= TP_BF16_VS_JAX * jax_gap, (n, port_gap, jax_gap)
        assert port_gap <= rel(grads1[n], grads_f32[n]), (n, port_gap)
        assert jax_gap <= rel(jgrads1[n], jgrads_f32[n]), (n, jax_gap)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_batcher_slices_match_jax(num_shards):
    """Each shard's batches of two shuffled epochs (8 bags a global batch,
    the last a tail of 6) byte for byte against vlsa_tpu's BagBatcher, and
    the shards together the single-process batches' rows; a shard whose
    slice of the tail is empty gets rows of padding."""
    from test_torch_data import _metas
    from test_torch_native_loader import assert_same_batch
    from vlsa_tpu.data.bags import SurvBagDataset as JaxBagDataset
    from vlsa_tpu.data.pipeline import BagBatcher as JaxBatcher
    from vlsa_tpu_torch.data.bags import SurvBagDataset
    from vlsa_tpu_torch.data.pipeline import BagBatcher
    jmeta, meta, split = _metas(False)
    pids, path = split["train"][:22], "synthetic://N=40,D=8,seed=3"
    kw = dict(batch_size=8, shuffle=True, seed=7, fixed_bucket=512, feats_dtype="bfloat16")
    whole = BagBatcher(SurvBagDataset(pids, path, meta), prefetch=0, **kw)
    shards = [BagBatcher(SurvBagDataset(pids, path, meta), num_shards=num_shards,
                         shard_index=i, **kw) for i in range(num_shards)]
    jax = [JaxBatcher(JaxBagDataset(pids, path, "patch", jmeta), num_shards=num_shards,
                      shard_index=i, prefetch=0, **kw) for i in range(num_shards)]
    for epoch in range(2):
        got = [list(s) for s in shards]
        want = [list(j) for j in jax]
        full = list(whole)
        assert all(len(g) == len(full) == 3 for g in got)
        for j, batch in enumerate(full):
            for i in range(num_shards):
                assert_same_batch(got[i][j], want[i][j], f"epoch {epoch} batch {j} shard {i}")
            for k in batch:
                joined = torch.cat([got[i][j][k] for i in range(num_shards)])
                assert joined.dtype == batch[k].dtype and joined.shape == batch[k].shape, k
                bits = torch.int16 if joined.dtype == torch.bfloat16 else joined.dtype
                assert torch.equal(joined.view(bits), batch[k].view(bits)), k
    # the tail's 6 bags: the last shard's slice of 2 rows holds none of them at 4 shards
    assert got[num_shards - 1][2]["valid"].sum() == (0 if num_shards == 4 else 2)
    with pytest.raises(ValueError, match="not divisible by num_shards"):
        BagBatcher(SurvBagDataset(pids, path, meta), batch_size=6, num_shards=4,
                   fixed_bucket=64)
    with pytest.raises(ValueError, match="requires fixed_bucket"):
        BagBatcher(SurvBagDataset(pids, path, meta), batch_size=8, num_shards=2)


@pytest.mark.parametrize("what", ["adahessian", "accumulation"])
def test_what_a_mesh_still_refuses(what):
    """A mesh refuses only what vlsa_tpu refuses on one device too
    (adahessian with accum_steps > 1, its assert): adahessian and
    accum_steps > 1 each build on a data grid (ROADMAP.md §A.18 is done);
    a batcher whose batch does not split into its micro-batches raises."""
    from vlsa_tpu_torch.models.registry import load_model
    from vlsa_tpu_torch.parallel import Mesh
    from vlsa_tpu_torch.runner.engine import TrainEngine
    model = load_model("DeepMIL", [SA_D, 16, 1], device="cpu", network="ABMIL",
                       pooling="attention", use_feat_proj=False)
    kws = {"needs_hessian": True} if what == "adahessian" else {"accum_steps": 2}
    for mesh in (Mesh(2, 1), Mesh(1, 1)):
        engine = TrainEngine(model, sgd(model, 0.1), lambda *a, **k: 0.0, mesh=mesh, **kws)
        assert engine.n_data == mesh.n_data
    with pytest.raises(ValueError, match="accum_steps"):
        TrainEngine(model, sgd(model, 0.1), lambda *a, **k: 0.0, mesh=Mesh(2, 1),
                    needs_hessian=True, accum_steps=2)
    with pytest.raises(ValueError, match="micro-batches"):
        rank_rows(Mesh(2, 1, rank=0), 6, accum=4)


@pytest.mark.parametrize("B_, accum, nd", [(8, 2, 4), (8, 2, 2), (8, 4, 4), (6, 2, 2),
                                           (12, 4, 2), (8, 1, 4)])
def test_micro_batch_shares_gather_to_vlsa_tpus_micro_batches(B_, accum, nd):
    """With accum_steps > 1 the data ranks' k-th
    shares gathered in rank order are vlsa_tpu's k-th contiguous
    micro-batch, rows [k mb, (k + 1) mb), padded where a share runs out (mb
    = 2 < 4 ranks: two ranks' shares all padding); at accum_steps 1 the
    contiguous slices of before."""
    from vlsa_tpu_torch.parallel import Mesh
    ranks_ = [rank_rows(Mesh(nd, 1, rank=d), B_, accum) for d in range(nd)]
    share = len(ranks_[0]) // accum
    assert all(len(r) == accum * share for r in ranks_)
    mb = B_ // accum
    for k in range(accum):
        gathered = np.concatenate([r[k * share:(k + 1) * share] for r in ranks_])
        assert gathered[gathered >= 0].tolist() == list(range(k * mb, (k + 1) * mb))
    if accum == 1:
        assert np.concatenate(ranks_).tolist() == list(range(B_))


def test_adahessian_step_on_a_mesh_matches_jax(ranks):
    """One adahessian step of the SA model on {data: 4, model: 1}, every
    rank with vlsa_tpu's z: every rank ends with the same parameters; loss
    at rtol 1e-5 and the parameters after the step at rtol 1e-4 / atol 1e-5
    against vlsa_tpu's adahessian step on the same grid (b2, NOISE_LEAF, as
    tests/test_torch_adahessian.py holds it: vlsa_tpu's plain pooling gives
    it a noise estimate and moves it by up to the rate, the port not at
    all)."""
    results, given = ranks
    init = given["sa", "SurvIFMLE"]
    _i, jloss, _jraw, jstate = _jax_sa("SurvIFMLE", False, MESHES["4x1"], hessian=True)
    runs = [r["sa_hessian", "4x1"] for r in results]
    for loss, _raw, state, _g in runs:
        assert loss == runs[0][0]
        for k in state:
            assert torch.equal(state[k], runs[0][2][k]), k
    loss, _raw, state, _g = runs[0]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for k, v in state.items():
        if k == NOISE_LEAF:
            assert torch.equal(v, init[k]) and float((jstate[k] - v).abs().max()) <= H_LR
            continue
        np.testing.assert_allclose(v.numpy(), jstate[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert not torch.equal(v, init[k]), k


def test_flagship_hessian_on_a_mesh_matches_jax(ranks):
    """The tiny flagship's adahessian step on {data: 2, model: 2}, the tower
    (f32) tensor parallel and the co-attention sequence parallel on its
    plain shard_fn: every rank's loss, gradients and Hessian estimate the
    same; the loss at rtol 1e-5 and each learned leaf's gradient within
    1e-4 of its largest against vlsa_tpu's mesh step, and its estimate
    within 1e-4 of its largest against vlsa_tpu's Hutchinson estimate on the
    same grid with the same z (tests/test_torch_adahessian.py's limit)."""
    results, given = ranks
    _init, jloss, jgrads = given["vl", "f32"]
    _z, jdiag = _jax_vl_hessian()
    runs = [r["vl_hessian", "2x2"] for r in results]
    for loss, grads, diag in runs[1:]:
        assert loss == runs[0][0]
        for n in grads:
            assert torch.equal(grads[n], runs[0][1][n]) and torch.equal(diag[n], runs[0][2][n]), n
    loss, grads, diag = runs[0]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for n in LEARNED:
        assert rel(grads[n], jgrads[n]) <= 1e-4, (n, rel(grads[n], jgrads[n]))
        w = jdiag[n].double()
        assert float(w.abs().max()) > 0, n
        assert float((diag[n].double() - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            (n, rel(diag[n], w))


def _hold_accumulation(runs, loss_name, grid, accum, ragged) -> None:
    """Every rank's accumulated SGD step the same; loss at rtol 1e-5, logits
    and the parameters after the step at rtol 1e-4 / atol 1e-5 against
    vlsa_tpu's accumulated step on the same grid."""
    _i, jloss, jraw, jstate = _jax_sa(loss_name, ragged, MESHES[grid], accum=accum)
    for loss, _raw, state, _g in runs:
        assert loss == runs[0][0]
        for k in state:
            assert torch.equal(state[k], runs[0][2][k]), k
    loss, raw, state, _g = runs[0]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    # the engine's logits follow the ranks' rows (data-rank-major); vlsa_tpu's the global order
    nd = MESHES[grid][0]
    from vlsa_tpu_torch.parallel import Mesh
    order = np.concatenate([rank_rows(Mesh(nd, 1, rank=d), SA_B, accum) for d in range(nd)])
    real = order >= 0
    np.testing.assert_allclose(raw.numpy()[real], jraw[order[real]], rtol=1e-4, atol=1e-5)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), jstate[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("grid,accum,ragged", ACCUM_CASES)
def test_batch_coupled_accumulation_on_a_mesh_matches_jax(ranks, grid, accum, ragged):
    """SurvPLE, which couples the bags, on a batch of 8 (ragged: its last
    three rows padding) with accum_steps micro-batches over the data ranks,
    each rank fed its shares of vlsa_tpu's contiguous micro-batches, against
    vlsa_tpu's accumulated step (`_hold_accumulation`)."""
    results, _given = ranks
    _hold_accumulation([r["accum", grid, accum] for r in results], "SurvPLE", grid, accum,
                       ragged)


@pytest.mark.parametrize("grid,accum,ragged", PER_BAG_ACCUM_CASES)
def test_per_bag_accumulation_on_a_mesh_matches_jax(ranks, grid, accum, ragged):
    """SurvIFMLE, a loss of each bag alone, through the same micro-batch
    layout (at accum_steps 4 on {4, 1} each rank holds one row of each
    micro-batch of 2 or padding), against vlsa_tpu's accumulated step
    (`_hold_accumulation`)."""
    results, _given = ranks
    _hold_accumulation([r["accum_per_bag", grid, accum] for r in results], "SurvIFMLE", grid,
                       accum, ragged)


# (host, device type, cards on the host, card asked for) of each rank
LAYOUTS = {
    "cpu": ([("a", "cpu", 0, None)] * 2, "gloo", [0, 1], [0, 0]),
    "one-card-shared": ([("a", "cuda", 1, None)] * 4, "gloo", [0, 1, 2, 3], [0, 0, 0, 0]),
    "two-hosts-one-card": ([("a", "cuda", 1, None), ("b", "cuda", 1, None)], "nccl",
                           [0, 0], [0, 0]),
    # vlsa_tpu's "2 processes x 2 local devices": 4 processes, two to a host
    "two-hosts-two-cards": ([("a", "cuda", 2, None)] * 2 + [("b", "cuda", 2, None)] * 2,
                            "nccl", [0, 1, 0, 1], [0, 1, 0, 1]),
    "asked-cards": ([("a", "cuda", 2, 1), ("a", "cuda", 2, 0)], "nccl", [0, 1], [1, 0]),
    "asked-one-card-twice": ([("a", "cuda", 2, 0), ("a", "cuda", 2, 0)], "gloo", [0, 1],
                             [0, 0]),
    "asked-a-card-not-there": ([("a", "cuda", 1, 1), ("b", "cuda", 1, 0)], "gloo", [0, 0],
                               [1, 0]),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_backend_follows_the_layout(name):
    """Each rank's local rank and card, and the backend every rank chooses,
    read from all the ranks' places (the hosts, cards and cards asked for
    that a `distributed` dict's ranks exchange): NCCL only where every rank
    has a card no other rank of its host drives."""
    from vlsa_tpu_torch.parallel.multihost import rank_layout
    places, backend, local, cards = LAYOUTS[name]
    assert rank_layout(places) == (backend, local, cards)
