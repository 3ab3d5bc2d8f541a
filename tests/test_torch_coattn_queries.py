"""The co-attention at more than 16 queries: the port's plain versions --
the ones the CUDA kernels are held against on the card -- against the JAX
package's Pallas kernels in interpret mode, which take any query count
(vlsa_tpu/ops/coattn.py::_pad_q pads q to a multiple of 8 rows), on the same
inputs made with numpy; the kernels' query-group constants against csrc/;
and VLSA with 32 learned, gated VLFAN queries (33 parameter rows, folded to
P = 32) against vlsa_tpu's, scored and trained 5 Adam steps.

The kernels take P queries as ceil(P / 16) groups of 16 rows (one mma
tile), the last zero-padded.  P = 17 leaves one real row in its last group,
24 half a group, 33 one row past two groups, 64 four full groups.  B=3,
N=384 (the Pallas kernels take bags of a multiple of 128), C=64, scale 30,
10% of patches masked, a masked ragged tail of 37 and an empty bag.

Tolerances (max|a-b| / max|b|) are those of the files that hold the same
functions at P=12: the forward tests/test_torch_coattn.py's (f32 1e-5, bf16
2e-4, int8 1e-3; the rounding model f32 2e-6, bf16 1e-5, int8 5e-4), dQ
tests/test_torch_coattn_bwd.py's (f32 1e-3, bf16 and int8 2e-3; the port's
two routes 1e-5 apart), the full backward tests/test_torch_coattn_dx.py's
(dq f32 1e-5, bf16 2e-3; dX f32 1e-5, bf16 within one bf16 ulp of its
largest element), and the model tests/test_torch_vlsa.py's and
tests/test_torch_train.py's (logits 1e-4; losses 1e-4, parameters 1e-5 +
1e-4 |b|, with test_torch_train's near-zero-gradient exception).
"""
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_coattn import _jax_kernel, _rel, _torch
from test_torch_coattn_bwd import _jax_dq
from test_torch_coattn_dx import _bf16_ulp_of_max, _jax_grads
from test_torch_train import LOSSES, LR, NEAR_ZERO_GRADIENT, STEPS, WD, WEIGHTS, _batches
from test_torch_vlsa import REPO, TOWER, flagship_cfgs
from vlsa_tpu.data.pipeline import feats_inv_norms, quantize_feats_int8
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu.models.mil import VLFAN as JaxVLFAN
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.models.mil import VLFAN
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.ops import coattn as tco
from vlsa_tpu_torch.optim import create_optimizer, frozen_mask_from_cfg
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

B, N, C, SCALE = 3, 384, 64, 30.0
QUERIES = (17, 24, 33, 64)
VARIANTS = ("f32", "f32_inv", "bf16", "bf16_inv", "int8", "int8_inv")
TOL_FWD = {"f32": 1e-5, "bf16": 2e-4, "int8": 1e-3}
TOL_ROUNDED = {"f32": 2e-6, "bf16": 1e-5, "int8": 5e-4}
TOL_DQ = {"f32": 1e-3, "bf16": 2e-3, "int8": 2e-3}
TOL_DX_DQ = {"f32": 1e-5, "bf16": 2e-3}
# the flagship's image encoder with 32 learned queries and a gate query
GATED_32 = dict(query="Parameter", num_query=32, gated_query=True)


def _inputs(variant: str, P: int, seed: int = 0, keep_masked: bool = False):
    """(q, x, mask, x_scale, x_inv, g) as numpy: x in the variant's storage,
    masked rows zero unless `keep_masked` (a projecter's output has features
    there), g the output's cotangent [B, P, C]."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(P, C)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = rng.random((B, N)) > 0.1
    mask[:, N - 37:] = False   # ragged tail
    mask[-1] = False           # an empty bag
    if not keep_masked:
        x[~mask] = 0.0
    x_scale = x_inv = None
    storage = variant.split("_")[0]
    if storage == "int8":
        x, x_scale = quantize_feats_int8(x)
    elif storage == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    if variant.endswith("_inv"):
        x_inv = feats_inv_norms(x.astype(np.float32))
    g = rng.normal(size=(B, P, C)).astype(np.float32)
    return q, x, mask, x_scale, x_inv, g


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("P", QUERIES)
def test_forward_matches_pallas_kernel(P, variant):
    """The CPU path of `coattn_pool` and `coattn_fwd_reference` (the plain
    version of the forward kernel, with the host 1/||x||) against the
    interpret-mode Pallas forward; the empty bag pools to exactly 0."""
    q, x, mask, x_scale, x_inv, _g = _inputs(variant, P)
    want = _jax_kernel(q, x, mask, x_scale, x_inv)
    assert want.shape == (B, P, C)
    tol = TOL_FWD[variant.split("_")[0]]
    tq, tx, tm, ts, ti = map(_torch, (q, x, mask, x_scale, x_inv))
    tco.reset_launches()
    pooled = tco.coattn_pool(tq, tx, tm, SCALE, x_scale=ts, x_inv=ti)
    assert sum(tco.LAUNCHES.values()) == 0 and sum(tco.LAUNCHES_QUERY_PATH.values()) == 0
    assert _rel(pooled.numpy(), want) < tol
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE, ts, ti)
    assert out.shape == (B, P, C) and m.shape == l.shape == (B, P)
    assert _rel(out.numpy(), want) < tol
    assert torch.all(out[-1] == 0) and torch.all(m[-1] == -1e30) and torch.all(l[-1] == 1e-30)


@pytest.mark.parametrize("variant", ("f32", "bf16", "int8"))
@pytest.mark.parametrize("P", QUERIES)
def test_rounded_model_matches_pallas_body(P, variant):
    """`coattn_fwd_rounded`, the plain model of the forward kernel's
    rounding, is generic in P: it meets the Pallas body as at P=12."""
    q, x, mask, x_scale, x_inv, _g = _inputs(variant, P, seed=3)
    out, m, l = tco.coattn_fwd_rounded(_torch(q), _torch(x), _torch(mask), SCALE,
                                       x_scale=_torch(x_scale))
    assert out.shape == (B, P, C)
    assert _rel(out.numpy(), _jax_kernel(q, x, mask, x_scale, x_inv)) <= TOL_ROUNDED[variant]
    assert torch.all(out[-1] == 0) and torch.all(m[-1] == -1e30)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("P", QUERIES)
def test_dq_matches_pallas_kernel(P, variant):
    """`coattn_bwd_dq_reference` (the dQ kernel's plain version, from the
    forward's stats) and autograd through the CPU path against `jax.vjp`
    of the interpret-mode kernels."""
    q, x, mask, x_scale, x_inv, g = _inputs(variant, P, seed=2)
    want = _jax_dq(q, x, mask, x_scale, x_inv, g)
    assert want.shape == (P, C) and np.isfinite(want).all()
    tol = TOL_DQ[variant.split("_")[0]]
    tq, tx, tm, ts, ti, tg = map(_torch, (q, x, mask, x_scale, x_inv, g))
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE, ts, ti)
    dq = tco.coattn_bwd_dq_reference(tq, tx, tm, SCALE, tg, out, m, l, ts, ti)
    assert _rel(dq.numpy(), want) < tol
    q_leaf = tq.clone().requires_grad_(True)
    tco.coattn_pool(q_leaf, tx, tm, SCALE, x_scale=ts, x_inv=ti).backward(tg)
    assert _rel(q_leaf.grad.numpy(), want) < tol
    assert _rel(dq.numpy(), q_leaf.grad.numpy()) < 1e-5


@pytest.mark.parametrize("storage", ("f32", "bf16"))
@pytest.mark.parametrize("P", QUERIES)
def test_dx_matches_pallas_kernel(P, storage):
    """`coattn_bwd_dx_reference` (the dX kernel's plain version) against
    `jax.vjp` of the interpret-mode `_coattn_bwd_kernel`, the masked rows
    holding features: dX exactly 0 there and on the empty bag."""
    q, x, mask, _s, _i, g = _inputs(storage, P, seed=1, keep_masked=True)
    want_dq, want_dx = _jax_grads(q, x, mask, g)
    tq, tx, tm, tg = map(_torch, (q, x, mask, g))
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE)
    dq, dx = tco.coattn_bwd_dx_reference(tq, tx, tm, SCALE, tg, out, m, l)
    assert dq.shape == (P, C) and dx.dtype == tx.dtype and dx.shape == (B, N, C)
    assert _rel(dq.numpy(), want_dq) < TOL_DX_DQ[storage]
    got = dx.float().numpy()
    if storage == "f32":
        assert _rel(got, want_dx) < 1e-5
    else:
        assert np.abs(got - want_dx).max() <= _bf16_ulp_of_max(want_dx)
    assert torch.all(dx[~tm] == 0) and torch.all(dx[-1] == 0)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("P", QUERIES)
def test_plain_versions_in_float64(P, variant):
    """`dtype=torch.float64`, the exact function that the f32 kernels are
    held against on the card: the forward within 1e-12 of its formula in
    numpy float64 (on the stored values, the int8 scales on the weights,
    host 1/||x|| where given), and the forward, dQ and dX in float64 within
    the f32 tolerances of their f32 runs (bf16 dX, rounded to bf16 on both,
    within one bf16 ulp)."""
    q, x, mask, x_scale, x_inv, g = _inputs(variant, P, seed=3, keep_masked=True)
    f64 = torch.float64
    tq, tx, tm, ts, ti, tg = map(_torch, (q, x, mask, x_scale, x_inv, g))
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE, ts, ti)
    e_out, e_m, e_l = tco.coattn_fwd_reference(tq, tx, tm, SCALE, ts, ti, dtype=f64)
    assert e_out.dtype == e_m.dtype == e_l.dtype == f64

    xs = np.asarray(x, np.float64)
    inv = (1 / np.sqrt(np.maximum((xs * xs).sum(-1), 1e-24)) if x_inv is None
           else np.asarray(x_inv, np.float64))
    logits = np.where(mask[:, None, :], SCALE * np.einsum("pc,bnc->bpn", q.astype(np.float64), xs)
                      * inv[:, None, :], -1e30)
    p = np.where(mask[:, None, :], np.exp(logits - logits.max(-1, keepdims=True)), 0.0)
    w = p if x_scale is None else p * np.asarray(x_scale, np.float64)[:, None, :]
    want = np.einsum("bpn,bnc->bpc", w, xs) / np.maximum(p.sum(-1), 1e-30)[..., None]
    assert _rel(e_out.numpy(), want) < 1e-12
    assert _rel(e_out.numpy(), out.numpy()) < TOL_FWD["f32"]

    dq = tco.coattn_bwd_dq_reference(tq, tx, tm, SCALE, tg, out, m, l, ts, ti)
    e_dq = tco.coattn_bwd_dq_reference(tq, tx, tm, SCALE, tg, out, m, l, ts, ti, dtype=f64)
    assert e_dq.dtype == f64 and _rel(e_dq.numpy(), dq.numpy()) < TOL_DX_DQ["f32"]
    storage = variant.split("_")[0]
    if storage != "int8" and x_inv is None:
        dq, dx = tco.coattn_bwd_dx_reference(tq, tx, tm, SCALE, tg, out, m, l)
        e_dq, e_dx = tco.coattn_bwd_dx_reference(tq, tx, tm, SCALE, tg, out, m, l, dtype=f64)
        assert e_dq.dtype == f64 and e_dx.dtype == tx.dtype
        assert _rel(e_dq.numpy(), dq.numpy()) < TOL_DX_DQ["f32"]
        if storage == "f32":
            assert _rel(e_dx.numpy(), dx.numpy()) < 1e-5
        else:
            got, ref = e_dx.float().numpy(), dx.float().numpy()
            assert np.abs(got - ref).max() <= _bf16_ulp_of_max(ref)


@pytest.mark.parametrize("P", QUERIES)
def test_looped_dx_groups_sum_to_the_plain_backward(P):
    """The looped dX kernel's decomposition, in f32: per group of 16 rows
    (the last zero-padded) the group's a' g' + scale dl' q and its share of
    coef, summed over the groups, then x coef once, gives the plain dX;
    the padded rows must carry a = dl = 0 -- a zero query row's softmax is
    uniform, not zero -- or they leak into dX."""
    q, x, mask, _s, _i, g = _inputs("f32", P, seed=4, keep_masked=True)
    tq, tx, tm, tg = map(_torch, (q, x, mask, g))
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE)
    _dq, want = tco.coattn_bwd_dx_reference(tq, tx, tm, SCALE, tg, out, m, l)
    groups = tco.query_groups(P)
    pad = groups * tco._QUERY_ROWS - P
    qp = torch.nn.functional.pad(tq, (0, 0, 0, pad))
    gp = torch.nn.functional.pad(tg, (0, 0, 0, pad))
    outp = torch.nn.functional.pad(out, (0, 0, 0, pad))
    mp, lp = (torch.nn.functional.pad(t, (0, pad)) for t in (m, l))
    lp[:, P:] = 1.0
    real = torch.arange(groups * tco._QUERY_ROWS) < P
    dxa, coef = torch.zeros_like(tx), torch.zeros(B, N)
    for k in range(groups):
        rows = slice(k * tco._QUERY_ROWS, (k + 1) * tco._QUERY_ROWS)
        xf, inv, a, dl = tco._weights_and_cotangent(qp[rows], tx, tm, SCALE, gp[:, rows],
                                                    outp[:, rows], mp[:, rows], lp[:, rows])
        keep = real[rows][None, :, None]
        a, dl = torch.where(keep, a, 0.0), torch.where(keep, dl, 0.0)
        raw = torch.einsum("pc,bnc->bpn", qp[rows], xf)
        dxa += torch.einsum("bpn,bpc->bnc", a, gp[:, rows]) \
            + SCALE * torch.einsum("bpn,pc->bnc", dl, qp[rows])
        coef += SCALE * (dl * raw).sum(1) * inv * inv
    got = dxa - tx * coef[..., None]
    assert _rel(got.numpy(), want.numpy()) < 1e-5
    # without zeroing the padded rows' weights the groups' sum goes wrong
    if P % tco._QUERY_ROWS:
        last = slice((groups - 1) * tco._QUERY_ROWS, groups * tco._QUERY_ROWS)
        _xf, _inv, a_pad, _dl = tco._weights_and_cotangent(
            qp[last], tx, tm, SCALE, gp[:, last], outp[:, last], mp[:, last], lp[:, last])
        assert float(a_pad[:, P % tco._QUERY_ROWS:].abs().max()) > 0


def test_query_plan_mirrors_the_kernel_source():
    """ops/coattn.py's query groups are csrc/'s: kRows rows a group, at most
    kMaxQueryGroups on one launch of a forward or dQ grid, past which both
    launch a chunk of groups at a time from its first (qz0), so that any P
    runs ("chunked", `grid_route`); no block's shared memory grows with P
    (the looped dX instance stages each group's 16 rows of stats, s_row
    from coattn_srow) and nothing refuses a query count; and the looped dX
    instance's tiles (loop_tile_of)."""
    csrc = Path(tco.__file__).parent / "csrc"
    common = (csrc / "coattn_common.cuh").read_text()
    bwd = (csrc / "coattn_bwd.cuh").read_text()
    fwd = (csrc / "coattn_fwd.cu").read_text()
    dx = (csrc / "coattn_bwd_dx.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(common, "kRows") == tco._QUERY_ROWS == 16
    assert const(common, "kMaxQueryGroups") == tco._MAX_QUERY_GROUPS
    chunks = "for (a.qz0 = 0; a.qz0 < qg; a.qz0 += kMaxQueryGroups) {"
    assert chunks in fwd and chunks in bwd
    assert "const int q0 = ((int)blockIdx.z + a.qz0) * kRows" in fwd
    assert "const int qb = LOOP ? 0 : ((int)blockIdx.z + a.qz0) * kRows;" in bwd
    assert "query_groups_of(P) > kMaxQueryGroups" not in fwd + bwd + dx
    assert "stat_rows" not in bwd and "total = rows + (size_t)(3 * kRows + 3 * tile) * 4 + tile;" in bwd
    assert "srow_s[tid] = a.srow[k];" in bwd and "coattn_srow<<<" in bwd
    assert "loops_groups(P, true) != (ws_srow != nullptr)" in dx
    assert [tco.grid_route(P) for P in (1, 16, 17, 1_048_560, 1_048_561)] == \
        ["single", "single", "grid", "grid", "chunked"]
    m = re.search(r"constexpr int loop_tile_of\(int storage\) \{ return storage == kF32 \? (\d+) : (\d+); \}",
                  bwd)
    assert (int(m.group(1)), int(m.group(2))) == (tco._DX_LOOP_TILE[torch.float32],
                                                  tco._DX_LOOP_TILE[torch.bfloat16])
    assert "return with_dx && P > kRows;" in bwd  # the looped instance: dX above 16
    assert "query_groups_of(int P) { return (P + kRows - 1) / kRows; }" in common
    assert [tco.query_groups(P) for P in (1, 16, 17, 32, 33, 128, 256)] == [1, 1, 2, 2, 3, 8, 16]


@pytest.mark.parametrize("P", (1, 12, 17, 32, 64, 128, 256))
def test_query_groups_share_one_wave(P):
    """The forward's and dQ's plan with the query groups on the grid: the
    qgroups * blocks blocks fill one wave on 132 SMs (L the even share of
    floor(132 / qgroups) ranges), every (tile, query row) pooled by exactly
    one block; P <= 16 is the plan of before.  At B=8, N=10240 the merge's
    f32 partials [B, Smax, P, C] stay within a tenth of bf16 x's bytes up
    to P=128."""
    n_sm, Bx, Nx, Cx = 132, 8, 10240, 512
    for dtype in tco._FWD_TILE:
        qg = tco.query_groups(P)
        plan = tco.kernel_plan("coattn_fwd", dtype, Bx, Nx, n_sm, Cx, P)
        assert plan == tco.kernel_plan("coattn_bwd_dq", dtype, Bx, Nx, n_sm, Cx, P)
        total, L = Bx * plan["tiles_per_bag"], plan["L"]
        assert L == -(-total // (n_sm // qg)) and plan["blocks"] * qg <= n_sm
        if qg == 1:
            assert plan == tco.fwd_plan(dtype, Bx, Nx, n_sm, Cx) \
                and L == -(-total // n_sm)
        covered = sorted((f, z) for k in range(plan["blocks"]) for z in range(qg)
                         for f in range(k * L, min(total, (k + 1) * L)))
        assert covered == [(f, z) for f in range(total) for z in range(qg)]
        if P <= 128:
            assert Bx * plan["Smax"] * P * Cx * 4 <= 0.1 * Bx * Nx * Cx * 2
    # the looped dX instance: tiles of 32 patches (f32 16), no query groups
    # on the grid
    for dtype, tile in ((torch.bfloat16, 32), (torch.float32, 16)):
        loop = tco.kernel_plan("coattn_bwd_dx", dtype, Bx, Nx, n_sm, Cx, P)
        if P <= 16:
            assert loop == tco.fwd_plan(dtype, Bx, Nx, n_sm, Cx)
            continue
        assert loop["tiles_per_bag"] == -(-Nx // tile)
        assert loop["L"] == -(-Bx * loop["tiles_per_bag"] // n_sm)


@pytest.mark.parametrize("C", (8, 16, 512, 1024))
@pytest.mark.parametrize("P", (12, 32, 8657, 20000, 100_000, 1_048_592))
def test_dq_workspace_is_capped(P, C):
    """The backward kernels' dq partials, [blocks, P, C] f32, stay within
    _DQ_WS_BYTES (or one partial, past it): a large P takes fewer blocks, a
    query and channel group's ranges still covering every tile once; at
    the counts the configs and phases run the plan is `fwd_plan`'s as
    before (the cap lies past them)."""
    n_sm, Bx, Nx = 132, 8, 10240
    for dtype in (torch.float32, torch.bfloat16):
        for name in ("coattn_bwd_dq", "coattn_bwd_dx"):
            plan = tco.kernel_plan(name, dtype, Bx, Nx, n_sm, C, P)
            ws = 4 * plan["blocks"] * P * C  # the wrappers' ws_dq [blocks, P, C] f32
            assert ws <= max(tco._DQ_WS_BYTES, 4 * P * C), (name, plan)
            total, L = Bx * plan["tiles_per_bag"], plan["L"]
            assert (plan["blocks"] - 1) * L < total <= plan["blocks"] * L
            qg = 1 if name == "coattn_bwd_dx" else tco.query_groups(P)
            uncapped = (tco.fwd_plan(dtype, Bx, Nx, n_sm, C, qg) if name == "coattn_bwd_dq"
                        else tco.fwd_plan(dtype, Bx, Nx, n_sm, C, tile=tco._DX_LOOP_TILE[dtype]
                                          if P > 16 else None))
            if 4 * uncapped["blocks"] * P * C <= tco._DQ_WS_BYTES:
                assert plan == uncapped
            else:
                assert plan["blocks"] == max(1, min(uncapped["blocks"],
                                                    tco._DQ_WS_BYTES // (4 * P * C)))
    # the looped dX at the phases' counts and C=512: 60 and 26 blocks of 132
    for P_, want in ((8657, 60), (20000, 26)):
        assert tco._DQ_WS_BYTES // (4 * P_ * 512) == want


def _past_inputs(storage: str, seed: int = 0):
    """Inputs past the looped dX instance's old limit: P = 8657 queries, C = 16,
    B = 2 (a ragged bag and an empty one), N = 128."""
    rng = np.random.default_rng(seed)
    P, Bp, Np, Cp = 8657, 2, 128, 16
    q = rng.normal(size=(P, Cp)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.normal(size=(Bp, Np, Cp)).astype(np.float32)
    mask = rng.random((Bp, Np)) > 0.1
    mask[-1] = False
    if storage == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    g = rng.normal(size=(Bp, P, Cp)).astype(np.float32)
    return q, x, mask, g


@pytest.mark.parametrize("storage", ("f32", "bf16"))
def test_plain_versions_match_pallas_past_8656_queries(storage):
    """Past 8,656 queries (the looped dX instance's old shared-memory limit)
    at C = 16: the forward, dQ and dX plain versions -- those the kernels are
    held against there on the card (chip_smoke.py phase 2g) -- against the
    interpret-mode Pallas kernels, at the tolerances of
    test_forward_matches_pallas_kernel and test_dx_matches_pallas_kernel."""
    q, x, mask, g = _past_inputs(storage)
    tq, tx, tm, tg = map(_torch, (q, x, mask, g))
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE)
    assert _rel(out.numpy(), _jax_kernel(q, x, mask, None, None)) < TOL_FWD[storage]
    assert torch.all(out[-1] == 0)
    dq = tco.coattn_bwd_dq_reference(tq, tx, tm, SCALE, tg, out, m, l)
    assert _rel(dq.numpy(), _jax_dq(q, x, mask, None, None, g)) < TOL_DQ[storage]
    want_dq, want_dx = _jax_grads(q, x, mask, g)
    dq, dx = tco.coattn_bwd_dx_reference(tq, tx, tm, SCALE, tg, out, m, l)
    assert _rel(dq.numpy(), want_dq) < TOL_DX_DQ[storage]
    if storage == "f32":
        assert _rel(dx.numpy(), want_dx) < 1e-5
    else:
        assert np.abs(dx.float().numpy() - want_dx).max() <= _bf16_ulp_of_max(want_dx)
    assert torch.all(dx[-1] == 0)


def _image_cfg(asset_root: str, **changes):
    text, image, prompt = flagship_cfgs(asset_root)
    return text, dict(image, **GATED_32, **changes), prompt


def test_vlfan_32_gated_queries_match():
    """VLFAN at the flagship's width with 33 parameter rows (32 queries and
    the gate), folded to P = 32 by `effective_query`, through the bridge:
    pooled features and query-diversity losses 1e-5."""
    _t, image, _p = _image_cfg("vlsa_tpu/assets")
    kw = {k: image[k] for k in ("query", "num_query", "gated_query", "query_pooling",
                                "use_feat_proj", "pred_head")}
    rng = np.random.default_rng(0)
    lengths = (300, 217, 0)
    x = np.zeros((3, 300, 512), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate(lengths):
        x[j, :n] = rng.normal(size=(n, 512))
        mask[j, :n] = True
    ref = JaxVLFAN(dim_in=512, **kw)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                               jnp.asarray(mask))["params"])
    assert params["Q"].shape == (33, 512)
    want = ref.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    port = VLFAN(dim_in=512, **kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.eval()
    with torch.no_grad():
        assert port.effective_query().shape == (32, 512)
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
        assert _rel(got.numpy(), want) < 1e-5
        div = port.query_div_loss()
    assert _rel(div.numpy(), ref.apply({"params": params}, method=ref.query_div_loss)) < 1e-5


@pytest.fixture(scope="module")
def gated_pair():
    text, image, prompt = _image_cfg(os.path.join(REPO, "vlsa_tpu", "assets"))
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    sd = state_dict_from_jax(jparams)
    return jmodel, jparams, sd


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_vlsa_32_gated_queries_logits_match(gated_pair, storage):
    """The small flagship VLSA with 32 gated parameter queries: logits 1e-4
    (tests/test_torch_vlsa.py's bags and storages)."""
    jmodel, jparams, sd = gated_pair
    text, image, prompt = _image_cfg("vlsa_tpu/assets")
    model, _ = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                          state_dict=sd)
    model.eval()
    assert model.mil_encoder.Q.shape == (33, 512) and model.query_adapter is None
    rng = np.random.default_rng(0)
    x = np.zeros((3, 300, 512), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate((300, 217, 123)):
        x[j, :n] = rng.normal(size=(n, 512))
        mask[j, :n] = True
    jkw, tkw = {}, {}
    if storage == "int8":
        xq, scale = quantize_feats_int8(x)
        inv = feats_inv_norms(xq)
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
        jkw = {"x_scale": jnp.asarray(scale), "x_inv": jnp.asarray(inv)}
        tkw = {"x_scale": torch.from_numpy(scale), "x_inv": torch.from_numpy(inv)}
    elif storage == "bfloat16":
        stored = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        jx, tx = jnp.asarray(stored), torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want, _img, _txt = jmodel.apply({"params": jparams}, jx, jnp.asarray(mask), **jkw)
    with torch.no_grad():
        got, _img, _txt = model(tx, torch.from_numpy(mask), **tkw)
    assert got.shape == (3, 12) and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) < 1e-4


def test_five_steps_with_32_gated_queries_match_jax_train_engine(gated_pair):
    """5 Adam steps of SurvIFMLE + SurvEMD (tests/test_torch_train.py's
    batches, optimizer and tolerances) in both packages from the same
    weights: per-step losses and every final parameter, the 33 query rows
    among the leaves that move."""
    jmodel, jparams, init = gated_pair
    frozen = jax_frozen_mask(jparams, ["prompt_encoder"])
    tx = jax_create_optimizer("adam", LR, WD, jparams, frozen=frozen)
    objective = jax_make_objective(jax_load_loss("vlsa", **LOSSES), WEIGHTS,
                                   jax_converter("softmax"), uses_vl=True)
    step = JaxTrainEngine(jmodel, tx, objective, uses_vl=True, frozen=frozen).train_step()
    p, state, jax_losses = jax.tree.map(jnp.asarray, jparams), tx.init(jparams), []
    for i, b in enumerate(_batches()):
        p, state, loss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                    jax.random.PRNGKey(i))
        jax_losses.append(float(loss))
    jax_final = state_dict_from_jax(jax.tree.map(np.asarray, p))

    text, image, prompt = _image_cfg("vlsa_tpu/assets")
    model, _tok = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                             state_dict=init)
    model.train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    engine = TrainEngine(model, create_optimizer("adam", LR, WD, model),
                         make_objective(load_loss("vlsa", **LOSSES), WEIGHTS,
                                        make_output_converter("softmax")))
    tco.reset_launches()
    losses, first_grad = [], {}
    for b in _batches():
        losses.append(float(engine.train_step({k: torch.from_numpy(v)
                                                for k, v in b.items()})[0]))
        first_grad = first_grad or {n: q.grad.abs().numpy() for n, q in
                                    model.named_parameters() if q.grad is not None}
    assert len(losses) == STEPS and sum(tco.LAUNCHES_QUERY_PATH.values()) == 0
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    final = model.state_dict()
    assert set(final) == set(jax_final)
    for name, got in final.items():
        got, want = got.float().numpy(), jax_final[name].float().numpy()
        if name.startswith("prompt_encoder."):
            np.testing.assert_array_equal(got, init[name].float().numpy(), err_msg=name)
            continue
        ok = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
        if name in NEAR_ZERO_GRADIENT:
            g0 = first_grad[name]
            near_zero = g0 < 1e-4 * g0.max()
            assert near_zero.mean() < 1e-2, name
            ok |= near_zero & (np.abs(got - want) <= 2 * LR)
        assert np.all(ok), f"{name}: max |a-b| {np.abs(got - want)[~ok].max():.3e}"
    for name in ("mil_encoder.Q", "mil_encoder.visual_adapter.weight",
                 "prompt_learner.context_embeds", "logit_scale"):
        assert not np.array_equal(final[name].numpy(), init[name].numpy()), name
