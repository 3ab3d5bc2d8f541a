"""The port's plain ABMIL pooling (vlsa_tpu_torch.ops.abmil) against the
vlsa_tpu Pallas kernels in interpret mode, set as tests/test_models.py and
tests/test_int8.py set them (`ab.INTERPRET = True`, restored after).

Shape B=3, N=512, D=64, hid=32, a ragged mask and one empty bag; the same
numpy inputs go to both packages.  Tolerances (max|a-b| / max|b|):
  - f32: 1e-5 -- both true f32, the differences are summation order;
  - bf16: 1e-4 for out, dW1, db1, dw2 -- both round W1 and dz to bf16 as
    the TPU kernels do and accumulate in f32; dX 1e-2, one bf16 ulp of the
    written value (2^-8) where the f32 sums round to neighbouring bf16s;
  - int8: 1e-3 forward, 2e-3 weight gradients, as tests/test_int8.py holds
    the JAX kernels against f32: the JAX kernel splits W1 and s*dz into two
    int8 parts (~15 bits), the port's plain version is f32.  The plain model
    of the int8 forward kernel's rounding (`abmil_fwd_rounded`, W1 split as
    the JAX kernel splits it) is held tighter: see its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlsa_tpu.ops.abmil as ab
from vlsa_tpu_torch.ops import abmil as pab

B, N, D, HID = 3, 512, 64, 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 1e-4}
TOL_DX = {"f32": 1e-5, "bf16": 1e-2}


@pytest.fixture
def interpret():
    old = ab.INTERPRET
    ab.INTERPRET = True
    yield
    ab.INTERPRET = old


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[0, :N] = True
    mask[1, :300] = True
    mask[1, 40:60] = False
    # bag 2 is empty
    x = x * mask[..., None]
    w1 = (rng.normal(size=(HID, D)) * 0.2).astype(np.float32)
    b1 = (rng.normal(size=HID) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=HID) * 0.3).astype(np.float32)
    g = rng.normal(size=(B, D)).astype(np.float32)
    return x, mask, w1, b1, w2, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _quantize(x):
    amax = np.abs(x).max(-1) / 127.0
    q = np.clip(np.rint(x / np.where(amax > 0, amax, 1.0)[..., None]), -127, 127)
    return q.astype(np.int8), amax.astype(np.float32)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_forward_and_backward_match_pallas(interpret, storage):
    x, mask, w1, b1, w2, g = _inputs()
    jdt, tdt = DTYPES[storage]
    xj = jnp.asarray(x).astype(jdt)
    out_j, stats = ab._abmil_pallas(xj, jnp.asarray(mask), jnp.asarray(w1), jnp.asarray(b1),
                                    jnp.asarray(w2))
    dx_j, dw1_j, db1_j, dw2_j = ab._abmil_pallas_bwd(
        xj, jnp.asarray(mask), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(g), out_j, stats[:, 0, :])

    xt = _t(x).to(tdt)
    out, m, l = pab.abmil_fwd_reference(xt, _t(mask), _t(w1), _t(b1), _t(w2))
    assert _rel(out, out_j) <= TOL[storage]
    np.testing.assert_allclose(m.numpy(), np.asarray(stats[:, 0, 0]), rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(stats[:, 0, 1]), rtol=1e-5)
    assert m[2] == torch.tensor(-1e30) and l[2] == torch.tensor(1e-30) and torch.all(out[2] == 0)

    dx, dw1, db1, dw2 = pab.abmil_bwd_reference(xt, _t(mask), _t(w1), _t(b1), _t(w2), _t(g),
                                                out, m, l)
    assert dx.dtype == tdt
    assert _rel(dx.float(), jnp.asarray(dx_j, jnp.float32)) <= TOL_DX[storage]
    for name, got, want in (("dw1", dw1, dw1_j), ("db1", db1, db1_j), ("dw2", dw2, dw2_j)):
        assert _rel(got, want) <= TOL[storage], name
    assert torch.all(dx[2].float() == 0)


def test_int8_matches_pallas(interpret):
    x, mask, w1, b1, w2, g = _inputs(seed=1)
    q, s = _quantize(x)
    args = (jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
    out_j, stats = ab._abmil_q8_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask), *args)
    dw1_j, db1_j, dw2_j = ab._abmil_q8_pallas_bwd(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask), *args, jnp.asarray(g), out_j,
        stats)

    out, m, l = pab.abmil_fwd_reference(_t(q), _t(mask), _t(w1), _t(b1), _t(w2), x_scale=_t(s))
    assert _rel(out, out_j) <= 1e-3
    assert torch.all(out[2] == 0) and m[2] == torch.tensor(-1e30)
    dx, dw1, db1, dw2 = pab.abmil_bwd_reference(_t(q), _t(mask), _t(w1), _t(b1), _t(w2),
                                                _t(g), out, m, l, x_scale=_t(s))
    assert dx is None
    for name, got, want in (("dw1", dw1, dw1_j), ("db1", db1, db1_j), ("dw2", dw2, dw2_j)):
        assert _rel(got, want) <= 2e-3, name


def test_int8_split_matches_the_jax_split():
    """The port's int8 split of W1 (the int8 forward kernel's prep_w1_i8
    mirrors it) equals vlsa_tpu's _mm_rows_i8 bit for bit: hi, lo and s_w,
    for W1 of several scales, a W1 with exact ties (v - hi = 0.5 after the
    scale) and an all-zero W1."""
    from vlsa_tpu.ops.coattn import _mm_rows_i8
    rng = np.random.default_rng(7)
    mats = [(rng.normal(size=(HID, D)) * scale).astype(np.float32)
            for scale in (1e-3, 0.05, 1.0, 40.0)]
    ties = np.full((HID, D), 0.5, np.float32)
    ties[0, 0] = 127.0  # s_w = 1: every other entry sits on a tie
    mats += [ties, np.zeros((HID, D), np.float32)]
    for w in mats:
        stacked, (s_j,) = _mm_rows_i8(jnp.asarray(w))
        stacked = np.asarray(stacked)
        hi, lo, s = pab.split_w1_i8(_t(w))
        assert hi.dtype == lo.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(hi.numpy(), stacked[:HID])
        assert np.array_equal(lo.numpy(), stacked[HID:])
        assert np.asarray(s_j, np.float32).tobytes() == s.numpy().tobytes()


def test_int8_rounded_model_matches_pallas(interpret):
    """`abmil_fwd_rounded`, the plain model of the int8 forward kernel's
    rounding, against vlsa_tpu's _abmil_q8_pallas in interpret mode: both
    split W1 into int8 hi + lo alike, so the stats (m, l) agree within 2e-6
    (relative for l, absolute for m), where the unsplit f32 plain version
    misses them by 1e-5 or more; out within 2e-4, since the JAX kernel also
    splits its PV weights p*s into int8 hi + lo (~2^-15 of the largest
    weight) and the model, like the port's kernel, keeps them in f32."""
    for seed in (1, 4):
        x, mask, w1, b1, w2, _g = _inputs(seed=seed)
        q, s = _quantize(x)
        out_j, stats = ab._abmil_q8_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask),
                                           jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
        m_j, l_j = np.asarray(stats[:2, 0, 0]), np.asarray(stats[:2, 0, 1])
        args = (_t(q), _t(mask), _t(w1), _t(b1), _t(w2))
        out, m, l = pab.abmil_fwd_rounded(*args, x_scale=_t(s))
        assert _rel(out, out_j) <= 2e-4
        assert np.abs(m.numpy()[:2] - m_j).max() <= 2e-6
        assert np.abs(l.numpy()[:2] / l_j - 1).max() <= 2e-6
        assert torch.all(out[2] == 0)
        assert m[2] == torch.tensor(-1e30) and l[2] == torch.tensor(1e-30)
        _o, m_f, l_f = pab.abmil_fwd_reference(*args, x_scale=_t(s))
        gap_f = max(np.abs(m_f.numpy()[:2] - m_j).max(), np.abs(l_f.numpy()[:2] / l_j - 1).max())
        assert gap_f > 1e-5
    assert pab.abmil_fwd_rounded(_t(x).to(torch.bfloat16), *args[1:])[0].equal(
        pab.abmil_fwd_reference(_t(x).to(torch.bfloat16), *args[1:])[0])


def test_pool_reference_matches_jax():
    """The plain module path (b2 added, raw logits returned) against
    vlsa_tpu's abmil_pool_reference in f32."""
    x, mask, w1, b1, w2, _g = _inputs(seed=2)
    out_j, raw_j = ab.abmil_pool_reference(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w1),
                                           jnp.asarray(b1), jnp.asarray(w2), 0.3)
    out, raw = pab.abmil_pool_reference(_t(x), _t(mask), _t(w1), _t(b1), _t(w2), 0.3)
    assert _rel(out, out_j) <= 1e-5 and _rel(raw, raw_j) <= 1e-5


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_cpu_route_autograd_matches_bwd_reference(storage):
    """Autograd through `abmil_pool`'s CPU route equals the plain backward.
    f32 and int8: 1e-5 (same f32 math).  bf16: the plain backward rounds dz
    to bf16 for dX and dW1 as the kernels do, autograd keeps dz in f32:
    2e-2 for dX and dW1 (bf16 rounding of dz, 2^-9, summed), 1e-5 for db1
    and dw2 (no rounding on either side)."""
    x, mask, w1, b1, w2, g = _inputs(seed=3)
    scale = None
    if storage == "int8":
        q, s = _quantize(x)
        xt, scale = _t(q), _t(s)
    else:
        xt = _t(x).to(DTYPES[storage][1]).requires_grad_(True)
    params = [_t(a).requires_grad_(True) for a in (w1, b1, w2)]
    out = pab.abmil_pool(xt, _t(mask), *params, b2=0.7, x_scale=scale)
    (out * _t(g)).sum().backward()
    with torch.no_grad():
        ref_out, m, l = pab.abmil_fwd_reference(xt, _t(mask), *params, x_scale=scale)
    dx, dw1, db1, dw2 = pab.abmil_bwd_reference(xt.detach(), _t(mask), *params, _t(g),
                                                ref_out, m, l, x_scale=scale)
    loose = 2e-2 if storage == "bf16" else 1e-5
    assert _rel(params[0].grad, dw1) <= loose
    assert _rel(params[1].grad, db1) <= 1e-5 and _rel(params[2].grad, dw2) <= 1e-5
    if storage == "int8":
        assert dx is None
    else:
        assert _rel(xt.grad.float(), dx.float()) <= loose


def test_cuda_route_needs_a_card():
    """A wrapper launches its kernel or raises: a CPU tensor is refused."""
    x, mask, w1, b1, w2, _g = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        pab.abmil_fwd(_t(x), _t(mask), _t(w1), _t(b1), _t(w2))
    assert sum(pab.LAUNCHES.values()) == 0


# ---- the kernels' launch plans (csrc/abmil_fwd.cu, csrc/abmil_bwd.cu) ----

def test_f32_plan_mirrors_the_kernel_source():
    """ops/abmil.py's tile and weight-gradient tiling are the kernel
    source's: kMF (the f32 tile, and every storage's backward pass 1), the
    widths, and pass 2's dW1 tiles and rows a stage (f32; bf16 and int8)."""
    import re
    from pathlib import Path
    csrc = Path(pab.__file__).parent / "csrc"
    common = (csrc / "abmil_common.cuh").read_text()
    bwd = (csrc / "abmil_bwd.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(common, "kMF") == pab._TILE[torch.float32] == pab._FWD_TILE[torch.float32]
    assert const(common, "kD") == pab.D_KERNEL and const(common, "kHid") == pab.HID_KERNEL
    tiles = (pab.HID_KERNEL // const(bwd, "kDwM")) * (pab.D_KERNEL // const(bwd, "kDwN"))
    assert tiles == pab._DW_TILES and const(bwd, "kRowsDw") == pab._DW_ROWS[torch.float32]
    assert const(bwd, "kRowsDwB") == pab._DW_ROWS[torch.bfloat16] == pab._DW_ROWS[torch.int8]


def test_fwd_tiles_mirror_the_kernel_source():
    """The forward's tiles and W1 workspace in ops/abmil.py are the kernel
    source's: the bf16 and int8 tile kMQ, 64 rows for each of the block's
    warpgroups (kThreads / 128), the tile of every backward's pass 1 kMF,
    and the int8 scale workspace's partial maxima kAmaxBlocks (in the
    common header since the backward's general instance splits W1 too)."""
    import re
    from pathlib import Path
    csrc = Path(pab.__file__).parent / "csrc"
    common = (csrc / "abmil_common.cuh").read_text()
    fwd = (csrc / "abmil_fwd.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(fwd, "kMQ") == pab._FWD_TILE[torch.bfloat16] == pab._FWD_TILE[torch.int8]
    assert 64 * (const(common, "kThreads") // 128) == const(fwd, "kMQ")
    assert all(pab._TILE[d] == const(common, "kMF") for d in pab._TILE)
    assert const(common, "kAmaxBlocks") == pab._AMAX_BLOCKS
    assert pab.fwd_plan(torch.int8, 1, 1, 132)["w1_scale"] == (1 + const(common, "kAmaxBlocks"),)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n_sm", [132, 7])
def test_plans_cover_every_n(dtype, n_sm):
    """For a sweep of B and N: every chunk is a multiple of its kernel's tile
    (the forward's _FWD_TILE, the backward's pass-1 _TILE) and the chunks
    cover N exactly (the last one non-empty); the weight-gradient chunks
    cover the B*N patch rows; the workspaces have the shapes and types the
    kernels index (the forward's W1 in bf16, or int8 hi and lo with s_w and
    the partial maxima; the backward's W1 as bf16 hi and lo, bf16's dz in
    bf16, int8's s dz as bf16 hi and lo)."""
    tile, tile_f = pab._TILE[dtype], pab._FWD_TILE[dtype]
    for B in (1, 3, 8, 32):
        for N in (1, 5, 63, 64, 65, 127, 128, 129, 1000, 4097, 12291, 16384):
            f = pab.fwd_plan(dtype, B, N, n_sm)
            assert f["chunk"] % tile_f == 0
            assert (f["S"] - 1) * f["chunk"] < N <= f["S"] * f["chunk"]
            assert f["ws_m"] == f["ws_l"] == (B, f["S"]) and f["ws_acc"] == (B, f["S"], 512)
            b = pab.bwd_plan(dtype, B, N, n_sm)
            assert b["chunk1"] % tile == 0 and (b["S1"] - 1) * b["chunk1"] < N <= b["S1"] * b["chunk1"]
            if dtype == torch.float32:
                assert f["w1_ws"] is None and f["w1_scale"] is None and b["w1_bf16"] is None
            else:
                assert b["w1_bf16"] == (2, 256, 512)
            if dtype == torch.bfloat16:
                assert f["w1_ws"] == (256, 512) and f["w1_scale"] is None
            if dtype == torch.int8:
                assert f["w1_ws"] == (2, 256, 512) and f["w1_scale"] == (65,)
            K = B * N
            assert b["chunk2"] % pab._DW_ROWS[dtype] == 0
            assert (b["S2"] - 1) * b["chunk2"] < K <= b["S2"] * b["chunk2"]
            assert b["S2"] * pab._DW_TILES <= max(n_sm, pab._DW_TILES)
            if dtype == torch.int8:
                assert b["ds"] == (2, B, N, 256) and b["ds_dtype"] == torch.bfloat16
            else:
                assert b["ds"] == (B, N, 256) and b["ds_dtype"] == dtype
            assert b["ws_dw1"] == (b["S2"], 256, 512) and b["ws_b"] == (B * b["S1"], 256)


@pytest.mark.parametrize("B, N", [(8, 10240), (32, 16384), (32, 65536), (1, 5)])
def test_f32_plan_fills_the_waves(B, N):
    """f32 blocks run one per SM: the plan's waves of chunk/tile tiles end
    within one chunk of the even share of the tiles; both kernels take the
    same chunks."""
    n_sm, tile = 132, pab._TILE[torch.float32]
    f = pab.fwd_plan(torch.float32, B, N, n_sm)
    tiles = -(-N // tile)
    waves = -(-B * f["S"] // n_sm)
    assert waves * (f["chunk"] // tile) <= -(-B * tiles // n_sm) + f["chunk"] // tile
    assert pab.bwd_plan(torch.float32, B, N, n_sm)["chunk1"] == f["chunk"]


@pytest.mark.parametrize("B, N", [(8, 10240), (32, 16384), (32, 65536), (32, 131072), (1, 5),
                                  (5, 12291)])
def test_bf16_int8_fwd_plan_fills_the_waves(B, N):
    """The bf16 and int8 forward blocks run one per SM, as f32's do, over
    tiles of 128 patches: the waves of chunk/tile tiles end within one chunk
    of the even share of the tiles, and a wave holds at most n_sm blocks
    when one wave does the work."""
    for dtype in (torch.bfloat16, torch.int8):
        n_sm, tile = 132, pab._FWD_TILE[dtype]
        f = pab.fwd_plan(dtype, B, N, n_sm)
        tiles = -(-N // tile)
        waves = -(-B * f["S"] // n_sm)
        assert waves * (f["chunk"] // tile) <= -(-B * tiles // n_sm) + f["chunk"] // tile
        if B * tiles <= n_sm:
            assert f["chunk"] == tile and waves == 1


@pytest.mark.parametrize("B, N", [(8, 10240), (32, 16384), (32, 65536), (32, 131072), (1, 5)])
def test_bf16_bwd_plan_fills_the_waves(B, N):
    """bf16's and int8's pass 1 runs one block per SM as f32's does: its
    waves of chunk/tile tiles end within one chunk of the even share of the
    tiles; pass 2's _DW_TILES blocks a chunk fill at most one wave, and its
    chunks are within one stage of rows of the even share of the B*N rows."""
    for dtype in (torch.bfloat16, torch.int8):
        n_sm, tile = 132, pab._TILE[dtype]
        b = pab.bwd_plan(dtype, B, N, n_sm)
        tiles = -(-N // tile)
        waves = -(-B * b["S1"] // n_sm)
        assert waves * (b["chunk1"] // tile) <= -(-B * tiles // n_sm) + b["chunk1"] // tile
        assert b["S2"] * pab._DW_TILES <= n_sm
        assert b["chunk2"] < -(-B * N // b["S2"]) + pab._DW_ROWS[dtype]


@pytest.mark.parametrize("name", ["cvt", "one_chain", "chains", "volatile", "fast_tanh",
                                  "sync_wgmma", "no_tanh", "no_wgmma", "no_pv", "no_w1", "no_x",
                                  "no_sync", "general"])
def test_variants_edit_the_kernel_source(name):
    """Each design alternative of ops/abmil_variants.py (f32; the bf16 and
    int8 forward's; every width on the general instances) is an edit that
    applies once to the kernel source as it stands."""
    from pathlib import Path
    from vlsa_tpu_torch.ops import abmil_variants as av
    csrc = Path(pab.__file__).parent / "csrc"
    edits = av.VARIANTS.get(name) or av.FWD_VARIANTS.get(name) or av.GENERAL_VARIANTS[name]
    assert edits
    for file, old, new in edits:
        assert (csrc / file).read_text().count(old) == 1 and old != new
