"""The port's co-attention pooling (vlsa_tpu_torch.ops.coattn) against the
JAX package's Pallas kernels, run in interpret mode, and against its plain
reference, on the same inputs made with numpy.

On the CPU `coattn_pool` runs the port's plain version, so this holds the
plain version that the CUDA kernel is checked against on the card.
Tolerances are max|a-b| / max|b|:
  * f32 1e-5: both sides compute in f32;
  * bf16 2e-4: the JAX kernel splits q and the softmax weights into hi/lo
    bf16 halves, ~16 mantissa bits instead of f32's 24;
  * int8 1e-3: the JAX kernel quantizes those matrices to int8 hi/lo rows
    (vlsa_tpu/ops/coattn.py::_mm_rows_i8), the coattn_int8 forward
    tolerance of scripts/validate_kernels_chip.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import vlsa_tpu.ops.coattn as jco
from vlsa_tpu.data.pipeline import feats_inv_norms, quantize_feats_int8
from vlsa_tpu_torch.ops import coattn as tco

B, N, C, P, SCALE = 3, 512, 64, 12, 30.0
TOL = {"f32": 1e-5, "bf16": 2e-4, "bf16_inv": 2e-4, "int8": 1e-3, "int8_inv": 1e-3}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _inputs(variant: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(P, C)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = rng.random((B, N)) > 0.1
    mask[:, N - 37:] = False   # ragged tail
    mask[-1] = False           # an empty bag
    x[~mask] = 0.0
    x_scale = x_inv = None
    if variant.startswith("int8"):
        x, x_scale = quantize_feats_int8(x)
        stored = x.astype(np.float32) * x_scale[..., None]
    elif variant.startswith("bf16"):
        x = x.astype(ml_dtypes.bfloat16)
        stored = x.astype(np.float32)
    else:
        stored = x
    if variant.endswith("_inv"):
        x_inv = feats_inv_norms(x.astype(np.float32))
    return q, x, mask, x_scale, x_inv, stored


def _jax_kernel(q, x, mask, x_scale, x_inv):
    old = jco.INTERPRET
    jco.INTERPRET = True
    try:
        args = (jnp.asarray(q), jnp.asarray(x))
        if x_scale is None and x_inv is None:
            out = jco._coattn_pool_tpu_nodx(*args, jnp.asarray(mask), jnp.float32(SCALE))
        else:
            out = jco._coattn_pool_tpu_nodx_q8(
                *args, None if x_scale is None else jnp.asarray(x_scale),
                None if x_inv is None else jnp.asarray(x_inv), jnp.asarray(mask),
                jnp.float32(SCALE))
        return np.asarray(out)
    finally:
        jco.INTERPRET = old


def _torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("variant", list(TOL))
def test_coattn_pool_matches_pallas_kernel(variant):
    q, x, mask, x_scale, x_inv, stored = _inputs(variant)
    tco.reset_launches()
    out = tco.coattn_pool(_torch(q), _torch(x), _torch(mask), SCALE,
                          x_scale=_torch(x_scale), x_inv=_torch(x_inv)).numpy()
    assert sum(tco.LAUNCHES.values()) == 0  # the CPU path launches no kernel
    assert out.shape == (B, P, C) and np.isfinite(out).all()
    assert np.all(out[-1] == 0.0)           # the empty bag pools to exactly 0

    ref_kernel = _jax_kernel(q, x, mask, x_scale, x_inv)
    assert _rel(out, ref_kernel) < TOL[variant]

    # the JAX plain reference on the same stored values, in f32
    ref_plain = np.asarray(jco.coattn_pool_reference(
        jnp.asarray(q), jnp.asarray(stored), jnp.asarray(mask), SCALE))
    assert _rel(out, ref_plain) < 1e-5


def test_attention_reference_rows_sum_to_one():
    q, x, mask, _s, _i, _st = _inputs("f32", seed=1)
    attn = tco.coattn_attention_reference(_torch(q), _torch(x), _torch(mask), SCALE)
    sums = attn.sum(-1).numpy()
    np.testing.assert_allclose(sums[:-1], 1.0, atol=1e-5)
    assert np.all(sums[-1] == 0.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, x, mask, _s, _i, _st = _inputs("f32")
    with pytest.raises(ValueError, match="CUDA"):
        tco.coattn_fwd(_torch(q), _torch(x), _torch(mask), SCALE)
    xi, s = quantize_feats_int8(x)
    with pytest.raises(ValueError, match="x_scale"):
        tco.coattn_pool(_torch(q), _torch(xi), _torch(mask), SCALE)


@pytest.mark.parametrize("B_,N_", [(8, 10240), (64, 10240), (1, 5), (2, 0)])
def test_split_plan_covers_every_patch(B_, N_):
    """The kernels' plan, for each storage's tile: the blocks' flat ranges
    of L tiles cover every tile of every bag once, and each bag's partial
    slots k - first(b) stay below Smax (the forward); the backward's blocks
    each write one dq partial over their range, ranges crossing bags, and
    dq is the sum of those partials in block order."""
    for dtype, tile in tco._FWD_TILE.items():
        plan = tco.fwd_plan(dtype, B_, N_, n_sm=132)
        tiles, L, blocks = plan["tiles_per_bag"], plan["L"], plan["blocks"]
        assert tiles * tile >= N_ > (tiles - 1) * tile
        covered = [f for k in range(blocks) for f in range(k * L, min(B_ * tiles, (k + 1) * L))]
        assert covered == list(range(B_ * tiles))
        for b in range(B_ if tiles else 0):
            slots = {f // L - (b * tiles) // L for f in range(b * tiles, (b + 1) * tiles)}
            assert slots == set(range(len(slots))) and len(slots) <= plan["Smax"]
        if N_ == 0:
            assert blocks == 0  # dq is then the reduction of no partials: 0
            continue
        # the backward at P=2, C=8: block k's partial is the sum over its
        # tiles of dl_tile . x_tile; dq = scale * the partials summed in order
        gen = torch.Generator().manual_seed(B_)
        q = torch.nn.functional.normalize(torch.randn(2, 8, generator=gen), dim=-1)
        x = torch.randn(B_, N_, 8, generator=gen)
        mask = torch.rand(B_, N_, generator=gen) > 0.1
        gout = torch.randn(B_, 2, 8, generator=gen)
        out, m, l = tco.coattn_fwd_reference(q, x, mask, SCALE)
        xf, _inv, _a, dl = tco._weights_and_cotangent(q, x, mask, SCALE, gout, out, m, l)
        pad = tiles * tile - N_
        dl_t = torch.nn.functional.pad(dl, (0, pad)).reshape(B_, 2, tiles, tile) \
            .permute(0, 2, 1, 3).reshape(B_ * tiles, 2, tile)
        x_t = torch.nn.functional.pad(xf, (0, 0, 0, pad)).reshape(B_ * tiles, tile, 8)
        per_tile = torch.bmm(dl_t, x_t)
        dq = torch.zeros(2, 8)
        for k in range(blocks):
            dq += per_tile[k * L:(k + 1) * L].sum(0)
        ref = tco.coattn_bwd_dq_reference(q, x, mask, SCALE, gout, out, m, l)
        torch.testing.assert_close(SCALE * dq, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B_,N_", [(8, 10240), (64, 10240), (32, 8192), (32, 65536),
                                   (32, 131072), (1, 5)])
def test_fwd_plan_fills_one_wave(B_, N_):
    """One block per SM: at C=512 at most n_sm blocks, each of the even
    share of the tiles rounded up, so the busiest block has at most one tile
    more than the average; at B=8 the partials (P=12, C=512, f32) stay within
    5% of x's bf16 bytes.  Above 512 channels the blocks of the G channel
    groups share the wave: L is the even share of G times the tiles."""
    n_sm = 132
    for dtype in tco._FWD_TILE:
        for C in (512, 1024, 1536):
            plan = tco.fwd_plan(dtype, B_, N_, n_sm, C)
            total, G = B_ * plan["tiles_per_bag"], plan["groups"]
            assert G == -(-C // 512)
            assert plan["L"] == -(-G * total // n_sm) and plan["blocks"] * G <= n_sm + G - 1
            if C == 512:
                assert plan["blocks"] <= n_sm and plan["L"] <= total / min(n_sm, total) + 1
            if (B_, N_, C) == (8, 10240, 512):
                segments = plan["blocks"] + B_  # a range holds at most one bag boundary here
                assert segments * 12 * 512 * 4 <= 0.05 * B_ * N_ * 512 * 2


def test_fwd_plan_mirrors_the_kernel_source():
    """ops/coattn.py's tiles and warp widths are csrc/'s, which the forward
    and backward kernels share (coattn_common.cuh): tile_of, kWarpCh,
    kMaxWarps and the channel group kGroupCh."""
    import re
    from pathlib import Path
    src = (Path(tco.__file__).parent / "csrc" / "coattn_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    m = re.search(r"constexpr int tile_of\(int storage\) \{ return storage == kF32 \? (\d+) : (\d+); \}",
                  src)
    assert (int(m.group(1)), int(m.group(2))) == (tco._FWD_TILE[torch.float32],
                                                  tco._FWD_TILE[torch.bfloat16])
    assert tco._FWD_TILE[torch.int8] == tco._FWD_TILE[torch.bfloat16]
    assert const("kWarpCh") == tco._FWD_WARP_CH
    assert const("kMaxWarps") == tco._FWD_MAX_WARPS
    assert "constexpr int kGroupCh = kWarpCh * kMaxWarps;" in src
    assert tco._FWD_GROUP_CH == 512


# the rounding model against the Pallas body in interpret mode, max|a-b| /
# max|b|: bf16 rounds q and the weights as the TPU kernel does, so the model
# sits closer to it than the true-f32 plain version (~1e-6 against ~5e-6;
# the sums' order differs); int8's TPU route rounds them to int8 hi + lo
# (~15 bits) where the model takes bf16 hi + lo (~16 bits): ~2.7e-4; f32,
# which the TPU takes at HIGHEST precision, the model in split TF32 (~2^-21)
TOL_ROUNDED = {"f32": 2e-6, "bf16": 1e-5, "int8": 5e-4}


@pytest.mark.parametrize("variant", list(TOL_ROUNDED))
def test_rounded_model_matches_pallas_body(variant):
    q, x, mask, x_scale, x_inv, _stored = _inputs(variant, seed=3)
    args = (_torch(q), _torch(x), _torch(mask), SCALE)
    out, m, l = tco.coattn_fwd_rounded(*args, x_scale=_torch(x_scale))
    ref = _jax_kernel(q, x, mask, x_scale, x_inv)
    assert _rel(out.numpy(), ref) <= TOL_ROUNDED[variant]
    assert np.all(out[-1].numpy() == 0.0) and bool(torch.all(m[-1] == -1e30))
    plain, _m, l_plain = tco.coattn_fwd_reference(*args, x_scale=_torch(x_scale))
    if variant == "bf16":
        assert _rel(out.numpy(), ref) < _rel(plain.numpy(), ref)
    np.testing.assert_allclose(l.numpy(), l_plain.numpy(), rtol=1e-4)


def test_split_tf32_model():
    """The rounding model's TF32 split: hi has the 13 low mantissa bits
    clear and is within half a TF32 step of t, lo within a TF32 step of the
    residual t - hi, and hi + lo within 2^-21 of t (relative)."""
    t = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 1e3
    hi, lo = tco._split_tf32(t)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((t - hi).abs() <= t.abs() * 2.0 ** -11)
    assert torch.all((t - hi - lo).abs() <= (t - hi).abs() * 2.0 ** -10)
    assert float(((t - hi - lo).abs() / t.abs()).max()) <= 2.0 ** -21


def test_ptxas_report_reads_stack_frames_and_spills():
    """`_build.ptxas_report` reads each kernel's registers, local-memory
    stack frame and spills from nvcc's -Xptxas -v output, which chip_smoke.py
    holds the co-attention backward to (no spill, no stack frame)."""
    from vlsa_tpu_torch.ops import _build
    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    192 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 242 registers, used 1 barriers, 192 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    16 bytes stack frame, 48 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes cumulative stack size, 40 bytes smem
"""
    a, b = _build.ptxas_report(log)
    assert a == {"function": "_Z1av", "registers": 242, "stack": 192, "spill_stores": 0,
                 "spill_loads": 0, "smem": 0}
    assert b == {"function": "_Z1bv", "registers": 255, "stack": 16, "spill_stores": 48,
                 "spill_loads": 32, "smem": 40}
