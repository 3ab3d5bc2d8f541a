"""The port's plain flash self-attention against vlsa_tpu's
`_flash_self_attention` (JAX's library Pallas TPU flash kernel, run in
interpret mode on the CPU) and against the dense attention of its
TimmViTBlock, at L = 1, 37, 785 (CONCH at 448 px), 801 (just past the
resident capacity) and 1025 (CONCH at 512 px), hd = 64.

Tolerances (max|a-b| / max|b|):
  * vs the Pallas kernel, f32: 1e-5 (both f32 up to summation order);
    bf16: 4e-3, one bf16 ulp of the largest output -- the kernel rounds its
    output to bf16 and the port's (f32) result is rounded so too, but f32
    summation order flips some of those roundings (measured 0 at L=37,
    1.2e-3 at L=785);
  * vs the dense path, f32: 1e-5; bf16: 2e-3 -- both round the normalised
    P to bf16, but an f32 value within summation-order distance of a bf16
    boundary rounds apart (measured 2.1e-4 at L=785).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vlsa_tpu.models.vision_tower import _flash_self_attention
from vlsa_tpu_torch.ops import flash_attn as fa

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(L, seed=0, B=1, H=2, hd=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, L, hd)).astype(np.float32) for _ in range(3)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _plain(arrays, dtype):
    return fa.flash_self_attention_reference(
        *(torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 37, 785, 801, 1025])
def test_plain_matches_pallas_flash(L, dtype):
    arrays = _inputs(L)
    with pltpu.force_tpu_interpret_mode():
        want = _flash_self_attention(*(jnp.asarray(a, dtype) for a in arrays))
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = _plain(arrays, dtype)
    assert got.dtype == torch.float32 and got.shape == (1, 2, L, 64)
    got = got.to(DTYPES[dtype]).float().numpy()  # the kernel's output rounding
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else 4e-3)


def _dense(arrays, dtype):
    """vlsa_tpu/models/vision_tower.py:429-433, the block's non-TPU path."""
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    attn = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q, k,
                                     preferred_element_type=jnp.float32)
                          / np.sqrt(q.shape[-1]), -1)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", attn.astype(dtype), v,
                                 preferred_element_type=jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 37, 785, 801, 1025])
def test_plain_matches_dense_block_attention(L, dtype):
    arrays = _inputs(L, seed=1, B=2)
    got = _plain(arrays, dtype).numpy()
    assert _rel(got, _dense(arrays, dtype)) <= (1e-5 if dtype == "float32" else 2e-3)


@pytest.mark.parametrize("L", [197, 785, 801, 1025])
def test_zero_query_probe_matches_dense_block_attention(L):
    """q = 0, v = 1 in bf16: every score is 0, so P = 1/L normalised and then
    rounded gives exactly L * bf16(1/L) (1.0009765625 at L = 1025), where an
    online softmax, rounding before it knows l, would give 1.  The plain
    version equals the block's dense path bit for bit (the Pallas kernel's
    bf16 output rounding would hide the gap)."""
    rng = np.random.default_rng(L)
    q = np.zeros((1, 2, L, 64), np.float32)
    k = rng.normal(size=(1, 2, L, 64)).astype(np.float32)
    v = np.ones((1, 2, L, 64), np.float32)
    got = _plain((q, k, v), "bfloat16").numpy()
    want = L * float(torch.tensor(1.0 / L).to(torch.bfloat16))
    assert got.min() == got.max() == np.float32(want)
    assert np.array_equal(got, _dense((q, k, v), "bfloat16"))


def test_cpu_entry_takes_the_plain_version():
    """flash_self_attention on CPU tensors is the plain version, launches
    nothing, and the kernel wrapper refuses CPU tensors."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(9, seed=2, B=2))
    fa.reset_launches()
    assert torch.equal(fa.flash_self_attention(q, k, v), fa.flash_self_attention_reference(q, k, v))
    assert sum(fa.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attn_fwd(q, k, v)


# ---- the bf16 path plan (csrc/flash_attn_fwd.cu: streamed for every L;
# the resident kernel only when forced) ----

@pytest.mark.parametrize("L", [785, 197, 1025, 1, 37, fa.RESIDENT_CAPACITY,
                               fa.RESIDENT_CAPACITY + 1])
def test_flash_plan_path(L):
    """Every bf16 length takes the streamed path, L alone deciding: it beat
    the resident one at CONCH's 448 px (785) and ViT-B/16's 224 px (197) on
    the card, and it alone takes CONCH at 512 px (1025)."""
    assert fa.flash_plan(L) == ("streamed", 0, fa.STREAMED_SMEM)


@pytest.mark.parametrize("L", [1, 16, 17, 64, 65, 128, 129, 197, 256, 257, 448, 449, 640, 641,
                               785, 800, 801, 1025, 4096])
def test_flash_plan_fits_the_block(L):
    """The streamed plan's shared memory fits an H100 block four times over
    (four blocks an SM); the resident plan, which `_force_path` takes, is
    the smallest template instance (chunks of 16 keys per warp,
    RESIDENT_WARPS warps a stripe) that covers L up to the capacity, fits a
    block, and has no instance above it."""
    path, chunks, smem = fa.flash_plan(L)
    assert path == "streamed" and chunks == 0 and 4 * (smem + 1024) <= 233472
    path, chunks, smem = fa.resident_plan(L)
    w = fa.RESIDENT_WARPS
    assert path == "resident"
    assert smem == -(-L // 16) * 16 * 256 + 4 * (2 * (w - 1) * 16 * 64 + 2 * 2 * w * 16)
    if L > fa.RESIDENT_CAPACITY:
        assert chunks == 0
        return
    keys_per_chunk = 16 * w
    assert smem <= fa.SMEM_PER_BLOCK and chunks in fa.RESIDENT_CHUNKS
    assert keys_per_chunk * chunks >= L
    assert all(keys_per_chunk * c < L for c in fa.RESIDENT_CHUNKS if c < chunks)


def test_flash_plan_mirrors_the_kernel_source():
    """The Python plans' constants are the kernel's: the streamed kernel's
    rows a block, keys and stages of its ring and its shared memory (the
    comment's sum), and the resident kernel's warps per stripe, template
    instances, capacity and shared memory at capacity (the header note's
    sum)."""
    import re
    from pathlib import Path
    src = (Path(fa.__file__).parent / "csrc" / "flash_attn_fwd.cu").read_text()
    assert re.search(rf"kStrRows = {fa.STREAMED_ROWS};", src)
    assert re.search(rf"kStrTileK = {fa.STREAMED_TILE_K};", src)
    assert re.search(rf"kStrStages = {fa.STREAMED_STAGES};", src)
    assert f"alignment: {fa.STREAMED_SMEM:,}" in src
    chunks = re.search(r"kResChunks\[\] = \{([0-9, ]+)\}", src).group(1)
    assert tuple(int(c) for c in chunks.split(",")) == fa.RESIDENT_CHUNKS
    assert re.search(rf"kResCapacity = {fa.RESIDENT_CAPACITY};", src)
    assert re.search(rf"kResW = {fa.RESIDENT_WARPS};", src)
    smem = fa.resident_plan(fa.RESIDENT_CAPACITY)[2]
    assert f"= {smem:,} of the 232,448 B" in src
    for plan in (fa.flash_plan, fa.resident_plan):
        with pytest.raises(ValueError):
            plan(0)


@pytest.mark.parametrize("name", ["stages4", "lead1", "no_exp1", "no_exp2", "no_pv"])
def test_flash_variants_edit_the_kernel_source(name):
    """Each variant of ops/flash_variants.py is an edit that applies once to
    the kernel source as it stands."""
    from pathlib import Path
    from vlsa_tpu_torch.ops import flash_variants as fv
    src = (Path(fa.__file__).parent / "csrc" / "flash_attn_fwd.cu").read_text()
    assert fv.VARIANTS[name]
    for old, new in fv.VARIANTS[name]:
        assert src.count(old) == 1 and old != new


def test_reset_launches_clears_the_path_counts():
    fa.LAUNCHES_PATH["resident"] += 3
    fa.reset_launches()
    assert fa.LAUNCHES_PATH == {"resident": 0, "streamed": 0} and sum(fa.LAUNCHES.values()) == 0
