"""The port's plain flash self-attention against vlsa_tpu's
`_flash_self_attention` (JAX's library Pallas TPU flash kernel, run in
interpret mode on the CPU) and against the dense attention of its
TimmViTBlock, at L = 1, 37 and 785 (the extraction length), hd = 64.

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
@pytest.mark.parametrize("L", [1, 37, 785])
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
@pytest.mark.parametrize("L", [1, 37, 785])
def test_plain_matches_dense_block_attention(L, dtype):
    arrays = _inputs(L, seed=1, B=2)
    got = _plain(arrays, dtype).numpy()
    assert _rel(got, _dense(arrays, dtype)) <= (1e-5 if dtype == "float32" else 2e-3)


def test_cpu_entry_takes_the_plain_version():
    """flash_self_attention on CPU tensors is the plain version, launches
    nothing, and the kernel wrapper refuses CPU tensors."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(9, seed=2, B=2))
    fa.reset_launches()
    assert torch.equal(fa.flash_self_attention(q, k, v), fa.flash_self_attention_reference(q, k, v))
    assert sum(fa.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attn_fwd(q, k, v)


# ---- the bf16 path plan (csrc/flash_attn_fwd.cu: resident or streamed) ----

@pytest.mark.parametrize("L, path", [(785, "resident"), (197, "resident"), (1025, "streamed"),
                                     (1, "resident"), (37, "resident"),
                                     (fa.RESIDENT_CAPACITY, "resident"),
                                     (fa.RESIDENT_CAPACITY + 1, "streamed")])
def test_flash_plan_path(L, path):
    """CONCH at 448 px (785) and ViT-B/16 at 224 px (197) run resident, CONCH
    at 512 px (1025) streamed; the capacity itself is resident."""
    assert fa.flash_plan(L)[0] == path


@pytest.mark.parametrize("L", [1, 16, 17, 64, 65, 128, 129, 197, 256, 257, 448, 449, 640, 641,
                               785, 800, 801, 1025, 4096])
def test_flash_plan_fits_the_block(L):
    """The resident plan's chunks (of 16 keys, per warp, RESIDENT_WARPS
    warps a stripe) are a template instance and cover L, its shared memory
    fits an H100 block, and it is the smallest instance that covers L."""
    path, chunks, smem = fa.flash_plan(L)
    assert smem <= fa.SMEM_PER_BLOCK
    if path == "streamed":
        assert L > fa.RESIDENT_CAPACITY and chunks == 0
        return
    keys_per_chunk = 16 * fa.RESIDENT_WARPS
    assert L <= fa.RESIDENT_CAPACITY and chunks in fa.RESIDENT_CHUNKS
    assert keys_per_chunk * chunks >= L
    assert all(keys_per_chunk * c < L for c in fa.RESIDENT_CHUNKS if c < chunks)
    w = fa.RESIDENT_WARPS
    assert smem == -(-L // 16) * 16 * 256 + 4 * (2 * (w - 1) * 16 * 64 + 2 * 2 * w * 16)


def test_flash_plan_mirrors_the_kernel_source():
    """The Python plan's constants are the kernel's: the warps per stripe,
    the template instances, the capacity and the shared memory at capacity
    (the header note's sum)."""
    import re
    from pathlib import Path
    src = (Path(fa.__file__).parent / "csrc" / "flash_attn_fwd.cu").read_text()
    chunks = re.search(r"kResChunks\[\] = \{([0-9, ]+)\}", src).group(1)
    assert tuple(int(c) for c in chunks.split(",")) == fa.RESIDENT_CHUNKS
    assert re.search(rf"kResCapacity = {fa.RESIDENT_CAPACITY};", src)
    assert re.search(rf"kResW = {fa.RESIDENT_WARPS};", src)
    smem = fa.flash_plan(fa.RESIDENT_CAPACITY)[2]
    assert f"= {smem:,} of the 232,448 B" in src
    with pytest.raises(ValueError):
        fa.flash_plan(0)


def test_reset_launches_clears_the_path_counts():
    fa.LAUNCHES_PATH["resident"] += 3
    fa.reset_launches()
    assert fa.LAUNCHES_PATH == {"resident": 0, "streamed": 0} and sum(fa.LAUNCHES.values()) == 0
