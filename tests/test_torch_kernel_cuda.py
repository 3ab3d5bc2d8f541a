"""The Hopper co-attention kernels (forward and dQ backward) against their
plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip without
one.  They import nothing of JAX, so on the machine with the card they run
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""
import pytest
import torch

from vlsa_tpu_torch.ops import coattn as co

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.int8: 1e-3}
# dq tolerances of scripts/validate_kernels_chip.py:87-95 (max|a-b| / max|b|)
TOL_DQ = {torch.float32: 1e-3, torch.bfloat16: 2e-3, torch.int8: 2e-3}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, N, C, P, dtype, host_inv, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(P, C, generator=g), dim=-1)
    x = torch.randn(B, N, C, generator=g)
    mask = torch.rand(B, N, generator=g) > 0.2
    mask[-1] = False
    x = x * mask[..., None]
    x_scale = x_inv = None
    if dtype == torch.int8:
        amax = x.abs().amax(-1) / 127.0
        x = torch.round(x / torch.where(amax > 0, amax, 1.0)[..., None]).to(torch.int8)
        x_scale = amax
    else:
        x = x.to(dtype)
    if host_inv:
        sq = (x.float() ** 2).sum(-1)
        x_inv = torch.where(sq > 0, sq.rsqrt(), torch.zeros_like(sq))
    to = (lambda t: None if t is None else t.to(device).contiguous())
    return to(q), to(x), to(mask), to(x_scale), to(x_inv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("host_inv", [False, True])
@pytest.mark.parametrize("shape", [(3, 1000, 512, 12), (2, 33, 64, 16), (1, 5, 8, 1)])
def test_kernel_matches_plain(device, dtype, host_inv, shape):
    q, x, mask, xs, xi = _inputs(*shape, dtype, host_inv, device)
    before = co.LAUNCHES[co.variant_name(dtype, host_inv)]
    out, m, l = co.coattn_fwd(q, x, mask, 30.0, xs, xi)
    torch.cuda.synchronize()
    assert co.LAUNCHES[co.variant_name(dtype, host_inv)] == before + 1
    ref = co.coattn_pool_reference(q, x, mask, 30.0, xs)
    denom = ref.abs().max().clamp_min(1e-30)
    assert float((out - ref).abs().max() / denom) <= TOL[dtype]
    assert torch.all(out[-1] == 0) and torch.isfinite(m).all() and torch.isfinite(l).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("host_inv", [False, True])
@pytest.mark.parametrize("shape", [(3, 1000, 512, 12), (2, 33, 64, 16), (1, 5, 8, 1)])
def test_dq_kernel_matches_plain(device, dtype, host_inv, shape):
    q, x, mask, xs, xi = _inputs(*shape, dtype, host_inv, device, seed=1)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0, xs, xi)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(device)
    before = co.LAUNCHES_BWD[co.variant_name(dtype, host_inv)]
    dq = co.coattn_bwd_dq(q, x, mask, 30.0, g, out, m, l, xs, xi)
    torch.cuda.synchronize()
    assert co.LAUNCHES_BWD[co.variant_name(dtype, host_inv)] == before + 1
    ref = co.coattn_bwd_dq_reference(q, x, mask, 30.0, g, out, m, l, xs, xi)
    assert torch.isfinite(dq).all()
    assert float((dq - ref).abs().max() / ref.abs().max().clamp_min(1e-30)) <= TOL_DQ[dtype]


def test_gradient_request_raises(device):
    """q's gradient goes through the dQ kernel; a gradient for x raises."""
    q, x, mask, _s, _i = _inputs(2, 64, 64, 4, torch.float32, False, device)
    q.requires_grad_(True)
    fwd, bwd = co.LAUNCHES["f32"], co.LAUNCHES_BWD["f32"]
    co.coattn_pool(q, x, mask, 30.0).square().sum().backward()
    assert co.LAUNCHES["f32"] == fwd + 1 and co.LAUNCHES_BWD["f32"] == bwd + 1
    q_plain = q.detach().clone().requires_grad_(True)
    co.coattn_pool_reference(q_plain, x, mask, 30.0).square().sum().backward()
    assert float((q.grad - q_plain.grad).abs().max() / q_plain.grad.abs().max()) <= 1e-3
    with pytest.raises(NotImplementedError, match="_coattn_bwd_kernel"):
        co.coattn_pool(q, x.clone().requires_grad_(True), mask, 30.0)
    with torch.inference_mode():
        assert co.coattn_pool(q, x, mask, 30.0).shape == (2, 4, 64)
