"""The Hopper kernels -- co-attention forward, dQ and full (dX) backward,
ABMIL forward and backward, flash self-attention -- against their plain
versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip without
one.  They import nothing of JAX, so on the machine with the card they run
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""
import pytest
import torch

from vlsa_tpu_torch.ops import abmil as ab
from vlsa_tpu_torch.ops import coattn as co
from vlsa_tpu_torch.ops import flash_attn as fa
from vlsa_tpu_torch.ops import flags

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


# the forward's pipeline (csrc/coattn_fwd.cu): (B, N, C, P, masked stretch)
# -- a bag over many blocks' ranges with an all-masked stretch of several
# blocks, N below one tile, B=64 at small N, a block range that wraps every
# storage's ring of stages, P = 1 and 16, C = 8, 64 and 200 (fewer warps than
# 8, the last one partly past C; int8 rows only 8-byte aligned), and the
# wide instance at C = 1024 (VLFAN's default width) and 1000 (its last
# channel group partly past C)
FWD_PIPELINE = [(2, 5000, 512, 12, (1000, 3000)), (3, 17, 512, 12, None),
                (64, 40, 512, 16, None), (1, 132 * 32 * 10 + 7, 512, 1, None),
                (3, 700, 8, 16, (0, 300)), (2, 1000, 64, 5, None), (2, 1000, 200, 12, None),
                (2, 5000, 1024, 12, (1000, 3000)), (3, 300, 1000, 16, None)]
# the f32 forward against true f32: split TF32 (~2^-21 a product) stays
# within 2e-6, which bf16 hi + lo operands (~2^-16; 5.2e-6 on the card) fail
TOL_F32_FWD = 2e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("host_inv", [False, True])
@pytest.mark.parametrize("case", FWD_PIPELINE)
def test_fwd_kernel_pipeline_shapes(device, dtype, host_inv, case):
    """out within TOL of the plain version (f32 within TOL_F32_FWD), and the
    stats the dQ and dX kernels consume: l within 1e-3 relative, m within
    1e-3 (the kernel's logits take q as hi + lo), an empty bag m = -1e30,
    l = 1e-30; C > 512 runs the wide instance."""
    B, N, C, P, stretch = case
    q, x, mask, xs, xi = _inputs(B, N, C, P, dtype, host_inv, device, seed=4)
    if stretch is not None:
        mask[0, stretch[0]:stretch[1]] = False
    plan = co.fwd_plan(dtype, B, N, torch.cuda.get_device_properties(device).multi_processor_count,
                       C)
    paths = dict(co.LAUNCHES_FWD_PATH)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0, xs, xi)
    torch.cuda.synchronize()
    path = "wide" if C > 512 else "group"
    assert co.LAUNCHES_FWD_PATH == dict(paths, **{path: paths[path] + 1})
    ref, m_ref, l_ref = co.coattn_fwd_reference(q, x, mask, 30.0, xs, xi)
    rel = float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    assert rel <= (TOL_F32_FWD if dtype == torch.float32 else TOL[dtype])
    assert torch.all(out[-1] == 0) and torch.all(m[-1] == -1e30) and torch.all(l[-1] == 1e-30)
    torch.testing.assert_close(l, l_ref, rtol=1e-3, atol=0)
    assert float((m - m_ref).abs().max()) <= 1e-3
    if N > 1000:
        assert plan["Smax"] > 1  # bag 0 spans several blocks' ranges


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


def _abmil_inputs(B, N, dtype, device, seed=0, masked_value=None, D=ab.D_KERNEL,
                  H=ab.HID_KERNEL):
    """ABMIL inputs at D, hid=H (the resident instances' 512, 256 unless
    given): 20% of patches masked, the last bag empty and, with B >= 3, the
    first holding a single valid patch; int8 quantized per patch.  Masked
    rows are zero, or hold `masked_value` (as a projecter's output holds
    features there)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, N, D, generator=g)
    mask = torch.rand(B, N, generator=g) > 0.2
    mask[-1] = False
    if B >= 3:
        mask[0] = False
        mask[0, N // 2] = True
    x = x * mask[..., None] if masked_value is None else torch.where(mask[..., None], x,
                                                                      masked_value)
    x_scale = None
    if dtype == torch.int8:
        amax = x.abs().amax(-1) / 127.0
        x = torch.round(x / torch.where(amax > 0, amax, 1.0)[..., None]).to(torch.int8)
        x_scale = amax
    else:
        x = x.to(dtype)
    w1 = torch.randn(H, D, generator=g) / D ** 0.5
    b1 = torch.randn(H, generator=g) * 0.1
    w2 = torch.randn(H, generator=g) / H ** 0.5
    gout = torch.randn(B, D, generator=g)
    to = (lambda t: None if t is None else t.to(device).contiguous())
    return to(x), to(x_scale), to(mask), to(w1), to(b1), to(w2), to(gout)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


# tolerances of chip_smoke.py phase 2c (max|a-b| / max|b|)
TOL_ABMIL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.int8: 1e-3}
TOL_ABMIL_DW = {torch.float32: 1e-3, torch.bfloat16: 2e-3, torch.int8: 2e-3}
TOL_ABMIL_DX = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", [(3, 1000), (2, 33), (1, 5), (3, 63), (3, 64), (3, 65),
                                   (3, 127), (3, 128), (3, 129), (3, 3 * 4097)])
def test_abmil_kernels_match_plain(device, dtype, shape):
    """Forward and backward (weights only, and with dX for f32/bf16) at a
    ragged N that is no multiple of the tile, at N = tile - 1, tile, tile + 1
    (64: the f32 forward's and every backward's pass 1; 128: the bf16 and
    int8 forward's) and at an N of several chunks with a ragged last one,
    with an empty bag and a bag of one valid patch."""
    x, xs, mask, w1, b1, w2, g = _abmil_inputs(*shape, dtype, device)
    v = ab._STORAGE_NAME[dtype]
    before = ab.LAUNCHES[v]
    if dtype == torch.int8:
        out, m, l = ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)
    else:
        out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
    torch.cuda.synchronize()
    assert ab.LAUNCHES[v] == before + 1
    ref, m_ref, l_ref = ab.abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=xs)
    assert _rel(out, ref) <= TOL_ABMIL[dtype]
    assert torch.all(out[-1] == 0) and float(m[-1]) == float(m_ref[-1])
    torch.testing.assert_close(l, l_ref, rtol=1e-3, atol=0)

    for need_dx in ((False,) if dtype == torch.int8 else (False, True)):
        key = ab.bwd_variant(dtype, need_dx)
        before = ab.LAUNCHES_BWD[key]
        if dtype == torch.int8:
            dx, (dw1, db1, dw2) = None, ab.abmil_q8_bwd(x, xs, mask, w1, b1, w2, g, out, m, l)
        else:
            dx, dw1, db1, dw2 = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
        torch.cuda.synchronize()
        assert ab.LAUNCHES_BWD[key] == before + 1
        rdx, rdw1, rdb1, rdw2 = ab.abmil_bwd_reference(x, mask, w1, b1, w2, g, out, m, l,
                                                       x_scale=xs, need_dx=need_dx)
        for got, want in ((dw1, rdw1), (db1, rdb1), (dw2, rdw2)):
            assert torch.isfinite(got).all() and _rel(got, want) <= TOL_ABMIL_DW[dtype]
        if need_dx:
            assert dx.dtype == dtype and _rel(dx, rdx) <= TOL_ABMIL_DX[dtype]
            assert torch.all(dx[-1] == 0)
        else:
            assert dx is None


# widths of the general instances: the feature widths users run (ViT-S 384,
# CTransPath 768, UNI 1024, Prov-GigaPath 1536) and the domain's corners
ABMIL_WIDTHS = [(1024, 256), (768, 128), (1536, 512), (384, 64), (64, 64), (192, 512),
                (2048, 128), (512, 128), (1024, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("widths", ABMIL_WIDTHS)
@pytest.mark.parametrize("shape", [(3, 129), (2, 33)])
def test_abmil_general_widths_match_plain(device, dtype, widths, shape):
    """Every storage's forward and backward (weights only; with dX for f32
    and bf16) at (D, hid) the resident instances do not take, on the general
    instances (`LAUNCHES_ROUTE`), against the plain versions with the
    tolerances of the D=512, hid=256 test; ragged N, an empty bag and a bag
    of one patch."""
    D, H = widths
    x, xs, mask, w1, b1, w2, g = _abmil_inputs(*shape, dtype, device, seed=11, D=D, H=H)
    routes = dict(ab.LAUNCHES_ROUTE)
    out, m, l = (ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2) if dtype == torch.int8
                 else ab.abmil_fwd(x, mask, w1, b1, w2))
    torch.cuda.synchronize()
    assert ab.LAUNCHES_ROUTE == dict(routes, general=routes["general"] + 1)
    ref, m_ref, l_ref = ab.abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=xs)
    assert out.shape == (shape[0], D) and _rel(out, ref) <= TOL_ABMIL[dtype]
    assert torch.all(out[-1] == 0) and float(m[-1]) == float(m_ref[-1])
    torch.testing.assert_close(l, l_ref, rtol=1e-3, atol=0)
    for need_dx in ((False,) if dtype == torch.int8 else (False, True)):
        if dtype == torch.int8:
            dx, (dw1, db1, dw2) = None, ab.abmil_q8_bwd(x, xs, mask, w1, b1, w2, g, out, m, l)
        else:
            dx, dw1, db1, dw2 = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
        torch.cuda.synchronize()
        rdx, rdw1, rdb1, rdw2 = ab.abmil_bwd_reference(x, mask, w1, b1, w2, g, out, m, l,
                                                       x_scale=xs, need_dx=need_dx)
        assert dw1.shape == (H, D) and db1.shape == dw2.shape == (H,)
        for got, want in ((dw1, rdw1), (db1, rdb1), (dw2, rdw2)):
            assert torch.isfinite(got).all() and _rel(got, want) <= TOL_ABMIL_DW[dtype]
        if need_dx:
            assert dx.dtype == dtype and _rel(dx, rdx) <= TOL_ABMIL_DX[dtype]
            assert torch.all(dx[-1] == 0)


@pytest.mark.parametrize("widths", [(1024, 256), (768, 128), (1536, 512)])
def test_abmil_general_int8_fwd_matches_its_rounding_model(device, widths):
    """The general int8 forward splits W1 as the resident one does: within
    2e-5 of `abmil_fwd_rounded` (out; l relatively; m absolutely)."""
    D, H = widths
    x, xs, mask, w1, b1, w2, _g = _abmil_inputs(3, 3 * 4097, torch.int8, device, seed=7, D=D,
                                                H=H)
    out, m, l = ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)
    torch.cuda.synchronize()
    ref, m_ref, l_ref = ab.abmil_fwd_rounded(x, mask, w1, b1, w2, x_scale=xs)
    assert _rel(out, ref) <= 2e-5
    live = mask.any(-1)
    assert float((m - m_ref)[live].abs().max()) <= 2e-5
    torch.testing.assert_close(l, l_ref, rtol=2e-5, atol=0)


@pytest.mark.parametrize("widths", [(512, 256), (1024, 256), (768, 128)])
def test_abmil_precise_mode_matches_its_model(device, monkeypatch, widths):
    """bf16 in vlsa_tpu's precise mode (W1 and dz as bf16 hi + lo) runs the
    general instances at every width (`LAUNCHES_ROUTE["precise"]`): against
    the plain f32 version (x's bf16 values, W1 unrounded) within the bf16
    limits; the forward's out and l within 2e-5 of its plain model
    (`abmil_fwd_rounded`, precise=True), the limit of the int8 forward's
    model; the backward against the exact model of its rounding
    (`abmil_bwd_rounded`, exact=True) by `bwd_model_gaps`, chip_smoke.py's
    limits: dX beyond its rounding to bf16, db1 and dw2 over their sums'
    scale within 2e-5, dW1 within 5e-5 of max|dW1| (the kernel's f32 sums
    over every patch on the tensor cores, up to 3.0e-5 from the exact sums
    over 81,920 patches on an H100); the single-rounded model misses the dW1
    and dX limits."""
    monkeypatch.setattr(ab, "_PRECISE", True)
    D, H = widths
    x, _s, mask, w1, b1, w2, g = _abmil_inputs(3, 3 * 4097, torch.bfloat16, device, seed=9,
                                               D=D, H=H)
    routes = dict(ab.LAUNCHES_ROUTE)
    out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
    dx, dw1, db1, dw2 = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=True)
    torch.cuda.synchronize()
    assert ab.LAUNCHES_ROUTE == dict(routes, precise=routes["precise"] + 1)
    xf = x.float()
    ref, _m, l_ref = ab.abmil_fwd_reference(xf, mask, w1, b1, w2)
    assert _rel(out, ref) <= TOL_ABMIL[torch.bfloat16]
    model, m_mod, l_mod = ab.abmil_fwd_rounded(x, mask, w1, b1, w2, precise=True)
    assert _rel(out, model) <= 2e-5 and _rel(l, l_mod) <= 2e-5
    want = ab.abmil_bwd_reference(xf, mask, w1, b1, w2, g, out, m, l)
    for got, w in zip((dw1, db1, dw2), want[1:]):
        assert _rel(got, w) <= TOL_ABMIL_DW[torch.bfloat16]
    args = (x, mask, w1, b1, w2, g, out, m, l)
    exact = ab.abmil_bwd_rounded(*args, precise=True, exact=True)
    scales = ab.abmil_bwd_sum_scales(*args, precise=True)
    tols = {"dX": 2e-5, "dW1": 5e-5, "db1": 2e-5, "dw2": 2e-5}
    gaps = ab.bwd_model_gaps((dx, dw1, db1, dw2), exact, scales)
    assert all(gaps[k] <= tols[k] for k in tols), gaps
    single = ab.abmil_bwd_rounded(*args, precise=False, exact=True)
    single = ab.bwd_model_gaps((single[0].to(torch.bfloat16),) + single[1:], exact, scales)
    assert single["dW1"] > tols["dW1"] and single["dX"] > tols["dX"], single
    assert dx.dtype == torch.bfloat16
    assert _rel(dx, want[0]) <= TOL_ABMIL_DX[torch.bfloat16] and torch.all(dx[-1] == 0)


# every width the kernels take: Virchow's 2560 with the shipped 256 and
# CLAM's 512, 4096 at 256 and the largest common bottleneck 1024, widths that
# pad hid (96, 384, 32, 7) and D (1000, 100, 33, 1), rows that are not
# 16-byte aligned (bf16 at 100 and 33, int8 at 1000, 100, 33; f32 at 33 and
# 1), the domain's corners, and 64-32, the small SA run of the resume fixtures
ABMIL_ANY_WIDTHS = [(2560, 256), (2560, 512), (4096, 256), (4096, 1024), (1000, 384), (768, 96),
                    (100, 32), (1536, 1024), (33, 7), (1, 1), (8192, 64), (1001, 1024),
                    (64, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("widths", ABMIL_ANY_WIDTHS)
@pytest.mark.parametrize("shape", [(3, 129), (2, 70)])
def test_abmil_any_width_matches_plain(device, dtype, widths, shape):
    """Every storage's forward and backward (weights only; with dX for f32
    and bf16) at any D and hid -- W1 padded to whole passes and slices, x's
    rows not 16-byte aligned -- on the general instances, against the plain
    versions with the limits of the D=512, hid=256 test; ragged N, an empty
    bag and a bag of one patch."""
    test_abmil_general_widths_match_plain(device, dtype, widths, shape)


@pytest.mark.parametrize("widths", [(2560, 256), (1000, 384), (100, 32), (33, 7)])
def test_abmil_any_width_int8_fwd_matches_its_rounding_model(device, widths):
    """The int8 forward at widths that pad W1 splits it as the TPU does (the
    padded entries split to 0 and leave s_w alone): within 2e-5 of
    `abmil_fwd_rounded`."""
    test_abmil_general_int8_fwd_matches_its_rounding_model(device, widths)


@pytest.mark.parametrize("widths", [(2560, 256), (1000, 384), (33, 7)])
def test_abmil_any_width_precise_mode_matches_its_model(device, monkeypatch, widths):
    """Precise bf16 at widths that pad, held as at the widths above."""
    test_abmil_precise_mode_matches_its_model(device, monkeypatch, widths)


@pytest.mark.parametrize("widths", [(0, 256), (8193, 256), (512, 0), (512, 1025), (9000, 2000)])
def test_abmil_refuses_widths_outside_the_domain(device, widths):
    """A width the kernels do not take raises a ValueError that names the
    domain and the shared memory that runs out past it; nothing launches and
    nothing falls back to the plain version."""
    D, H = widths
    x = torch.zeros(2, 70, D, device=device)
    mask = torch.ones(2, 70, dtype=torch.bool, device=device)
    w1, b1, w2 = (torch.zeros(H, D, device=device), torch.zeros(H, device=device),
                  torch.zeros(H, device=device))
    before = dict(ab.LAUNCHES)
    with pytest.raises(ValueError, match="D in \\[1, 8192\\] and hid in \\[1, 1024\\]"):
        ab.abmil_fwd(x, mask, w1, b1, w2)
    with pytest.raises(ValueError, match="shared memory"):
        ab.abmil_pool(x, mask, w1, b1, w2)
    assert ab.LAUNCHES == before


@pytest.mark.parametrize("shape", [(3, 129), (3, 3 * 4097), (8, 10240)])
def test_abmil_int8_fwd_matches_its_rounding_model(device, shape):
    """The int8 forward kernel against `abmil_fwd_rounded`, the plain model of
    its W1 split (int8 hi + lo, exact int32 products): out within 2e-5
    (max|a-b| / max|b|), m within 2e-5 absolutely and l within 2e-5
    relatively -- what is left is f32 summation order and the rounding of
    s_w (254 P_hi + P_lo) / 254 -- where the unsplit f32 plain version is
    held at 1e-3.  The plan's chunks at
    (3, 12291) and (8, 10240) span several tiles, the first ragged."""
    B, N = shape
    plan = ab.fwd_plan(torch.int8, B, N, torch.cuda.get_device_properties(device)
                       .multi_processor_count)
    assert N % ab._FWD_TILE[torch.int8] != 0 or plan["chunk"] > ab._FWD_TILE[torch.int8]
    x, xs, mask, w1, b1, w2, _g = _abmil_inputs(B, N, torch.int8, device, seed=7)
    out, m, l = ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)
    torch.cuda.synchronize()
    ref, m_ref, l_ref = ab.abmil_fwd_rounded(x, mask, w1, b1, w2, x_scale=xs)
    assert _rel(out, ref) <= 2e-5
    live = mask.any(-1)
    assert float((m - m_ref)[live].abs().max()) <= 2e-5
    torch.testing.assert_close(l, l_ref, rtol=2e-5, atol=0)
    empty = torch.tensor([-1e30, 1e-30], device=device)  # the f32 stats of an empty bag
    assert torch.all(out[-1] == 0) and m[-1] == empty[0] and l[-1] == empty[1]


def test_abmil_f32_masked_rows_add_nothing(device):
    """f32 with masked rows holding large features: dz is 0 there, so they
    add nothing to dW1 (against the plain version, same tolerance); dX is
    exactly 0 on every masked row and on the empty bag."""
    N = 3 * 4097
    plan = ab.bwd_plan(torch.float32, 3, N, torch.cuda.get_device_properties(device)
                       .multi_processor_count)
    assert plan["S1"] > 1 and N % plan["chunk1"] != 0
    x, _s, mask, w1, b1, w2, g = _abmil_inputs(3, N, torch.float32, device, seed=3,
                                               masked_value=1e4)
    out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
    ref = ab.abmil_fwd_reference(x, mask, w1, b1, w2)[0]
    assert _rel(out, ref) <= TOL_ABMIL[torch.float32] and torch.all(out[-1] == 0)
    dx, dw1, db1, dw2 = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=True)
    torch.cuda.synchronize()
    rdx, rdw1, rdb1, rdw2 = ab.abmil_bwd_reference(x, mask, w1, b1, w2, g, out, m, l)
    for got, want in ((dw1, rdw1), (db1, rdb1), (dw2, rdw2)):
        assert torch.isfinite(got).all() and _rel(got, want) <= TOL_ABMIL_DW[torch.float32]
    assert _rel(dx, rdx) <= TOL_ABMIL_DX[torch.float32]
    assert torch.all(dx[~mask] == 0) and torch.all(dx[-1] == 0)


@pytest.mark.parametrize("dtype, need_dx", [(torch.bfloat16, False), (torch.bfloat16, True),
                                           (torch.int8, False)])
def test_abmil_pass2_chunks_cross_bags(device, dtype, need_dx):
    """The bf16-operand backward's weight-gradient pass runs over the B*N
    rows in chunks that start inside bags: several chunks, a masked stretch,
    an empty bag (int8: s dz as bf16 hi + lo against the plain version's
    f32); dX is exactly 0 on masked rows and the empty bag."""
    B, N = 4, 5000
    plan = ab.bwd_plan(dtype, B, N, torch.cuda.get_device_properties(device).multi_processor_count)
    assert plan["S2"] > 1 and plan["chunk2"] % N != 0 and plan["S1"] > 1
    x, xs, mask, w1, b1, w2, g = _abmil_inputs(B, N, dtype, device, seed=5)
    mask[1, 700:3100] = False
    x[1, 700:3100] = 0
    if dtype == torch.int8:
        out, m, l = ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)
        dx, (dw1, db1, dw2) = None, ab.abmil_q8_bwd(x, xs, mask, w1, b1, w2, g, out, m, l)
    else:
        out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
        dx, dw1, db1, dw2 = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
    torch.cuda.synchronize()
    rdx, rdw1, rdb1, rdw2 = ab.abmil_bwd_reference(x, mask, w1, b1, w2, g, out, m, l,
                                                   x_scale=xs, need_dx=need_dx)
    for got, want in ((dw1, rdw1), (db1, rdb1), (dw2, rdw2)):
        assert torch.isfinite(got).all() and _rel(got, want) <= TOL_ABMIL_DW[dtype]
    if need_dx:
        assert _rel(dx, rdx) <= TOL_ABMIL_DX[dtype]
        assert torch.all(dx[~mask] == 0) and torch.all(dx[-1] == 0)
    else:
        assert dx is None


def test_abmil_pool_routes_through_the_kernels(device):
    """abmil_pool on CUDA: the forward kernel without a gradient, the
    backward kernel for the weights, with dX when x needs a gradient; the
    gradients match autograd through the plain version; fc2's bias is not
    an input."""
    x, _s, mask, w1, b1, w2, g = _abmil_inputs(2, 300, torch.float32, device)
    ab.reset_launches()
    with torch.no_grad():
        ab.abmil_pool(x, mask, w1, b1, w2, 0.5)
    assert ab.LAUNCHES["f32"] == 1 and sum(ab.LAUNCHES_BWD.values()) == 0
    grads = []
    for pool in (ab.abmil_pool, lambda *a, **k: ab.abmil_fwd_reference(*a[:5])[0]):
        xp = x.clone().requires_grad_(True)
        ps = [t.clone().requires_grad_(True) for t in (w1, b1, w2)]
        (pool(xp, mask, *ps, 0.5) * g).sum().backward()
        grads.append([xp.grad] + [p.grad for p in ps])
    assert ab.LAUNCHES_BWD["f32_dx"] == 1
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-3


# the full backward (row 5): chip_smoke.py phase 2e's tolerances, max|a-b| /
# max|b| for dq and f32 dX; bf16 dX within one bf16 ulp at the scale of its
# largest element (both sides round a, g and dl to bf16 at the same places)
TOL_DX_DQ = {torch.float32: 1e-3, torch.bfloat16: 2e-3}


def _bf16_ulp_of_max(t) -> float:
    return float(2.0 ** (torch.floor(torch.log2(t.float().abs().max())) - 7))


def _dx_inputs(B, N, C, P, dtype, device, seed=0):
    """Queries, features, mask and cotangent; 20% of patches and the last
    bag masked, the masked rows holding features (as a projecter's output
    does)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(P, C, generator=g), dim=-1)
    x = torch.randn(B, N, C, generator=g).to(dtype)
    mask = torch.rand(B, N, generator=g) > 0.2
    mask[-1] = False
    gout = torch.randn(B, P, C, generator=g)
    return [t.to(device).contiguous() for t in (q, x, mask, gout)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 1000, 512, 12), (2, 33, 64, 16), (1, 5, 8, 1),
                                   (4, 777, 256, 16), (2, 64, 512, 1)])
def test_dx_kernel_matches_plain(device, dtype, shape):
    """Ragged N (no multiple of the 32-patch tile), an empty bag, P = 1, 12
    and 16; every row of dX is written, zeros where masked."""
    q, x, mask, gout = _dx_inputs(*shape, dtype, device)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0)
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    before = co.LAUNCHES_DX[name]
    dq, dx = co.coattn_bwd_dx(q, x, mask, 30.0, gout, out, m, l)
    torch.cuda.synchronize()
    assert co.LAUNCHES_DX[name] == before + 1
    rdq, rdx = co.coattn_bwd_dx_reference(q, x, mask, 30.0, gout, out, m, l)
    assert dq.dtype == torch.float32 and torch.isfinite(dq).all()
    assert _rel(dq, rdq) <= TOL_DX_DQ[dtype]
    assert dx.dtype == dtype and dx.shape == x.shape and torch.isfinite(dx).all()
    if dtype == torch.float32:
        assert _rel(dx, rdx) <= 1e-3
    else:
        assert float((dx.float() - rdx.float()).abs().max()) <= _bf16_ulp_of_max(rdx)
    assert torch.all(dx[~mask] == 0) and torch.all(dx[-1] == 0)


# the backward kernels' pipeline (csrc/coattn_bwd.cuh): (B, N, C, P) -- a
# partial last tile with bag boundaries inside the blocks' ranges, the wide
# instance at C = 1024 (VLFAN's default width) and 1000 (its last channel
# group partly past C), P = 1 and 16
BWD_PIPELINE = [(5, 12291, 512, 12), (2, 3000, 1024, 12), (3, 2000, 1000, 16),
                (2, 5000, 512, 1), (2, 4000, 512, 16)]
# f32 against the plain version (true f32) at those shapes: split TF32 (~2^-21
# a product) stays within these, which bf16 hi + lo operands (~2^-16) fail
TOL_F32_BWD = {"dq": 2.5e-6, "dx": 4e-6}


def _crosses_bags(dtype, B, N, C, device) -> bool:
    plan = co.fwd_plan(dtype, B, N, torch.cuda.get_device_properties(device)
                       .multi_processor_count, C)
    return any(b * plan["tiles_per_bag"] % plan["L"] for b in range(1, B))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("host_inv", [False, True])
@pytest.mark.parametrize("case", BWD_PIPELINE)
def test_dq_kernel_pipeline_shapes(device, dtype, host_inv, case):
    """dq within TOL_DQ of the plain version (f32 within TOL_F32_BWD); the
    instance's path counter moves (wide above C=512); a second call gives
    the same bits (the partials are summed in block order)."""
    B, N, C, P = case
    q, x, mask, xs, xi = _inputs(B, N, C, P, dtype, host_inv, device, seed=6)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0, xs, xi)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(device)
    paths = dict(co.LAUNCHES_BWD_PATH)
    dq = co.coattn_bwd_dq(q, x, mask, 30.0, g, out, m, l, xs, xi)
    torch.cuda.synchronize()
    path = "wide" if C > 512 else "group"
    assert co.LAUNCHES_BWD_PATH == dict(paths, **{path: paths[path] + 1})
    ref = co.coattn_bwd_dq_reference(q, x, mask, 30.0, g, out, m, l, xs, xi)
    assert torch.isfinite(dq).all()
    assert _rel(dq, ref) <= (TOL_F32_BWD["dq"] if dtype == torch.float32 else TOL_DQ[dtype])
    assert torch.equal(co.coattn_bwd_dq(q, x, mask, 30.0, g, out, m, l, xs, xi), dq)
    if N > 10000:
        assert _crosses_bags(dtype, B, N, C, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_PIPELINE)
def test_dx_kernel_pipeline_shapes(device, dtype, case):
    """dq and dX against the plain version (f32 within TOL_F32_BWD, bf16 dX
    within one bf16 ulp of its largest element), masked rows holding
    features: dX exactly 0 there and on the empty bag; the path counter; a
    second call gives the same bits."""
    B, N, C, P = case
    q, x, mask, gout = _dx_inputs(B, N, C, P, dtype, device, seed=6)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0)
    paths = dict(co.LAUNCHES_BWD_PATH)
    dq, dx = co.coattn_bwd_dx(q, x, mask, 30.0, gout, out, m, l)
    torch.cuda.synchronize()
    path = "wide" if C > 512 else "group"
    assert co.LAUNCHES_BWD_PATH == dict(paths, **{path: paths[path] + 1})
    rdq, rdx = co.coattn_bwd_dx_reference(q, x, mask, 30.0, gout, out, m, l)
    assert torch.isfinite(dq).all() and torch.isfinite(dx).all()
    if dtype == torch.float32:
        assert _rel(dq, rdq) <= TOL_F32_BWD["dq"] and _rel(dx, rdx) <= TOL_F32_BWD["dx"]
    else:
        assert _rel(dq, rdq) <= TOL_DX_DQ[dtype]
        assert float((dx.float() - rdx.float()).abs().max()) <= _bf16_ulp_of_max(rdx)
    assert torch.all(dx[~mask] == 0) and torch.all(dx[-1] == 0)
    dq2, dx2 = co.coattn_bwd_dx(q, x, mask, 30.0, gout, out, m, l)
    assert torch.equal(dq2, dq) and torch.equal(dx2, dx)



# the kernels at more than 16 queries (ceil(P / 16) query groups of 16 rows,
# the last zero-padded): (B, N, C, P) -- every P of 17, 32, 33, 64, 128, 256
# at several widths, C = 8 (one warp, mostly past C), 200 (fewer warps, the
# last partly past C), 512 and the wide instance at 1024 and 1000, ragged N
# (no multiple of any tile) with bags crossing the blocks' ranges
QUERY_PIPELINE = [(2, 1000, 512, 17), (3, 777, 512, 32), (2, 3001, 512, 33),
                  (2, 1500, 512, 64), (2, 1000, 512, 128), (2, 700, 512, 256),
                  (3, 700, 8, 33), (2, 130, 8, 256), (2, 1000, 200, 17), (2, 501, 200, 128),
                  (2, 3000, 1024, 32), (2, 1003, 1024, 64), (2, 300, 1024, 256),
                  (3, 301, 1000, 33), (2, 257, 512, 128)]
# f32 above 16 queries is held against the exact function (the plain version
# in float64) at TOL_F32_FWD and TOL_F32_BWD: there the plain version in f32
# is itself 2e-6-3.7e-6 from exact on the H100 (its library products take
# another route for more than 16 rows), more than the kernels.  dq at C = 8
# keeps the general limits: with 8 channels |q . x^| reaches 1, and split
# TF32's error on each logit (~2^-21 of it) puts dq past TOL_F32_BWD at any
# P, P = 1 and 16 included.
EXACT = torch.float64


def _tight_f32_dq(dtype, C) -> bool:
    return dtype == torch.float32 and C > 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("host_inv", [False, True])
@pytest.mark.parametrize("case", QUERY_PIPELINE)
def test_fwd_kernel_many_queries(device, dtype, host_inv, case):
    """The forward with its query groups on the grid: out within TOL of the
    plain version (f32 within TOL_F32_FWD of the exact function), the stats
    as test_fwd_kernel_pipeline_shapes holds them, one "grid" launch."""
    B, N, C, P = case
    q, x, mask, xs, xi = _inputs(B, N, C, P, dtype, host_inv, device, seed=8)
    paths = dict(co.LAUNCHES_QUERY_PATH)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0, xs, xi)
    torch.cuda.synchronize()
    assert co.LAUNCHES_QUERY_PATH == dict(paths, grid=paths["grid"] + 1)
    ref, m_ref, l_ref = co.coattn_fwd_reference(q, x, mask, 30.0, xs, xi)
    assert out.shape == (B, P, C)
    if dtype == torch.float32:
        exact = co.coattn_fwd_reference(q, x, mask, 30.0, xs, xi, dtype=EXACT)[0]
        assert _rel(out, exact) <= TOL_F32_FWD
    else:
        assert _rel(out, ref) <= TOL[dtype]
    assert torch.all(out[-1] == 0) and torch.all(m[-1] == -1e30) and torch.all(l[-1] == 1e-30)
    torch.testing.assert_close(l, l_ref, rtol=1e-3, atol=0)
    assert float((m - m_ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("host_inv", [False, True])
@pytest.mark.parametrize("case", QUERY_PIPELINE)
def test_dq_kernel_many_queries(device, dtype, host_inv, case):
    """dQ with its query groups on the grid: within TOL_DQ of the plain
    version (f32 within TOL_F32_BWD of the exact function but at C = 8),
    one "grid" launch, the same bits on a second call."""
    B, N, C, P = case
    q, x, mask, xs, xi = _inputs(B, N, C, P, dtype, host_inv, device, seed=9)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0, xs, xi)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(10)).to(device)
    paths = dict(co.LAUNCHES_QUERY_PATH)
    dq = co.coattn_bwd_dq(q, x, mask, 30.0, g, out, m, l, xs, xi)
    torch.cuda.synchronize()
    assert co.LAUNCHES_QUERY_PATH == dict(paths, grid=paths["grid"] + 1)
    ref = co.coattn_bwd_dq_reference(q, x, mask, 30.0, g, out, m, l, xs, xi)
    assert dq.shape == (P, C) and torch.isfinite(dq).all()
    assert _rel(dq, ref) <= TOL_DQ[dtype]
    if _tight_f32_dq(dtype, C):
        exact = co.coattn_bwd_dq_reference(q, x, mask, 30.0, g, out, m, l, xs, xi, dtype=EXACT)
        assert _rel(dq, exact) <= TOL_F32_BWD["dq"]
    assert torch.equal(co.coattn_bwd_dq(q, x, mask, 30.0, g, out, m, l, xs, xi), dq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", QUERY_PIPELINE)
def test_dx_kernel_many_queries(device, dtype, case):
    """The looped dX instance: dq within TOL_DX_DQ and dX against the plain
    version (f32 dX within TOL_F32_BWD of the exact function, dq too but at
    C = 8; bf16 dX within one bf16 ulp of its largest element), masked rows
    holding features: dX exactly 0 there and on the empty bag; one "loop"
    launch; the same bits on a second call."""
    B, N, C, P = case
    q, x, mask, gout = _dx_inputs(B, N, C, P, dtype, device, seed=11)
    out, m, l = co.coattn_fwd(q, x, mask, 30.0)
    paths = dict(co.LAUNCHES_QUERY_PATH)
    dq, dx = co.coattn_bwd_dx(q, x, mask, 30.0, gout, out, m, l)
    torch.cuda.synchronize()
    assert co.LAUNCHES_QUERY_PATH == dict(paths, loop=paths["loop"] + 1)
    rdq, rdx = co.coattn_bwd_dx_reference(q, x, mask, 30.0, gout, out, m, l)
    assert torch.isfinite(dq).all() and torch.isfinite(dx).all()
    assert _rel(dq, rdq) <= TOL_DX_DQ[dtype]
    if dtype == torch.float32:
        edq, edx = co.coattn_bwd_dx_reference(q, x, mask, 30.0, gout, out, m, l, dtype=EXACT)
        assert _rel(dx, edx) <= TOL_F32_BWD["dx"]
        if _tight_f32_dq(dtype, C):
            assert _rel(dq, edq) <= TOL_F32_BWD["dq"]
    else:
        assert float((dx.float() - rdx.float()).abs().max()) <= _bf16_ulp_of_max(rdx)
    assert torch.all(dx[~mask] == 0) and torch.all(dx[-1] == 0)
    dq2, dx2 = co.coattn_bwd_dx(q, x, mask, 30.0, gout, out, m, l)
    assert torch.equal(dq2, dq) and torch.equal(dx2, dx)


@pytest.mark.parametrize("P", [8657, 20000])
def test_dx_kernel_refuses_queries_past_its_shared_memory(device, P):
    """Past its old limit (8,656 queries of f32 x, whose rows' stats no
    longer fit a block's shared memory) the looped dX instance runs: each
    query group's stats are staged as it comes, so nothing is refused; at
    8,657 and 20,000 queries, C = 512, dq within TOL_DX_DQ of the plain
    version and dX within TOL_F32_BWD of the exact function (f32; bf16 dX
    within one bf16 ulp), one "loop" launch, with at most
    _DQ_WS_BYTES of dq partials."""
    for dtype in (torch.float32, torch.bfloat16):
        q, x, mask, gout = _dx_inputs(2, 300, 512, P, dtype, device, seed=12)
        out, m, l = co.coattn_fwd(q, x, mask, 30.0)
        paths = dict(co.LAUNCHES_QUERY_PATH)
        dq, dx = co.coattn_bwd_dx(q, x, mask, 30.0, gout, out, m, l)
        torch.cuda.synchronize()
        assert co.LAUNCHES_QUERY_PATH == dict(paths, loop=paths["loop"] + 1)
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        plan = co.kernel_plan("coattn_bwd_dx", dtype, 2, 300, n_sm, 512, P)
        assert 4 * plan["blocks"] * P * 512 <= co._DQ_WS_BYTES
        assert dq.shape == (P, 512) and torch.isfinite(dq).all() and torch.isfinite(dx).all()
        rdq, rdx = co.coattn_bwd_dx_reference(q, x, mask, 30.0, gout, out, m, l)
        assert _rel(dq, rdq) <= TOL_DX_DQ[dtype]
        if dtype == torch.float32:
            _edq, edx = co.coattn_bwd_dx_reference(q, x, mask, 30.0, gout, out, m, l,
                                                    dtype=EXACT)
            assert _rel(dx, edx) <= TOL_F32_BWD["dx"]
        else:
            assert float((dx.float() - rdx.float()).abs().max()) <= _bf16_ulp_of_max(rdx)
        assert torch.all(dx[~mask] == 0) and torch.all(dx[-1] == 0)
        del q, x, mask, gout, out, m, l, dq, dx, rdq, rdx
        torch.cuda.empty_cache()

def test_pool_at_32_gated_queries_routes_through_the_kernels(device):
    """VLFAN with 32 learned, gated queries (33 parameter rows, P = 32) on
    the card: one forward and one dQ launch a step on the "grid" route (the
    projecter's dX launch on the "loop" route), gradients within 1e-3 of the
    same module on the CPU for f32 features."""
    from vlsa_tpu_torch.models.mil import VLFAN
    for use_feat_proj in (False, True):
        kw = dict(dim_in=512, use_feat_proj=use_feat_proj, query="Parameter", num_query=32,
                  gated_query=True)
        cpu = VLFAN(**kw, generator=torch.Generator().manual_seed(0))
        card = VLFAN(**kw, generator=torch.Generator().manual_seed(0)).to(device)
        assert card.effective_query().shape == (32, 512)
        x = torch.randn(3, 700, 512, generator=torch.Generator().manual_seed(1))
        mask = torch.rand(3, 700, generator=torch.Generator().manual_seed(2)) > 0.2
        mask[-1] = False
        cpu(x, mask).square().sum().backward()
        paths = dict(co.LAUNCHES_QUERY_PATH)
        card(x.to(device), mask.to(device)).square().sum().backward()
        assert co.LAUNCHES_QUERY_PATH == dict(
            paths, grid=paths["grid"] + (1 if use_feat_proj else 2),
            loop=paths["loop"] + int(use_feat_proj))
        for (n, pc), (_n, pk) in zip(cpu.named_parameters(), card.named_parameters()):
            assert _rel(pk.grad.cpu(), pc.grad) <= 1e-3, n

def _all_launches():
    return (sum(ab.LAUNCHES.values()) + sum(ab.LAUNCHES_BWD.values()) + sum(co.LAUNCHES.values())
            + sum(co.LAUNCHES_BWD.values()) + sum(co.LAUNCHES_DX.values())
            + sum(fa.LAUNCHES.values()))


def _double_backward(out, leaf):
    """The gradient of sum(d(out^2)/d leaf) with respect to `leaf`: a second
    backward through whatever `out` went through."""
    (g,) = torch.autograd.grad(out.square().sum(), leaf, create_graph=True)
    (h,) = torch.autograd.grad(g.square().sum(), leaf)
    return h


@pytest.mark.parametrize("case", ["abmil_f32", "abmil_bf16_dx", "abmil_int8", "coattn_dq",
                                  "coattn_dx"])
def test_double_backward_through_a_kernel_raises(device, case):
    """The kernels' autograd.Functions are once_differentiable: outside
    `ops.flags.disable_kernels` a second backward through one raises, and
    the Hessian estimate (`hutchinson_hessian_diag`) raises, not a silent
    zero (autograd gives nothing there when unused inputs are allowed)."""
    from vlsa_tpu_torch.optim.extra import hutchinson_hessian_diag
    if case.startswith("abmil"):
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[
            case.split("_")[1]]
        x, xs, mask, w1, b1, w2, _g = _abmil_inputs(2, 129, dtype, device, seed=3)
        w1.requires_grad_(True)
        if case.endswith("_dx"):
            x = x.detach().requires_grad_(True)
        out = ab.abmil_pool(x, mask, w1, b1, w2, x_scale=xs)
        leaf = w1
    else:
        q, x, mask, _s, _i = _inputs(2, 64, 64, 4, torch.float32, False, device)
        q.requires_grad_(True)
        if case == "coattn_dx":
            x = x.clone().requires_grad_(True)
        out = co.coattn_pool(q, x, mask, 30.0)
        leaf = q
    with pytest.raises(RuntimeError):
        _double_backward(out, leaf)
    with pytest.raises(RuntimeError, match="disable_kernels"):
        hutchinson_hessian_diag(out.square().sum(), [leaf], ["leaf"])


def test_the_switch_takes_the_plain_versions_on_the_card(device):
    """Inside `ops.flags.disable_kernels()` every kernel entry point takes its
    plain version on the card: no launch, CUDA results equal to the plain
    version's, and a second backward that works (the adahessian step's);
    after the block the kernels launch again."""
    x, xs, mask, w1, b1, w2, _g = _abmil_inputs(2, 129, torch.float32, device, seed=4)
    q, xc, maskc, _s, _i = _inputs(2, 64, 64, 4, torch.float32, False, device)
    qkv = [torch.randn(2, 3, 37, 64, device=device, dtype=torch.bfloat16) for _ in range(3)]
    before = _all_launches()
    with flags.disable_kernels():
        w1g = w1.clone().requires_grad_(True)
        out = ab.abmil_pool(x, mask, w1g, b1, w2)
        assert out.is_cuda and torch.equal(out, ab.abmil_fwd_reference(x, mask, w1, b1, w2)[0])
        assert torch.isfinite(_double_backward(out, w1g)).all()
        qg = q.clone().requires_grad_(True)
        outc = co.coattn_pool(qg, xc, maskc, 30.0)
        assert outc.is_cuda and torch.equal(outc, co.coattn_pool_reference(q, xc, maskc, 30.0))
        assert torch.isfinite(_double_backward(outc, qg)).all()
        att = fa.flash_self_attention(*qkv)
        assert att.is_cuda and torch.equal(att, fa.flash_self_attention_reference(*qkv))
    assert _all_launches() == before
    ab.abmil_pool(x, mask, w1, b1, w2)
    co.coattn_pool(q, xc, maskc, 30.0)
    fa.flash_self_attention(*qkv)
    torch.cuda.synchronize()
    assert _all_launches() == before + 3


def test_gradient_request_raises(device):
    """q's gradient goes through the dQ kernel; a gradient for x through the
    dX kernel, with q's or without, and never the dQ-only kernel; the
    gradients match autograd through the plain version.  Quantized features
    whose scales need a gradient raise."""
    q, x, mask, _s, _i = _inputs(2, 64, 64, 4, torch.float32, False, device)
    q.requires_grad_(True)
    fwd, bwd = co.LAUNCHES["f32"], co.LAUNCHES_BWD["f32"]
    co.coattn_pool(q, x, mask, 30.0).square().sum().backward()
    assert co.LAUNCHES["f32"] == fwd + 1 and co.LAUNCHES_BWD["f32"] == bwd + 1
    q_plain = q.detach().clone().requires_grad_(True)
    co.coattn_pool_reference(q_plain, x, mask, 30.0).square().sum().backward()
    assert float((q.grad - q_plain.grad).abs().max() / q_plain.grad.abs().max()) <= 1e-3
    for q_grad in (True, False):
        grads = []
        for pool, launched in ((co.coattn_pool, 1), (co.coattn_pool_reference, 0)):
            qq = q.detach().clone().requires_grad_(q_grad)
            xx = x.clone().requires_grad_(True)
            fwd, bwd, dx = co.LAUNCHES["f32"], dict(co.LAUNCHES_BWD), co.LAUNCHES_DX["f32"]
            pool(qq, xx, mask, 30.0).square().sum().backward()
            grads.append((qq.grad, xx.grad))
            assert co.LAUNCHES["f32"] == fwd + launched and co.LAUNCHES_BWD == bwd
            assert co.LAUNCHES_DX["f32"] == dx + launched
        (kq, kx), (pq, px) = grads
        assert _rel(kx, px) <= 1e-3
        assert (kq is None and pq is None) if not q_grad else _rel(kq, pq) <= 1e-3
    _q, xi, _m, xs, _i = _inputs(2, 64, 64, 4, torch.int8, False, device)
    with pytest.raises(ValueError, match="constants"):
        co.coattn_pool(q, xi, mask, 30.0, x_scale=xs.clone().requires_grad_(True))
    with torch.inference_mode():
        assert co.coattn_pool(q, x, mask, 30.0).shape == (2, 4, 64)


def test_vlfan_feat_proj_routes_through_the_dx_kernel(device):
    """A VLFAN with a feature projecter on the card: one forward and one dX
    launch a step, no dQ-only launch; its gradients match the same module
    on the CPU (plain autograd) within 1e-3 for f32 features."""
    from vlsa_tpu_torch.models.mil import VLFAN
    cpu = VLFAN(dim_in=64, use_feat_proj=True, query="Parameter", num_query=4,
                generator=torch.Generator().manual_seed(0))
    card = VLFAN(dim_in=64, use_feat_proj=True, query="Parameter", num_query=4,
                 generator=torch.Generator().manual_seed(0)).to(device)
    x = torch.randn(3, 100, 64, generator=torch.Generator().manual_seed(1))
    mask = torch.rand(3, 100, generator=torch.Generator().manual_seed(2)) > 0.2
    mask[-1] = False
    cpu(x, mask).square().sum().backward()
    before = (dict(co.LAUNCHES), dict(co.LAUNCHES_BWD), dict(co.LAUNCHES_DX))
    card(x.to(device), mask.to(device)).square().sum().backward()
    assert co.LAUNCHES["f32"] == before[0]["f32"] + 1 and co.LAUNCHES_BWD == before[1]
    assert co.LAUNCHES_DX["f32"] == before[2]["f32"] + 1
    for (n, pc), (_n, pk) in zip(cpu.named_parameters(), card.named_parameters()):
        assert _rel(pk.grad.cpu(), pc.grad) <= 1e-3, n
    card(x.to(device).to(torch.bfloat16), mask.to(device)).square().sum().backward()
    assert co.LAUNCHES_DX["bf16"] == before[2]["bf16"] + 1


# flash self-attention (row 11): max|a-b| / max|b| against the plain version,
# chip_smoke.py phase 2d's tolerances
TOL_FLASH = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 12, 197), (3, 2, 130), (1, 3, 64), (2, 2, 37), (2, 1, 1),
                                   (2, 2, fa.RESIDENT_CAPACITY), (2, 2, fa.RESIDENT_CAPACITY + 1),
                                   (1, 2, 1025)])
def test_flash_kernel_matches_plain(device, dtype, shape):
    """Ragged key and query tiles (L no multiple of 64), L = 1, a whole tile,
    and lengths that straddle the resident path's capacity: bf16 takes the
    path `flash_plan` names, and only that path's counter moves."""
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(*shape, 64, generator=g).to(dtype).to(device) for _ in range(3))
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    before, paths = fa.LAUNCHES[name], dict(fa.LAUNCHES_PATH)
    out = fa.flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    want_paths = dict(paths)
    if dtype == torch.bfloat16:
        want_paths[fa.flash_plan(shape[-1])[0]] += 1
    assert fa.LAUNCHES_PATH == want_paths
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert _rel(out, fa.flash_self_attention_reference(q, k, v)) <= TOL_FLASH[dtype]


@pytest.mark.parametrize("shape", [(2, 1, 1), (3, 2, 63), (2, 3, 64), (5, 1, 65), (1, 4, 127),
                                   (2, 2, 128), (3, 1, 129), (1, 2, 785), (2, 3, 801),
                                   (1, 5, 1025), (1, 2, 2049)])
def test_flash_streamed_path_forced_matches_plain(device, shape):
    """The streamed kernel, called through the private hook, at its tile
    edges (64 query rows a block, 64 keys a stage: L = 1, 63, 64, 65, 127,
    128, 129), at CONCH's lengths (785, 1025), just past the resident
    capacity (801) and at 2049, with several B*H, holds TOL_FLASH, and only
    its counter moves."""
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(*shape, 64, generator=g).to(torch.bfloat16).to(device)
               for _ in range(3))
    before = dict(fa.LAUNCHES_PATH)
    out = fa.flash_attn_fwd(q, k, v, _force_path="streamed")
    torch.cuda.synchronize()
    assert fa.LAUNCHES_PATH == dict(before, streamed=before["streamed"] + 1)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert _rel(out, fa.flash_self_attention_reference(q, k, v)) <= TOL_FLASH[torch.bfloat16]


@pytest.mark.parametrize("L", [197, 785, 801, 1025])
def test_flash_zero_query_probe(device, L):
    """q = 0, v = 1: every score is 0, so P = 1/L normalised and then rounded
    to bf16 makes every output exactly L * bf16(1/L) (1.0009765625 at L =
    1025), where an online softmax, which rounds before it knows l, gives
    1.  Every bf16 path, planned and forced, within 1e-6."""
    g = torch.Generator().manual_seed(L)
    q = torch.zeros(2, 3, L, 64, dtype=torch.bfloat16, device=device)
    k = torch.randn(2, 3, L, 64, generator=g).to(torch.bfloat16).to(device)
    v = torch.ones_like(q)
    want = L * torch.tensor(1.0 / L).to(torch.bfloat16).double().item()
    paths = [None, "streamed"] + (["resident"] if L <= fa.RESIDENT_CAPACITY else [])
    for path in paths:
        out = fa.flash_attn_fwd(q, k, v, _force_path=path).double()
        assert float((out - want).abs().max()) <= 1e-6 * want, (path, want)


def test_flash_resident_launch_error_raises(device, monkeypatch):
    """A resident launch that fails raises FlashKernelError and launches no
    other path: a length beyond the capacity forced onto the resident path,
    and a launch whose C call reports an error."""
    q = torch.randn(1, 1, 1025, 64, device=device).to(torch.bfloat16)
    before = (dict(fa.LAUNCHES), dict(fa.LAUNCHES_PATH))
    with pytest.raises(fa.FlashKernelError):
        fa.flash_attn_fwd(q, q, q, _force_path="resident")
    q = q[:, :, :785].contiguous()
    lib = fa._library()

    class Failing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def flash_attn_fwd(*args):
            return 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(fa, "_library", lambda: Failing())
    with pytest.raises(fa.FlashKernelError, match="resident"):
        fa.flash_attn_fwd(q, q, q, _force_path="resident")
    assert (fa.LAUNCHES, fa.LAUNCHES_PATH) == before


def test_flash_streamed_launch_error_raises(device, monkeypatch):
    """A streamed launch that fails raises FlashKernelError and launches no
    other path: a grid the kernel refuses (B*H above 65,535) and a launch
    whose C call reports an error, through the planned entry point."""
    q = torch.randn(65536, 1, 1, 64, device=device).to(torch.bfloat16)
    before = (dict(fa.LAUNCHES), dict(fa.LAUNCHES_PATH))
    with pytest.raises(fa.FlashKernelError, match="streamed"):
        fa.flash_self_attention(q, q, q)
    q = torch.randn(1, 2, 1025, 64, device=device).to(torch.bfloat16)
    lib = fa._library()

    class Failing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def flash_attn_fwd(*args):
            return 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(fa, "_library", lambda: Failing())
    with pytest.raises(fa.FlashKernelError, match="streamed"):
        fa.flash_self_attention(q, q, q)
    assert (fa.LAUNCHES, fa.LAUNCHES_PATH) == before


def test_flash_kernel_refuses_what_it_does_not_take(device):
    q = torch.randn(1, 2, 9, 32, device=device)
    with pytest.raises(ValueError, match="hd=64"):
        fa.flash_self_attention(q, q, q)
    q = torch.randn(1, 2, 9, 64, device=device)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_self_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa.flash_self_attention(*(q.half(),) * 3)


def test_vision_block_routes_through_the_flash_kernel(device):
    """A CONCH block on the card launches the kernel once and agrees with
    the same block on the CPU (plain attention): f32 1e-4."""
    from vlsa_tpu_torch.models.vision_tower import TimmViTBlock
    blk = TimmViTBlock(128, 2, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 37, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = blk(x)
        before = fa.LAUNCHES["f32"]
        got = blk.to(device)(x.to(device))
    assert fa.LAUNCHES["f32"] == before + 1
    assert _rel(got.cpu(), want) <= 1e-4


def _lifecycle_config(tmp_path, n=24, seed=5):
    """A small flagship VLSA run (dim 512, a 2-layer text tower, bf16 bags
    of ~300 patches) on a synthetic cohort of n patients."""
    import csv
    g = torch.Generator().manual_seed(seed)
    pids = [f"P{i:03d}" for i in range(n)]
    with open(tmp_path / "survival.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pathology_id", "patient_id", "e", "t"])
        for pid in pids:
            w.writerow([pid + "-slide", pid, int(torch.rand(1, generator=g) < 0.7),
                        round(2 + 88 * float(torch.rand(1, generator=g)), 2)])
    with open(tmp_path / "splits_0.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "train", "val"])
        n_train = 2 * n // 3
        for i in range(n_train):
            w.writerow([i, pids[i], pids[n_train + i] if n_train + i < n else ""])
    assets = "vlsa_tpu/assets/tools/"
    return {
        "task": "vlsa", "seed": 42, "save_path": str(tmp_path / "run"), "save_prediction": True,
        "ckpt_for_eval": "last", "num_shot": -1, "dataset_name": "tcga_test",
        "path_patch": "synthetic://N=300,D=512,seed=3", "path_table": str(tmp_path / "survival.csv"),
        "data_mode": "patch", "feat_format": "pt", "time_format": "interval", "time_bins": None,
        "data_split_path": str(tmp_path / "splits_0.csv"), "data_split_seed": 0,
        "arch": "VLSA", "net_output_converter": "softmax",
        "model_saver_module_filter": "prompt_encoder", "vlsa_api": "CONCH",
        "vlsa_img_encoder_name": "VLFAN", "vlsa_img_encoder_dim_in": 512,
        "vlsa_img_encoder_use_feat_proj": False, "vlsa_img_encoder_query": "Text",
        "vlsa_img_encoder_num_query": None, "vlsa_img_encoder_query_pooling": "mean",
        "vlsa_img_encoder_query_text_method": "TaskRes",
        "vlsa_img_encoder_query_text_res_ratio": 0.5,
        "vlsa_img_encoder_query_text_load_path": assets + "survival_text_prototypes.json",
        "vlsa_img_encoder_query_text_load_idx": "tcga_blca_0",
        "vlsa_txt_encoder_name": "mahmoodlab/conch", "vlsa_txt_encoder_frozen": True,
        "vlsa_pmt_learner_name": "CoOp", "vlsa_pmt_learner_coop_method": "rank",
        "vlsa_pmt_learner_coop_num_ranks": None, "vlsa_pmt_learner_coop_num_base_ranks": 4,
        "vlsa_pmt_learner_coop_num_tokens_per_rank": 4,
        "vlsa_pmt_learner_coop_num_context_tokens": 8,
        "vlsa_pmt_learner_coop_rank_tokens_position": "tail",
        "vlsa_pmt_learner_coop_init_prompt_path": assets + "survival_prompts.json",
        "loss_type": "SurvIFMLE-SurvEMD", "loss_survemd_p": 2, "evaluator": "VL-IF",
        "opt_name": "adam", "opt_lr": 2e-4, "opt_weight_decay": 1e-5, "epochs": 2,
        "bp_every_batch": 8, "feats_dtype": "bfloat16", "min_bucket": 64,
        "_test_tower_overrides": {"width": 64, "heads": 4, "layers": 2, "output_dim": 512,
                                  "dtype": "float32"},
    }


def test_lifecycle_reload_is_bit_identical_on_the_card(device, tmp_path):
    """Two epochs of the handler on the card with the co-attention kernels
    engaged: the test probabilities after the last checkpoint is loaded
    (the final evaluation) equal those of the last epoch's pass of the
    in-memory model bit for bit, and the kernels' merges are deterministic."""
    import numpy as np
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler
    handler = VLSAHandler(_lifecycle_config(tmp_path), device=device)
    passes = []
    test_model = handler.test_model

    def recording(dataset, name, ckpt_path=None):
        out = test_model(dataset, name, ckpt_path=ckpt_path)
        if name == "test":
            passes.append(out["pred"]["y_hat"])
        return out
    handler.test_model = recording
    co.reset_launches()
    handler.exec()
    assert co.LAUNCHES["bf16"] > 0 and co.LAUNCHES_BWD["bf16"] > 0
    assert sum(co.LAUNCHES.values()) == co.LAUNCHES["bf16"]
    assert len(passes) == 3  # 2 epochs, then the final pass after the reload
    assert np.isfinite(passes[-1]).all()
    assert np.array_equal(passes[-2], passes[-1])
    assert not np.array_equal(passes[0], passes[-1])  # the second epoch trained


def test_interpret_cohort_kernel_matches_plain_on_the_card(device, tmp_path):
    """The cohort attribution of a small synthetic split (the run config
    above, its test patients) through the f32 co-attention forward
    kernel, one launch a batch and no other kernel, equals the same cohort
    through the plain pooling: similarities, Shapley importances and
    probabilities within 1e-5 (the f32 kernel's split-TF32 products)."""
    import numpy as np
    from vlsa_tpu_torch.interpret import interpret_cohort
    from vlsa_tpu_torch.models import mil
    from vlsa_tpu_torch.runner.train import make_dataset
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler

    handler = VLSAHandler(_lifecycle_config(tmp_path), device=device)
    dataset = make_dataset(handler.cfg, handler.data_meta, handler.data_split["test"])
    co.reset_launches()
    ab.reset_launches()
    got = interpret_cohort(handler.model, dataset, batch_size=4, min_bucket=64)
    batches = -(-len(dataset) // 4)
    assert co.LAUNCHES["f32"] == batches
    assert sum(co.LAUNCHES.values()) == batches and sum(co.LAUNCHES_BWD.values()) == 0
    assert sum(ab.LAUNCHES.values()) == 0 and sum(ab.LAUNCHES_BWD.values()) == 0
    kernel_pool = mil.coattn_pool
    mil.coattn_pool = (lambda q, x, mask, scale, x_scale=None, x_inv=None:
                       co.coattn_pool_reference(q, x, mask, scale, x_scale))
    try:
        want = interpret_cohort(handler.model, dataset, batch_size=4, min_bucket=64)
    finally:
        mil.coattn_pool = kernel_pool
    assert got["uid"] == want["uid"] == list(dataset.uid)
    for k in ("decoupled_similarity", "shap_importance", "probs"):
        gap = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert gap <= 1e-5, (k, gap)


def test_abmil_attention_map_launches_no_abmil_kernel(device):
    """DeepMIL's `ret_with_attn` takes the explicit path on the card, as
    vlsa_tpu's does: no ABMIL kernel launches, and the pooled logits agree
    with the kernel path's."""
    from vlsa_tpu_torch.models.registry import load_model
    model = load_model("DeepMIL", [512, 256, 4], device=device, network="ABMIL",
                       pooling="attention", use_feat_proj=False).eval()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 1000, 512, generator=g).to(device)
    mask = torch.ones(2, 1000, dtype=torch.bool, device=device)
    mask[1, 600:] = False
    ab.reset_launches()
    with torch.inference_mode():
        logits, attn = model(x, mask, ret_with_attn=True)
        assert sum(ab.LAUNCHES.values()) == 0
        kernel = model(x, mask)
    assert ab.LAUNCHES["f32"] == 1 and attn.shape == (2, 1000)
    assert float((logits - kernel).abs().max() / kernel.abs().max()) <= TOL[torch.float32]
