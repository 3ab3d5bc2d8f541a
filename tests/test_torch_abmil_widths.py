"""The ABMIL pooling at the widths beside D=512, hid=256, and vlsa_tpu's
precise mode, on the CPU: the port's plain versions against vlsa_tpu's
Pallas kernels in interpret mode (`ab.INTERPRET = True`, as
tests/test_torch_abmil.py sets it), the width domain against the kernel
sources, the refusals outside it, and the launch plans at the new widths.

Shapes B=3, N=256, a ragged mask and one empty bag, at (D, hid) = (128, 64),
(192, 128) and (256, 512), and at every width of D in {100, 1000, 2560}
(2560: Virchow's features) by hid in {32, 96, 384, 1024}, which the kernels
take since they pad W1 (ANY_WIDTHS); and past the kernels' old limits, D =
8256 > 8192 (their "wide" route) by hid = 1088 > 1024, and hid = 1280 at D
= 512 (WIDE_WIDTHS), every storage and precise mode; the same numpy inputs
go to both packages.
Tolerances (max|a-b| / max|b|), those of tests/test_torch_abmil.py:
  - f32 1e-5: both true f32, the differences are summation order;
  - bf16 1e-4 for out, db1, dw2 (both round W1 to bf16 and accumulate in
    f32); dX 1e-2, one bf16 ulp of the written value; dW1 5e-4: both round
    dz to bf16, from f32 values that differ in their last bits (vlsa_tpu
    forms g . x with g split into bf16 hi + lo, the port with f32 g), so
    the dz that sit at a rounding boundary land on neighbouring bf16s, 2^-8
    apart (1.6e-4 to 2.4e-4 at these widths; tests/test_torch_abmil.py's
    D=64, hid=32 stays within 1e-4);
  - int8 1e-3 forward, 2e-3 weight gradients against the port's f32 plain
    version (the JAX kernel splits W1 and s*dz into int8 hi + lo);
  - precise mode (both modules' `_PRECISE` set): the port's plain model of
    its rounding (`abmil_fwd_rounded` / `abmil_bwd_rounded`, precise=True)
    within 1e-5 of the interpret kernel in out, m, l, dW1, db1 and dw2 (both
    split W1 and dz into bf16 hi + lo and sum in f32; at ANY_WIDTHS db1 and
    dw2 within 1e-5 of the size of their sums' terms, whose cancellation
    leaves both sides' f32 sums up to 1.1e-5 of max|db1| apart); dX 1e-2
    (bf16), and
    within 1e-5 of the exact model's (`abmil_bwd_rounded`, exact=True) f32
    dX beyond the kernel's one rounding of it to bf16 (`bwd_model_gaps`).
"""
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlsa_tpu.ops.abmil as ab
from vlsa_tpu_torch.ops import abmil as pab

B, N = 3, 256
WIDTHS = [(128, 64), (192, 128), (256, 512)]
ANY_WIDTHS = [(D, hid) for D in (100, 1000, 2560) for hid in (32, 96, 384, 1024)]
WIDE_WIDTHS = [(8256, 1088), (512, 1280)]
TOL_DW1_BF16 = 5e-4
# bf16 dW1 past D = 8192: the neighbouring-bf16 dz of TOL_DW1_BF16 come from
# g . x, which both sides sum over D channels in f32 (vlsa_tpu with g as bf16
# hi + lo), so more dz sit on the other side of a rounding boundary at
# D = 8256 (5.5e-4 measured) than at D <= 2560 (at most 2.4e-4)
TOL_DW1_BF16_WIDE = 1e-3
CSRC = Path(pab.__file__).parent / "csrc"


@pytest.fixture
def interpret():
    old = ab.INTERPRET
    ab.INTERPRET = True
    yield
    ab.INTERPRET = old


def _inputs(D, hid, seed=0, batch=B):
    """x [batch, N, D] and the weights: with batch 3 a full bag, a ragged
    one and an empty one; with 2 the ragged and the empty one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, N, D)).astype(np.float32)
    mask = np.zeros((batch, N), bool)
    mask[0, :N] = batch == 3
    mask[batch - 2, :150] = True
    mask[batch - 2, 40:60] = False
    x = x * mask[..., None]  # the last bag is empty
    w1 = (rng.normal(size=(hid, D)) * D ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=hid) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=hid) * hid ** -0.5).astype(np.float32)
    g = rng.normal(size=(batch, D)).astype(np.float32)
    return x, mask, w1, b1, w2, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_run(x, mask, w1, b1, w2, g):
    """vlsa_tpu's forward and backward kernels: (out, m, l), (dX, dW1, db1, dw2)."""
    args = (jnp.asarray(mask), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
    out, stats = ab._abmil_pallas(x, *args)
    grads = ab._abmil_pallas_bwd(x, *args, jnp.asarray(g), out, stats[:, 0, :])
    return (out, stats[:, 0, 0], stats[:, 0, 1]), grads


@pytest.mark.parametrize("widths", WIDTHS + ANY_WIDTHS)
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_plain_versions_match_pallas_at_other_widths(interpret, storage, widths):
    D, hid = widths
    x, mask, w1, b1, w2, g = _inputs(D, hid)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        storage]
    (out_j, m_j, l_j), (dx_j, dw1_j, db1_j, dw2_j) = _jax_run(jnp.asarray(x).astype(jdt), mask,
                                                              w1, b1, w2, g)
    xt = _t(x).to(tdt)
    out, m, l = pab.abmil_fwd_reference(xt, _t(mask), _t(w1), _t(b1), _t(w2))
    tol = {"f32": 1e-5, "bf16": 1e-4}[storage]
    assert out.shape == (B, D) and _rel(out, out_j) <= tol
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), rtol=1e-5)
    assert torch.all(out[2] == 0)
    dx, dw1, db1, dw2 = pab.abmil_bwd_reference(xt, _t(mask), _t(w1), _t(b1), _t(w2), _t(g),
                                                out, m, l)
    assert dw1.shape == (hid, D) and db1.shape == dw2.shape == (hid,)
    assert _rel(dx.float(), jnp.asarray(dx_j, jnp.float32)) <= {"f32": 1e-5, "bf16": 1e-2}[
        storage]
    for name, got, want in (("dw1", dw1, dw1_j), ("db1", db1, db1_j), ("dw2", dw2, dw2_j)):
        assert _rel(got, want) <= (TOL_DW1_BF16 if (storage, name) == ("bf16", "dw1") else tol), name


@pytest.mark.parametrize("widths", WIDTHS + ANY_WIDTHS)
def test_int8_plain_version_matches_pallas_at_other_widths(interpret, widths):
    D, hid = widths
    x, mask, w1, b1, w2, g = _inputs(D, hid, seed=1)
    amax = np.abs(x).max(-1) / 127.0
    q = np.clip(np.rint(x / np.where(amax > 0, amax, 1.0)[..., None]), -127, 127).astype(np.int8)
    s = amax.astype(np.float32)
    args = (jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
    out_j, stats = ab._abmil_q8_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask), *args)
    dw1_j, db1_j, dw2_j = ab._abmil_q8_pallas_bwd(jnp.asarray(q), jnp.asarray(s),
                                                  jnp.asarray(mask), *args, jnp.asarray(g),
                                                  out_j, stats)
    targs = (_t(q), _t(mask), _t(w1), _t(b1), _t(w2))
    out, m, l = pab.abmil_fwd_reference(*targs, x_scale=_t(s))
    assert _rel(out, out_j) <= 1e-3
    _dx, dw1, db1, dw2 = pab.abmil_bwd_reference(*targs, _t(g), out, m, l, x_scale=_t(s))
    for name, got, want in (("dw1", dw1, dw1_j), ("db1", db1, db1_j), ("dw2", dw2, dw2_j)):
        assert _rel(got, want) <= 2e-3, name
    # the model of the int8 W1 split meets the JAX kernel's stats at every width
    _o, m_r, l_r = pab.abmil_fwd_rounded(*targs, x_scale=_t(s))
    assert np.abs(m_r.numpy()[:2] - np.asarray(stats[:2, 0, 0])).max() <= 2e-6
    assert np.abs(l_r.numpy()[:2] / np.asarray(stats[:2, 0, 1]) - 1).max() <= 2e-6


@pytest.mark.parametrize("widths", WIDE_WIDTHS)
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "bf16_precise"])
def test_plain_versions_match_pallas_past_the_old_limits(interpret, monkeypatch, storage, widths):
    """Past the kernels' old limits (D = 8256, hid = 1088 and 1280), which
    vlsa_tpu's kernels, tiling only N, always took: the port's plain
    versions (those the CUDA kernels are held against on the card, at these
    widths in chip_smoke.py phase 2g) against the interpret-mode kernels at
    the tolerances of the other widths: f32 and bf16 as
    test_plain_versions_match_pallas_at_other_widths, int8 as
    test_int8_plain_version_matches_pallas_at_other_widths, precise mode's
    model as test_precise_model_matches_pallas_in_precise_mode (db1 and dw2
    by their sums' scale)."""
    D, hid = widths
    x, mask, w1, b1, w2, g = _inputs(D, hid, seed=5)
    assert pab.kernel_widths_ok(D, hid)
    assert pab.route(torch.float32, D, hid) == ("wide" if D > pab._SMEM_D else "general")
    targs = (_t(mask), _t(w1), _t(b1), _t(w2))
    if storage == "int8":
        amax = np.abs(x).max(-1) / 127.0
        q = np.clip(np.rint(x / np.where(amax > 0, amax, 1.0)[..., None]), -127, 127)
        q, s = q.astype(np.int8), amax.astype(np.float32)
        args = (jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
        out_j, stats = ab._abmil_q8_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask),
                                           *args)
        grads_j = ab._abmil_q8_pallas_bwd(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask),
                                          *args, jnp.asarray(g), out_j, stats)
        out, m, l = pab.abmil_fwd_reference(_t(q), *targs, x_scale=_t(s))
        assert _rel(out, out_j) <= 1e-3 and torch.all(out[2] == 0)
        grads = pab.abmil_bwd_reference(_t(q), *targs, _t(g), out, m, l, x_scale=_t(s))[1:]
        for name, got, want in zip(("dw1", "db1", "dw2"), grads, grads_j):
            assert _rel(got, want) <= 2e-3, name
        _o, m_r, l_r = pab.abmil_fwd_rounded(_t(q), *targs, x_scale=_t(s))
        assert np.abs(m_r.numpy()[:2] - np.asarray(stats[:2, 0, 0])).max() <= 2e-6
        assert np.abs(l_r.numpy()[:2] / np.asarray(stats[:2, 0, 1]) - 1).max() <= 2e-6
        return
    precise = storage == "bf16_precise"
    monkeypatch.setattr(ab, "_PRECISE", precise)
    xj = jnp.asarray(x).astype(jnp.float32 if storage == "f32" else jnp.bfloat16)
    (out_j, m_j, l_j), (dx_j, *grads_j) = _jax_run(xj, mask, w1, b1, w2, g)
    xt = _t(x).to(torch.float32 if storage == "f32" else torch.bfloat16)
    if precise:
        out, m, l = pab.abmil_fwd_rounded(xt, *targs, precise=True)
        dx, *grads = pab.abmil_bwd_rounded(xt, *targs, _t(g), out, m, l, precise=True)
        scales = pab.abmil_bwd_sum_scales(xt, *targs, _t(g), out, m, l, precise=True)
    else:
        out, m, l = pab.abmil_fwd_reference(xt, *targs)
        dx, *grads = pab.abmil_bwd_reference(xt, *targs, _t(g), out, m, l)
    tol = {"f32": 1e-5, "bf16": 1e-4, "bf16_precise": 1e-5}[storage]
    assert out.shape == (B, D) and _rel(out, out_j) <= tol and torch.all(out[2] == 0)
    np.testing.assert_allclose(m.numpy()[:2], np.asarray(m_j)[:2], rtol=1e-5)
    np.testing.assert_allclose(l.numpy()[:2], np.asarray(l_j)[:2], rtol=1e-5)
    assert _rel(dx.float(), jnp.asarray(dx_j, jnp.float32)) <= (1e-5 if storage == "f32"
                                                                 else 1e-2)
    for i, (name, got, want) in enumerate(zip(("dw1", "db1", "dw2"), grads, grads_j)):
        if precise and name != "dw1":
            err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
            assert err <= 1e-5 * float(scales[i - 1].max()), name
        else:
            assert _rel(got, want) <= (TOL_DW1_BF16_WIDE if (storage, name) == ("bf16", "dw1")
                                       else tol), name


@pytest.mark.parametrize("widths", [(64, 32), (192, 128), (256, 512)] + ANY_WIDTHS)
def test_precise_model_matches_pallas_in_precise_mode(interpret, monkeypatch, widths):
    """With VLSA_TPU_ABMIL_PRECISE's switch set in both packages (the module
    attribute each reads), the port's plain model of the precise rounding
    against the interpret-mode kernels; without precise=True the port's
    model is the single-rounded one and misses the JAX kernel by more."""
    monkeypatch.setattr(ab, "_PRECISE", True)
    monkeypatch.setattr(pab, "_PRECISE", True)
    D, hid = widths
    x, mask, w1, b1, w2, g = _inputs(D, hid, seed=2)
    (out_j, m_j, l_j), (dx_j, dw1_j, db1_j, dw2_j) = _jax_run(
        jnp.asarray(x).astype(jnp.bfloat16), mask, w1, b1, w2, g)
    xt = _t(x).to(torch.bfloat16)
    args = (xt, _t(mask), _t(w1), _t(b1), _t(w2))
    out, m, l = pab.abmil_fwd_rounded(*args, precise=True)
    assert _rel(out, out_j) <= 1e-5
    np.testing.assert_allclose(m.numpy()[:2], np.asarray(m_j)[:2], rtol=1e-5)
    np.testing.assert_allclose(l.numpy()[:2], np.asarray(l_j)[:2], rtol=1e-5)
    dx, dw1, db1, dw2 = pab.abmil_bwd_rounded(*args, _t(g), out, m, l, precise=True)
    assert dx.dtype == torch.bfloat16
    assert _rel(dx.float(), jnp.asarray(dx_j, jnp.float32)) <= 1e-2
    scales = pab.abmil_bwd_sum_scales(*args, _t(g), out, m, l, precise=True)
    for name, got, want in (("dw1", dw1, dw1_j), ("db1", db1, db1_j), ("dw2", dw2, dw2_j)):
        if widths in ANY_WIDTHS and name != "dw1":
            # db1 and dw2 are sums over every patch whose terms cancel (sum_n
            # ds_n = 0): both sides' f32 sums err by a share of the terms'
            # sizes (`abmil_bwd_sum_scales`), which at these widths reach past
            # 1e-5 of max|db1| (1.1e-5 at D=100, hid=96); held at 1e-5 of that
            # scale, as chip_smoke.py holds the kernels' (`bwd_model_gaps`)
            scale = float(scales[0 if name == "db1" else 1].max())
            err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
            assert err <= 1e-5 * scale, name
        else:
            assert _rel(got, want) <= 1e-5, name
    # the JAX kernel's bf16 dX is its f32 dX rounded once: within 1e-5 of
    # max|dX| of the exact model's f32 dX beyond that rounding (the
    # single-rounded model's is 1e-3 off)
    exact = pab.abmil_bwd_rounded(*args, _t(g), out, m, l, precise=True, exact=True)
    got_j = tuple(torch.from_numpy(np.asarray(jnp.asarray(t, jnp.float32)))
                  for t in (dx_j, dw1_j, db1_j, dw2_j))
    assert pab.bwd_model_gaps(got_j, exact, scales)["dX"] <= 1e-5
    # precise=None reads the module's switch: the same model
    assert torch.equal(pab.abmil_fwd_rounded(*args, precise=None)[0], out)
    # the single-rounded model (the default bf16 kernels') is farther off
    single = pab.abmil_bwd_rounded(*args, _t(g), out, m, l, precise=False)[1]
    assert _rel(single, dw1_j) > 1e-5


@pytest.mark.parametrize("hid, D", [(7, 33), (32, 100), (384, 1001), (1, 1), (1000, 2561)])
def test_int8_split_matches_the_jax_split_at_any_width(hid, D):
    """At hid * D not a multiple of 256 (the kernels' prep once assumed one),
    `split_w1_i8` equals vlsa_tpu's `_mm_rows_i8` bit for bit, and the split
    of W1 zero-padded to the general instances' [hid_p, ld] workspace
    (`gen_hid_pad`, `gen_ld`) is that split with zeros around it and the same
    s_w (max|W1| unchanged)."""
    from vlsa_tpu.ops.coattn import _mm_rows_i8
    rng = np.random.default_rng(hid * 7919 + D)
    assert (hid * D) % 256 != 0
    w = (rng.normal(size=(hid, D)) * 0.05).astype(np.float32)
    stacked, (s_j,) = _mm_rows_i8(jnp.asarray(w))
    stacked = np.asarray(stacked)
    hi, lo, s = pab.split_w1_i8(_t(w))
    assert np.array_equal(hi.numpy(), stacked[:hid]) and np.array_equal(lo.numpy(), stacked[hid:])
    assert np.asarray(s_j, np.float32).tobytes() == s.numpy().tobytes()
    hp, ld = pab.gen_hid_pad(hid), pab.gen_ld(D)
    padded = torch.zeros(hp, ld)
    padded[:hid, :D] = _t(w)
    phi, plo, ps = pab.split_w1_i8(padded)
    assert ps.numpy().tobytes() == s.numpy().tobytes()
    assert torch.equal(phi[:hid, :D], hi) and torch.equal(plo[:hid, :D], lo)
    phi[:hid, :D] = 0
    plo[:hid, :D] = 0
    assert not phi.any() and not plo.any()


def test_precise_mode_changes_only_bf16():
    """precise=True leaves f32 and int8 to their own rounding (vlsa_tpu does
    not route either through _PRECISE), and the route of a bf16 call at any
    width goes to the general instances."""
    x, mask, w1, b1, w2, g = _inputs(128, 64, seed=3)
    for xt in (_t(x), _t(x).to(torch.int8)):
        scale = torch.ones(B, N) if xt.dtype == torch.int8 else None
        a = pab.abmil_fwd_rounded(xt, _t(mask), _t(w1), _t(b1), _t(w2), x_scale=scale,
                                  precise=True)
        b = pab.abmil_fwd_rounded(xt, _t(mask), _t(w1), _t(b1), _t(w2), x_scale=scale)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert pab.route(torch.bfloat16, 512, 256, precise=True) == "precise"
    assert pab.route(torch.bfloat16, 512, 256, precise=False) == "special"
    assert pab.route(torch.float32, 512, 256, precise=True) == "special"
    assert pab.route(torch.int8, 1024, 256, precise=True) == "general"


# ---- the width domain and the kernel sources ----

def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_domain_mirrors_the_kernel_source():
    """`kernel_widths_ok` is the kernels' widths_ok (csrc/abmil_common.cuh):
    any D >= 1 and hid >= 1, and no block's shared memory grows past the
    card's with them: the general instances hold b1, w2 and the backward's
    column sums of every column up to kSmemHid (`_SMEM_HID`) padded
    columns, past that b1 and w2 for one pass (`stage_pass_vecs`, HP
    values) and the column sums in a per-block workspace (`ws_sums`), and
    D's vectors up to kSmemD (`_SMEM_D`) channels, past which `route` names
    the "wide" route; the
    general tile is kGenM; W1's padding (gen_hid_pad, gen_ld) and the pass
    widths (gen_pass_cols: the widest of 256, 128, 64 dividing the padded
    hid, up to gen_max_pass: f32 256, int8 128, bf16 and its precise mode
    64) are the sources', and the passes the sources instantiate cover
    them."""
    common = (CSRC / "abmil_common.cuh").read_text()
    fwd = (CSRC / "abmil_fwd.cu").read_text()
    bwd = (CSRC / "abmil_bwd.cu").read_text()
    body = re.search(r"inline bool widths_ok\(int D, int hid\) \{(.*?)\}", common, re.S).group(1)
    assert body.strip() == "return D >= 1 && hid >= 1;"
    assert "kGenMax" not in common + fwd + bwd
    assert _const(common, "kSmemD") == pab._SMEM_D and _const(common, "kGenM") == pab._GEN_TILE
    assert _const(common, "kSmemHid") == pab._SMEM_HID
    assert "return D <= kSmemD;" in common and "return hid_p <= kSmemHid;" in common
    # the shared memory's sizes: D capped at kSmemD, hid_p's vectors only up
    # to kSmemHid (else a pass's HP values)
    assert "static constexpr size_t total(int D, int hid_p) {" in fwd
    assert "static constexpr size_t total(int D, int hid_p) {" in bwd
    assert "(hid_in_smem(hid_p) ? hid_p : HP)" in fwd
    assert "(hid_in_smem(hid_p) ? 6 * (size_t)hid_p : 2 * (size_t)HP)" in bwd
    assert fwd.count("if (!hid_smem) stage_pass_vecs<HP>(b1, w2, hid, j0, b1s, w2s);") == 1
    assert bwd.count("if (!hid_smem) stage_pass_vecs<HP>(b1, w2, hid, j0, b1s, w2s);") == 2
    for D in (0, 1, 63, 64, 100, 2560, 4096, 8192, 8193, 10240, 132104):
        for hid in (0, 1, 32, 96, 384, 1024, 1025, 1536):
            assert pab.kernel_widths_ok(D, hid) == (D >= 1 and hid >= 1), (D, hid)
            if D >= 1 and hid >= 1 and (D, hid) != (512, 256):
                assert pab.route(torch.float32, D, hid) == ("wide" if D > 8192 else "general")
    assert "return (hid + 63) / 64 * 64;" in common and "return (D + 63) / 64 * 64;" in common
    fwd_hp = {int(h) for h in re.findall(r"launch_general_hp<OP, (\d+)>", fwd)}
    bwd_hp = {int(h) for h in re.findall(r"launch_dz_general_hp<OP, (\d+)>", bwd)}
    assert fwd_hp == bwd_hp == {64, 128, 256}
    cols = re.search(r"inline int gen_pass_cols\(int storage, int hid\) \{(.*?)\n\}", common,
                     re.S).group(1)
    assert "widest = gen_max_pass(gen_op(storage, false));" in cols
    assert "if (widest >= 256 && hp % 256 == 0) return 256;" in cols
    assert "return widest >= 128 && hp % 128 == 0 ? 128 : 64;" in cols
    assert "return op == GOp::kF32 ? 256 : (op == GOp::kI8 ? 128 : 64);" in common
    widest = {torch.float32: 256, torch.int8: 128, torch.bfloat16: 64}
    for hid in range(1, 1601):
        hp = pab.gen_hid_pad(hid)
        assert hp % 64 == 0 and hid <= hp < hid + 64
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            # gen_pass_cols: the widest of 256, 128, 64 up to the storage's dividing hp
            cols_ = max(c for c in (64, 128, 256) if c <= widest[dtype] and hp % c == 0)
            assert hp % cols_ == 0 and cols_ in fwd_hp
            if hid in (64, 128, 256, 512) and dtype != torch.bfloat16:  # f32, int8 keep theirs
                assert cols_ == (hid if hid <= 128 else (128 if dtype == torch.int8 else 256))


def _cuda_like(shape, dtype=torch.float32, dim=None):
    """A stand-in with a CUDA tensor's attributes, to reach the width check
    on a machine with no card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=shape,
                                 dim=lambda: len(shape) if dim is None else dim,
                                 is_contiguous=lambda: True, data_ptr=lambda: 0)


@pytest.mark.parametrize("D, hid, w1_shape", [(0, 256, None), (8193, 256, None), (512, 0, None),
                                             (512, 1025, None), (9000, 2000, None),
                                             (512, 256, (256,))])
def test_check_inputs_refuses_widths_outside_the_domain(D, hid, w1_shape):
    """A CUDA tensor of a width the kernels do not take (D or hid 0, or a w1
    that is not [hid, D]) raises a ValueError naming the widths, before
    anything is launched; the widths past the old shared-memory limits
    (D 8193 and 9000, hid 1025 and 2000) pass the width check and meet the
    next argument check; a CPU tensor is refused as before (the kernels need
    a card)."""
    x = _cuda_like((2, 70, D))
    w1 = _cuda_like(w1_shape or (hid, D))
    if D >= 1 and hid >= 1 and w1_shape is None:
        assert pab.kernel_widths_ok(D, hid)
        with pytest.raises(AttributeError):  # the width passed; the mask (None) is next
            pab._check_inputs(x, None, None, w1, None, None, "abmil_fwd")
    else:
        with pytest.raises(ValueError, match=r"D >= 1 features and w1 be \[hid >= 1, D\]"):
            pab._check_inputs(x, None, None, w1, None, None, "abmil_fwd")
    with pytest.raises(ValueError, match="CUDA"):
        pab.abmil_fwd(torch.zeros(2, 70, D), torch.ones(2, 70, dtype=torch.bool),
                      torch.zeros(hid, D), torch.zeros(hid), torch.zeros(hid))


# ---- the launch plans at the new widths ----

@pytest.mark.parametrize("widths", [(1024, 256), (768, 128), (1536, 512), (64, 64), (2048, 512),
                                    (512, 128), (2560, 256), (1000, 384), (100, 32), (4096, 1024),
                                    (33, 7), (8192, 1024), (8256, 1088), (512, 1280),
                                    (10240, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("precise", [False, True])
def test_plans_at_other_widths(widths, dtype, precise):
    """The general instances' plans: tiles of 64, chunks covering N, and
    workspaces of the widths, W1's padded to hid_p = gen_hid_pad(hid) rows
    of ld = gen_ld(D): W1 for the forward (bf16 [hid_p, ld]; int8 and
    precise bf16 hi + lo; f32 a padded copy), the dz workspace [B, N, hid_p]
    (int8 and precise: two bf16 planes), W1 for the backward's pass 1 (bf16
    hi + lo; int8 the forward's int8 split and its scales; f32 the padded
    copy), pass 2's dW1 partials [S2, hid, D] with S2 * dw_tiles about one
    wave of 132 SMs, under 9 MB where the tiles fit a wave (else one
    chunk), and past hid_p = 1024 pass 1's column sums [B * S1, 4, hid_p],
    in every storage and mode; past D = 8192 the "wide" route (the same
    instances)."""
    D, hid = widths
    n_sm = 132
    bf16p = precise and dtype == torch.bfloat16
    hp, ld = pab.gen_hid_pad(hid), pab.gen_ld(D)
    assert (hp, ld) == (-(-hid // 64) * 64, -(-D // 64) * 64)
    for Bn, Nn in ((8, 10240), (5, 12291), (32, 16384), (1, 5)):
        f = pab.fwd_plan(dtype, Bn, Nn, n_sm, D, hid, precise)
        assert f["route"] == ("precise" if bf16p else "wide" if D > 8192 else "general")
        assert f["tile"] == 64
        assert f["chunk"] % 64 == 0 and (f["S"] - 1) * f["chunk"] < Nn <= f["S"] * f["chunk"]
        assert f["ws_acc"] == (Bn, f["S"], D)
        assert f["w1_ws"] == {torch.float32: (hp, ld),
                              torch.bfloat16: (2, hp, ld) if bf16p else (hp, ld),
                              torch.int8: (2, hp, ld)}[dtype]
        assert f["w1_scale"] == ((65,) if dtype == torch.int8 else None)
        b = pab.bwd_plan(dtype, Bn, Nn, n_sm, D, hid, precise)
        assert b["route"] == f["route"]
        assert b["chunk1"] % 64 == 0 and (b["S1"] - 1) * b["chunk1"] < Nn <= b["S1"] * b["chunk1"]
        two = dtype == torch.int8 or bf16p
        assert b["ds"] == ((2, Bn, Nn, hp) if two else (Bn, Nn, hp))
        assert b["ds_dtype"] == (torch.float32 if dtype == torch.float32 else torch.bfloat16)
        tiles = pab.dw_tiles(D, hid)
        assert tiles == -(-hid // 128) * -(-D // 128)
        assert b["ws_dw1"] == (b["S2"], hid, D) and b["ws_b"] == (Bn * b["S1"], hid)
        assert b["S2"] * tiles <= max(n_sm, tiles)
        assert 4 * b["S2"] * hid * D <= max(9e6, 4 * hid * D)
        assert (b["S2"] - 1) * b["chunk2"] < Bn * Nn <= b["S2"] * b["chunk2"]
        assert b["w1_bf16"] == (None if dtype != torch.bfloat16 else (2, hp, ld))
        assert b["w1_i8"] == ((2, hp, ld) if dtype == torch.int8 else None)
        assert b["w1_f32"] == ((hp, ld) if dtype == torch.float32 else None)
        assert b["w1_scale"] == ((65,) if dtype == torch.int8 else None)
        assert b["ws_sums"] == ((Bn * b["S1"], 4, hp) if hp > pab._SMEM_HID else None)


def test_default_width_plans_are_unchanged():
    """At D=512, hid=256 the plans keep the resident instances' tiles and
    workspaces (bf16 precise excepted: the general instances)."""
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        f = pab.fwd_plan(dtype, 8, 10240, 132)
        assert f["route"] == "special" and f["tile"] == pab._FWD_TILE[dtype]
        b = pab.bwd_plan(dtype, 8, 10240, 132)
        assert b["S2"] == 132 // pab._DW_TILES and b["w1_i8"] is None
        assert b["w1_bf16"] == (None if dtype == torch.float32 else (2, 256, 512))
        assert b["ws_sums"] is None
    assert pab.fwd_plan(torch.bfloat16, 8, 10240, 132, precise=True)["route"] == "precise"
