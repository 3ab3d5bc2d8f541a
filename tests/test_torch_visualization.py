"""The port's interpretation plots (vlsa_tpu_torch.interpret.visualization)
mirror tests/test_visualization.py, headless (Agg): each plot renders from
numpy arrays and from CPU tensors, and the ordinality heatmap's span
accuracy equals vlsa_tpu's on the same embeddings (exactly: the same f64
arithmetic on the same values)."""
import numpy as np
import pytest
import torch

from vlsa_tpu.interpret import visualization as jax_vis
from vlsa_tpu_torch.interpret.visualization import (
    get_default_cmap,
    plot_attention_heatmap,
    plot_attention_histogram,
    plot_incidence_survival,
    plot_ordinality_heatmap,
    plot_shap_bars,
    plot_wsi_heatmap,
)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plots_render(tmp_path, as_tensor):
    rng = np.random.default_rng(0)
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    plot_shap_bars(wrap(rng.normal(size=8)), save_path=str(tmp_path / "shap.png"))
    assert (tmp_path / "shap.png").exists()
    probs = np.abs(rng.normal(size=6))
    plot_incidence_survival(wrap(probs / probs.sum()), save_path=str(tmp_path / "inc.png"))
    assert (tmp_path / "inc.png").exists()
    plot_attention_histogram(wrap(np.abs(rng.normal(size=(4, 100)))),
                             save_path=str(tmp_path / "attn.png"))
    assert (tmp_path / "attn.png").exists()


@pytest.mark.parametrize("seed,ordered", [(0, True), (1, False), (2, False)])
def test_ordinality_span_accuracy_matches_jax(seed, ordered):
    """Embeddings on a line (similarity decays with rank distance: span
    accuracy near 1) and random ones; the port's equals vlsa_tpu's."""
    rng = np.random.default_rng(seed)
    K, D = 6, 8
    if ordered:
        base, direction = rng.normal(size=D), rng.normal(size=D) * 0.05
        E = np.stack([base + i * direction for i in range(K)])
    else:
        E = rng.normal(size=(K, 2, D // 2))  # [K, tokens, width] is flattened
    _, got = plot_ordinality_heatmap(torch.from_numpy(E))
    _, want = jax_vis.plot_ordinality_heatmap(E)
    assert got == want
    if ordered:
        assert got > 0.95


def test_wsi_and_attention_heatmaps(tmp_path):
    """The patch-grid maps render from coordinates alone and equal
    vlsa_tpu's images; the palette is the reference's."""
    rng = np.random.default_rng(0)
    N, P, side = 200, 3, 20
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)
    coords = grid[:N] * 256
    labels = rng.integers(0, 5, size=N)
    _, img = plot_wsi_heatmap(coords, torch.from_numpy(labels), patch_size=256, downsample=32,
                              save_path=str(tmp_path / "wsi.png"))
    _, want = jax_vis.plot_wsi_heatmap(coords, labels, patch_size=256, downsample=32)
    assert img.ndim == 3 and img.shape[2] == 3 and (img != 255).any()
    np.testing.assert_array_equal(img, want)
    assert (tmp_path / "wsi.png").exists()
    assert get_default_cmap(4) == jax_vis.get_default_cmap(4)
    assert get_default_cmap(4)[0] == (0x69, 0x69, 0x69)

    A = rng.random((P, N))
    A /= A.sum(1, keepdims=True)
    _, heats = plot_attention_heatmap(torch.from_numpy(A), coords, patch_size=256,
                                      downsample=32, save_path=str(tmp_path / "attn.png"))
    _, want_heats = jax_vis.plot_attention_heatmap(A, coords, patch_size=256, downsample=32)
    assert len(heats) == P and heats[0].ndim == 3
    for h, w in zip(heats, want_heats):
        np.testing.assert_array_equal(h, w)
    assert (tmp_path / "attn.png").exists()

    bg = np.full((side * 8, side * 8, 3), 200, np.uint8)
    _, img_bg = plot_wsi_heatmap(coords, labels, patch_size=256, downsample=32, background=bg)
    assert (img_bg != img).any()
    with pytest.raises(ValueError, match="palette"):
        plot_wsi_heatmap(coords, np.full(N, 40), patch_size=256, downsample=32)
