"""Interpretation plots (the port's own copy of
vlsa_tpu/interpret/visualization.py): SHAP bars, incidence/survival curves,
the ordinality heatmap of rank embeddings with its span accuracy, attention
histograms and heatmaps on the slide's patch grid.

Host code: every function takes numpy arrays or CPU tensors.  matplotlib
(and scipy, for the heatmap's blur) are imported inside the functions, so
importing this module needs neither; nothing on the card's path imports it.
The slide thumbnail under a heatmap is the caller's (no slide reader here).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _np(x, dtype=None) -> np.ndarray:
    """A numpy copy of an array or a CPU tensor."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_shap_bars(shap_values: np.ndarray, prior_names: Optional[Sequence[str]] = None,
                   save_path: Optional[str] = None, title: str = "Prognostic-prior SHAP"):
    """Signed horizontal bar plot of per-prior Shapley importances
    (ref utils/visualization.py:24-113)."""
    plt = _plt()
    shap_values = _np(shap_values)
    P = len(shap_values)
    names = prior_names if prior_names is not None else [f"prior {i}" for i in range(P)]
    order = np.argsort(np.abs(shap_values))
    fig, ax = plt.subplots(figsize=(7, 0.4 * P + 1.5))
    colors = ["#d62728" if v > 0 else "#1f77b4" for v in shap_values[order]]
    ax.barh(np.arange(P), shap_values[order], color=colors)
    ax.set_yticks(np.arange(P))
    ax.set_yticklabels([names[i] for i in order], fontsize=8)
    ax.axvline(0, color="k", lw=0.8)
    ax.set_xlabel("SHAP value (risk contribution)")
    ax.set_title(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_incidence_survival(probs: np.ndarray, time_coordinates=None,
                            save_path: Optional[str] = None):
    """Incidence function + derived survival curve (ref visualization.py:119-155)."""
    plt = _plt()
    probs = _np(probs).reshape(-1)
    K = len(probs)
    xs = _np(time_coordinates) if time_coordinates is not None else np.arange(K)
    survival = 1.0 - np.cumsum(probs)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.2))
    ax1.bar(np.arange(K), probs, color="#1f77b4")
    ax1.set_title("Incidence function")
    ax1.set_xlabel("time bin")
    ax2.step(xs, survival, where="post", color="#d62728")
    ax2.set_ylim(0, 1)
    ax2.set_title("Survival function")
    ax2.set_xlabel("time")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_ordinality_heatmap(rank_embeddings: np.ndarray,
                            save_path: Optional[str] = None):
    """Cosine-similarity heatmap of rank embeddings + span accuracy
    (ref visualization.py:247-305): for an ordinal embedding the similarity
    should decay monotonically with rank distance."""
    plt = _plt()
    E = _np(rank_embeddings)
    if E.ndim == 3:
        E = E.reshape(E.shape[0], -1)
    En = E / np.linalg.norm(E, axis=-1, keepdims=True)
    sim = En @ En.T
    K = sim.shape[0]
    # span accuracy: fraction of (i, j, k) with |i-j| < |i-k| where sim order agrees
    correct = total = 0
    for i in range(K):
        for j in range(K):
            for k in range(K):
                if abs(i - j) < abs(i - k):
                    total += 1
                    correct += sim[i, j] > sim[i, k]
    span_acc = correct / max(total, 1)
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(sim, cmap="viridis")
    ax.set_title(f"Rank-embedding similarity (span acc {span_acc:.3f})")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig, span_acc


def plot_attention_histogram(attention: np.ndarray, save_path: Optional[str] = None):
    """Per-prior attention distribution over patches (ref visualization.py:311-359;
    spatial overlays need coords + openslide)."""
    plt = _plt()
    A = _np(attention)  # [P, N]
    fig, ax = plt.subplots(figsize=(6, 3))
    for p in range(A.shape[0]):
        ax.hist(A[p], bins=50, histtype="step", alpha=0.6, label=f"prior {p}")
    ax.set_yscale("log")
    ax.set_xlabel("attention weight")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


# Reference categorical palette (ref utils/visualization.py:160-175)
_DEFAULT_COLORS = [
    "#696969", "#556b2f", "#a0522d", "#483d8b",
    "#008000", "#008b8b", "#000080", "#7f007f",
    "#8fbc8f", "#b03060", "#ff0000", "#ffa500",
    "#00ff00", "#8a2be2", "#00ff7f", "#FFFF54",
    "#00ffff", "#00bfff", "#f4a460", "#adff2f",
    "#da70d6", "#b0c4de", "#ff00ff", "#1e90ff",
    "#f0e68c", "#0000ff", "#dc143c", "#90ee90",
    "#ff1493", "#7b68ee", "#ffefd5", "#ffb6c1",
]


def get_default_cmap(n: int = 32) -> dict:
    """label -> RGB (0..255) mapping, same palette as ref
    utils/visualization.py:160-175."""
    from matplotlib.colors import to_rgb
    colors = _DEFAULT_COLORS[:n]
    return {i: tuple(int(255 * c) for c in to_rgb(h)) for i, h in enumerate(colors)}


def _rasterize(coords: np.ndarray, values: np.ndarray, patch_size: int,
               downsample: int):
    """Paint per-patch values onto a level-`downsample` raster from level-0
    patch coordinates (the coordinate-grid core of ref
    visualization.py:181-241 / 311-341, no slide reader needed)."""
    coords = _np(coords, np.float64)
    values = _np(values)
    if values.ndim == 1:
        values = values[:, None]
    C = values.shape[-1]
    cd = np.floor(coords / downsample).astype(np.int64)
    ps = max(1, int(np.ceil(patch_size / downsample)))
    W = int(cd[:, 0].max()) + ps + 1
    H = int(cd[:, 1].max()) + ps + 1
    img = np.zeros((H, W, C), values.dtype)
    filled = np.zeros((H, W), bool)
    for i in range(len(cd)):
        x, y = cd[i]
        img[y:y + ps, x:x + ps] = values[i]
        filled[y:y + ps, x:x + ps] = True
    return img, filled


def plot_wsi_heatmap(coords: np.ndarray, labels: np.ndarray,
                     patch_size: int = 256, downsample: int = 32,
                     label2color: Optional[dict] = None,
                     background: Optional[np.ndarray] = None,
                     alpha: float = 0.4, canvas_color=(255, 255, 255),
                     save_path: Optional[str] = None,
                     title: str = "Prototypical-cluster heatmap"):
    """Categorical patch heatmap on the slide's coordinate grid
    (ref utils/visualization.py:181-241 `visualize_categorical_heatmap`).

    coords [N, 2] level-0 patch coordinates (x, y), labels [N] int cluster /
    prototype assignments.  The reference blends colored patch blocks onto an
    OpenSlide thumbnail; here the thumbnail is optional (`background`, an RGB
    array at the same downsample) — without it, blocks are painted on a plain
    canvas, which needs no slide reader (raw WSIs are not distributable).
    """
    plt = _plt()
    labels = _np(labels).reshape(-1).astype(int)
    if label2color is None and labels.max() >= len(_DEFAULT_COLORS):
        raise ValueError(
            f"default palette has {len(_DEFAULT_COLORS)} colors (ref "
            f"utils/visualization.py:160-175) but labels reach "
            f"{int(labels.max())}; pass label2color for more classes")
    cmap = label2color if label2color is not None else get_default_cmap(
        int(labels.max()) + 1)
    colors = np.stack([_np(cmap[int(l)], np.float64) for l in labels])
    img, filled = _rasterize(coords, colors, patch_size, downsample)
    if background is not None:
        bg = _np(background, np.float64)
        H = min(bg.shape[0], img.shape[0])
        W = min(bg.shape[1], img.shape[1])
        canvas = np.full_like(img, 255.0)
        canvas[:H, :W] = bg[:H, :W]
    else:
        canvas = np.ones_like(img) * _np(canvas_color, np.float64)
    out = np.where(filled[..., None], alpha * img + (1 - alpha) * canvas, canvas)
    out = out.astype(np.uint8)
    fig, ax = plt.subplots(figsize=(6, 6 * out.shape[0] / max(out.shape[1], 1)))
    ax.imshow(out)
    ax.set_axis_off()
    ax.set_title(title, fontsize=9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig, out


def plot_attention_heatmap(attention: np.ndarray, coords: np.ndarray,
                           patch_size: int = 256, downsample: int = 32,
                           blur_sigma: float = 1.5, opacity: float = 0.3,
                           background: Optional[np.ndarray] = None,
                           normalize: bool = True, threshold: Optional[float] = None,
                           save_path: Optional[str] = None,
                           prior_names: Optional[Sequence[str]] = None):
    """Per-prior spatial attention heatmaps on the coordinate grid
    (ref utils/visualization.py:311-359 `generate_pred_mask` +
    `generate_heatmap`): rasterise attention onto the downsampled grid,
    Gaussian-blur, min-max normalise, colormap (turbo), blend over the
    thumbnail (or plain canvas).  attention [P, N] (or [N]) over patches.
    """
    plt = _plt()
    from scipy.ndimage import gaussian_filter

    A = _np(attention, np.float64)
    if A.ndim == 1:
        A = A[None, :]
    if threshold is not None:
        A = np.where(A < threshold, 0.0, A)
    P = A.shape[0]
    mask, filled = _rasterize(coords, A.T, patch_size, downsample)  # [H, W, P]

    turbo = plt.get_cmap("turbo")
    ncol = min(P, 4)
    nrow = (P + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 3.2 * nrow),
                             squeeze=False)
    heats = []
    for p in range(P):
        hm = gaussian_filter(mask[..., p], sigma=blur_sigma)
        if normalize and hm.max() > hm.min():
            hm = (hm - hm.min()) / (hm.max() - hm.min())
        rgb = turbo(hm)[..., :3] * 255.0
        if background is not None:
            bg = _np(background, np.float64)
            H = min(bg.shape[0], rgb.shape[0])
            W = min(bg.shape[1], rgb.shape[1])
            canvas = np.full_like(rgb, 255.0)
            canvas[:H, :W] = bg[:H, :W]
        else:
            canvas = np.full_like(rgb, 255.0)
        out = (opacity * rgb + (1 - opacity) * canvas).astype(np.uint8)
        heats.append(out)
        ax = axes[p // ncol][p % ncol]
        ax.imshow(out)
        ax.set_axis_off()
        name = prior_names[p] if prior_names is not None else f"prior {p}"
        ax.set_title(name, fontsize=8)
    for p in range(P, nrow * ncol):
        axes[p // ncol][p % ncol].set_axis_off()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig, heats
