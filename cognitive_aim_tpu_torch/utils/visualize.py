"""Visualization: 3-panel prediction PNGs and the nine-grid figure (the
port's copy of cognitive_aim_tpu/utils/visualize.py; host-side numpy,
matplotlib, scipy and PIL imported inside the functions).

Reproduces demo.py's artifact surface: `demo_results/{stem}_{instruction}_
prediction.png` with original image / attention overlay (cube contrast boost,
70th-percentile threshold, plasma, alpha 0.6) / text panel
(ref:demo.py:471-600), and create_nine_grid_demo.py's 3x3 composite
(ref:create_nine_grid_demo.py:16-88)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from cognitive_aim_tpu_torch.io.preprocess import IMAGENET_MEAN_NP, IMAGENET_STD_NP


def _denormalize(image_nhwc: np.ndarray) -> np.ndarray:
    img = image_nhwc * IMAGENET_STD_NP + IMAGENET_MEAN_NP
    return np.clip(img, 0.0, 1.0)


def attention_heatmap(attention: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Contrast-boosted attention map resized to image size
    (ref:demo.py:529-563)."""
    from scipy.ndimage import zoom

    attn = np.asarray(attention, np.float64).reshape(-1)
    attn = np.power(attn, 3)  # cube boost (ref:demo.py:533)
    thr = np.percentile(attn, 70)
    attn = np.where(attn > thr, attn, attn * 0.3)  # ref:demo.py:536-537
    attn = (attn - attn.min()) / (attn.max() - attn.min() + 1e-8)

    n = attn.size
    g = int(np.sqrt(n))
    if g * g == n:
        attn2d = attn.reshape(g, g)
    else:  # pad to next square (ref:demo.py:548-552)
        t = int(np.ceil(np.sqrt(n)))
        padded = np.zeros(t * t)
        padded[:n] = attn
        attn2d = padded.reshape(t, t)
    return zoom(attn2d, (out_h / attn2d.shape[0], out_w / attn2d.shape[1]), order=1)


def save_prediction_image(
    image_nhwc: np.ndarray,
    depth_value: float,
    confidence: float,
    attention: Optional[np.ndarray],
    instruction: Optional[str],
    image_path: str,
    output_dir: str = "demo_results",
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(image_path).stem
    name = f"{stem}_{instruction}_prediction.png" if instruction else f"{stem}_prediction.png"
    out_path = out_dir / name

    img = _denormalize(np.asarray(image_nhwc))
    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    axes[0].imshow(img)
    axes[0].set_title("Original Image", fontsize=14, fontweight="bold")
    axes[0].axis("off")

    if attention is not None:
        h, w = img.shape[:2]
        heat = attention_heatmap(attention, h, w)
        axes[1].imshow(img)
        im = axes[1].imshow(heat, cmap="plasma", alpha=0.6,
                            interpolation="bilinear", vmin=0, vmax=1)
        axes[1].set_title("Focus Map (Overlay)", fontsize=14, fontweight="bold")
        axes[1].axis("off")
        cbar = plt.colorbar(im, ax=axes[1], fraction=0.046, pad=0.04)
        cbar.set_label("Attention Weight", rotation=270, labelpad=15)
    else:
        axes[1].imshow(img)
        axes[1].set_title("No Attention Data", fontsize=14)
        axes[1].axis("off")

    ax = axes[2]
    ax.text(0.5, 0.7, f"Predicted Depth: {depth_value:.4f}m",
            ha="center", va="center", transform=ax.transAxes,
            fontsize=16, fontweight="bold")
    ax.text(0.5, 0.5, f"Confidence: {confidence:.4f}", ha="center", va="center",
            transform=ax.transAxes, fontsize=14, color="blue")
    if instruction:
        ax.text(0.5, 0.3, f"Instruction: {instruction}", ha="center", va="center",
                transform=ax.transAxes, fontsize=12)
    ax.set_title("Prediction Results")
    ax.axis("off")

    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return str(out_path)


def create_nine_grid_layout(demo_results_dir: str, output_path: str,
                            image_stem: str = "2") -> Optional[str]:
    """3x3 composite of per-instruction prediction PNGs
    (ref:create_nine_grid_demo.py:16-88)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.gridspec import GridSpec
    from PIL import Image

    grid = [
        ["top-left", "top", "top-right"],
        ["left", "center", "right"],
        ["bottom-left", "bottom", "bottom-right"],
    ]
    fig = plt.figure(figsize=(15, 15))
    gs = GridSpec(3, 3, figure=fig, hspace=0.1, wspace=0.1)
    found = 0
    for r, row in enumerate(grid):
        for c, direction in enumerate(row):
            path = os.path.join(
                demo_results_dir, f"{image_stem}_{direction}_prediction.png"
            )
            ax = fig.add_subplot(gs[r, c])
            if os.path.exists(path):
                ax.imshow(np.asarray(Image.open(path)))
                found += 1
            ax.set_title(direction, fontsize=12, fontweight="bold")
            ax.axis("off")
    if found == 0:
        plt.close(fig)
        return None
    plt.suptitle("Nine-Grid Spatial Guidance", fontsize=18, fontweight="bold")
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def visualize_depth_prediction(image_nhwc, pred_depth, gt_depth, save_path=None):
    """3-panel image/pred/GT plasma plot (ref:src/utils.py:136-181)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(_denormalize(np.asarray(image_nhwc)))
    axes[0].set_title("Input Image")
    axes[0].axis("off")
    im1 = axes[1].imshow(np.asarray(pred_depth), cmap="plasma")
    axes[1].set_title("Predicted Depth")
    axes[1].axis("off")
    plt.colorbar(im1, ax=axes[1], fraction=0.046, pad=0.04)
    im2 = axes[2].imshow(np.asarray(gt_depth), cmap="plasma")
    axes[2].set_title("Ground Truth Depth")
    axes[2].axis("off")
    plt.colorbar(im2, ax=axes[2], fraction=0.046, pad=0.04)
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
