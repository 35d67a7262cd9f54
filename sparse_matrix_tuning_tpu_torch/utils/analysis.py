"""--do_gradient_distribution_analysis: histograms of the selection's
saliency (PyTorch twin of `sparse_matrix_tuning_tpu.utils.analysis`;
reference analyze_gradient_distribution, smt_helper.py:14-38). Called at
matrix selection (train/convert.compute_matrix_selection) on the host's
numpy statistics.

Where matplotlib is installed the figure is JAX's, pixel for pixel (the
same file name, figure and dpi). The GPU machine has no matplotlib, so
there the same panels (one 150-bin histogram a module, three a row, each
750 x 750 pixels as JAX's 15 x 5 inch rows at dpi 150) are drawn with
Pillow: bars, axes, the module's name, the axis labels and the value
range, under the same file name."""

from __future__ import annotations

import importlib.util
import os
from collections import defaultdict
from typing import Dict, Mapping

import numpy as np

BINS = 150
N_COLS = 3
# the Pillow drawing: a panel's pixels, its plot area's margins (left,
# top, right, bottom: 4 pixels a bin, 600 high), the bars' colour (JAX's
# default blue at alpha 0.7 over white)
PANEL = 750
MARGINS = (100, 60, 50, 90)
BAR_RGB = (98, 160, 202)


def analyze_gradient_distribution(stats: Mapping, output_dir: str) -> str:
    """stats: {(module, layer): block-stat array}. Draws one 150-bin
    histogram per module, writes gradient_histograms_{modules}.png into
    output_dir and returns its path."""
    per_module: Dict[str, list] = defaultdict(list)
    for (module, _layer), arr in stats.items():
        per_module[module].extend(np.asarray(arr).reshape(-1).tolist())
    key_string = "_".join(per_module.keys())
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"gradient_histograms_{key_string}.png")
    if has_matplotlib():
        _draw_matplotlib(per_module, path)
    else:
        _draw_pillow(per_module, path)
    return path


def has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _draw_matplotlib(per_module: Dict[str, list], path: str) -> None:
    """JAX's figure (sparse_matrix_tuning_tpu/utils/analysis.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_keys = len(per_module)
    n_rows = (n_keys + N_COLS - 1) // N_COLS
    fig, axes = plt.subplots(n_rows, N_COLS, figsize=(15, 5 * n_rows), squeeze=False)
    axes = axes.flatten()
    for ax, (module, values) in zip(axes, per_module.items()):
        ax.hist(np.asarray(values), bins=BINS, alpha=0.7, edgecolor="black")
        ax.set_xlabel("Gradient Magnitude", fontsize=10)
        ax.set_ylabel("Frequency", fontsize=10)
        ax.set_title(module)
    for i in range(n_keys, len(axes)):
        axes[i].axis("off")
    plt.tight_layout()
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_box(index: int):
    """(left, top, width, height) of panel `index`'s plot area, in pixels."""
    left, top, right, bottom = MARGINS
    return ((index % N_COLS) * PANEL + left, (index // N_COLS) * PANEL + top,
            PANEL - left - right, PANEL - top - bottom)


def _draw_pillow(per_module: Dict[str, list], path: str) -> None:
    """The same panels without matplotlib: bin b of np.histogram(values,
    150) is a bar of round(count / max count * height) pixels at columns
    left + 4b .. left + 4b + 2 of its plot area."""
    from PIL import Image, ImageDraw, ImageFont
    n_rows = (len(per_module) + N_COLS - 1) // N_COLS
    img = Image.new("RGB", (N_COLS * PANEL, n_rows * PANEL), "white")
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default(size=20)
    for i, (module, values) in enumerate(per_module.items()):
        counts, edges = np.histogram(np.asarray(values), bins=BINS)
        left, top, width, height = plot_box(i)
        bar = width // BINS
        peak = max(int(counts.max()), 1)
        for b, c in enumerate(counts):
            h = round(int(c) / peak * height)
            if h:
                draw.rectangle([left + bar * b, top + height - h, left + bar * b + bar - 2,
                                top + height - 1], fill=BAR_RGB)
        draw.rectangle([left - 1, top - 1, left + width, top + height], outline="black")
        draw.text((left + width // 2, top - 30), module, fill="black", font=font, anchor="mm")
        draw.text((left + width // 2, top + height + 60), "Gradient Magnitude", fill="black",
                  font=font, anchor="mm")
        draw.text((left, top + height + 20), f"{edges[0]:.3g}", fill="black", font=font,
                  anchor="lm")
        draw.text((left + width, top + height + 20), f"{edges[-1]:.3g}", fill="black",
                  font=font, anchor="rm")
        draw.text((left - 10, top), f"{peak}", fill="black", font=font, anchor="rm")
        draw.text((left - 10, top + height), "0", fill="black", font=font, anchor="rm")
        draw.text((left - 10, top - 30), "Frequency", fill="black", font=font, anchor="lm")
    img.save(path)
