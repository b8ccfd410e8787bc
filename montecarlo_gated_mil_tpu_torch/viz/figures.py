"""The five-panel uncertainty figure (matplotlib, imported when drawn).

Counterpart of ``montecarlo_gated_mil_tpu/viz/figures.py`` (reference
``infer.py:15-93``): the input image, the negative attention (Blues, scaled
by mean P(neg)), the positive attention (Reds, scaled by mean P(pos)), the
negative and positive attention variance (gray), and a caption with the
mean, std, median, IQR and range of P(cancer) and the mean predictive
entropy with its verbal bucket; saved as PDF and PNG at ``dpi``.
"""

from __future__ import annotations

import numpy as np

from montecarlo_gated_mil_tpu_torch.mcdo.sampling import PredictiveStats, interpret_entropy


def plot_attention_and_density(
    image: np.ndarray,  # (H, W) or (H, W, C) grayscale display image
    pos_att: np.ndarray,  # (H, W) mean positive attention map
    pos_std: np.ndarray,  # (H, W)
    neg_att: np.ndarray,  # (H, W)
    neg_std: np.ndarray,  # (H, W)
    stats: PredictiveStats,
    *,
    title_class: str = "",
    num_samples: int = 0,
    save_path: str | None = None,
    dpi: int = 500,
):
    """Draw the figure; with ``save_path`` write ``save_path + ".pdf"`` and
    ``".png"``.  Returns ``save_path``.  Host arrays in, host arrays only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    neg_scale = float(stats.mean_probs[0])
    pos_scale = float(stats.mean_probs[1])

    fig = plt.figure(figsize=(10, 5))
    gs = fig.add_gridspec(1, 5)
    panels = [
        (np.asarray(image), None, "Input Image", {}),
        (np.asarray(neg_att) * neg_scale, "Blues", "Negative Attention",
         dict(vmin=0.0, vmax=1.0)),
        (np.asarray(pos_att) * pos_scale, "Reds", "Positive Attention",
         dict(vmin=0.0, vmax=1.0)),
        (np.asarray(neg_std) ** 2, "gray", "Negative Variance", {}),
        (np.asarray(pos_std) ** 2, "gray", "Positive Variance", {}),
    ]
    for i, (img, cmap, title, kw) in enumerate(panels):
        ax = fig.add_subplot(gs[0, i])
        ax.imshow(img, cmap=cmap, **kw)
        ax.set_title(title)
        ax.axis("off")

    stats_text = (
        f"Probability of Cancer:     {float(stats.mean):.2f} "
        f"({float(stats.std):.2f}) mean (std);     "
        f"{float(stats.median):.2f} ({float(stats.iqr):.2f}) median (iqr);     "
        f"{float(stats.low):.2f}-{float(stats.high):.2f} range;\n"
        f"Mean Entropy: {float(stats.mean_entropy):.2f} "
        f"({interpret_entropy(stats.mean_entropy)} uncertainty)"
    )
    props = dict(boxstyle="round,pad=0.3", edgecolor="black", facecolor="white")
    fig.text(0.5, -0.02, stats_text, fontsize=11, va="center", ha="center", bbox=props)
    fig.suptitle(
        f"Positive and Negative Attentions for {num_samples} Monte Carlo "
        f"Dropout Samples - Ground Truth: {title_class}\n"
    )
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path + ".pdf", format="pdf", bbox_inches="tight", dpi=dpi)
        fig.savefig(save_path + ".png", format="png", bbox_inches="tight", dpi=dpi)
    plt.close(fig)
    return save_path
