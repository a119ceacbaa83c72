"""Embedding-similarity distribution monitor.

Counterpart of dycon_paper_replication_tpu/utils/monitor.py: 50-bin
histograms of the positive-pair (same class) and negative-pair cosine
similarities / tau of the projection embeddings, over the observed range,
saved as a PNG where matplotlib is installed. The histograms are computed on
the embeddings' device; only the counts and edges cross to the host.

Semantics of the JAX function: rows in tiles of 512, else 256, else N (the
first that divides N); a first pass takes the min and max similarity, a
second bins each tile by clip(int((s - lo) / max(hi - lo, 1e-9) * 50), 0, 49).
JAX fuses its (B, c, N, 50) one-hot compare into the reduction; here each
tile is binned by one `torch.bincount` over idx + 50 * same, so no one-hot
tensor is built.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BINS = 50


def _chunk(n: int) -> int:
    return 512 if n % 512 == 0 else (256 if n % 256 == 0 else n)


@torch.no_grad()
def similarity_histograms(feat: torch.Tensor, mask: torch.Tensor, tau: float = 0.6):
    """feat (B, N, D) L2-normalised embeddings, mask (B, N) class ids ->
    (pos_hist, neg_hist) int64 (50,) and edges (51,), on feat's device."""
    b, n, _ = feat.shape
    feat = feat.float()
    chunk = _chunk(n)

    def tile_sim(i):
        return torch.einsum("bcd,bnd->bcn", feat[:, i:i + chunk], feat) / tau

    lo = hi = None
    for i in range(0, n, chunk):
        s = tile_sim(i)
        lo = s.min() if lo is None else torch.minimum(lo, s.min())
        hi = s.max() if hi is None else torch.maximum(hi, s.max())
    edges = torch.linspace(0, 1, BINS + 1, device=feat.device) * (hi - lo) + lo
    counts = torch.zeros(2 * BINS, dtype=torch.int64, device=feat.device)
    width = torch.clamp(hi - lo, min=1e-9)
    for i in range(0, n, chunk):
        s = tile_sim(i)
        idx = torch.clamp(((s - lo) / width * BINS).to(torch.int32), 0, BINS - 1)
        same = mask[:, i:i + chunk, None] == mask[:, None, :]
        counts += torch.bincount((idx + BINS * same).flatten(), minlength=2 * BINS)
    return counts[BINS:], counts[:BINS], edges


def monitor_similarity_distributions(feat, mask, epoch: int,
                                     path_prefix: str = "./similarity_plots") -> str | None:
    """Save the positive/negative histogram PNG and return its path (None
    where matplotlib is not installed)."""
    pos, neg, edges = (t.cpu().numpy() for t in similarity_histograms(feat, mask))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    os.makedirs(path_prefix, exist_ok=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    width = (edges[-1] - edges[0]) / BINS
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].bar(centers, pos, width=width, alpha=0.7, color="green")
    axes[0].set_title("Positive Pair Similarities")
    axes[1].bar(centers, neg, width=width, alpha=0.7, color="red")
    axes[1].set_title("Negative Pair Similarities")
    for ax in axes:
        ax.set_xlabel("Similarity")
        ax.set_ylabel("Frequency")
    fig.tight_layout()
    out = os.path.join(path_prefix, f"epoch_{epoch}_similarity_distributions.png")
    fig.savefig(out)
    plt.close(fig)
    return out
