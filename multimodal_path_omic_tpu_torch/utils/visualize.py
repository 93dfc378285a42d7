"""Attention-map rendering: raw exported arrays -> publication-style PNGs
(``multimodal_path_omic_tpu/utils/visualize.py``; the port's own copy,
numpy and matplotlib only, matplotlib imported at first render).

The reference's interpretability story ends at raw tensors on disk
(``torch.save(attention_scores['coattn'], ...)``, reference:
mcat/main.py:180-183) that are visualized by external tooling
(README.md:37-39). This module closes that loop: ``export-attn --png``
renders each exported map next to its array.

Design rules (magnitude data -> sequential encoding):
* one hue, light->dark ("Blues"), never a rainbow;
* robust percentile scaling (1-99%) so one hot patch doesn't wash out the map;
* text (title, axes, colorbar) in neutral ink, identity carried by position;
* single-row maps (GE path scores) render as a filled profile instead of a
  1-pixel-tall strip.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_INK = "#374151"  # neutral text ink
_MUTED = "#6b7280"  # secondary ink (axes, colorbar label)


def _matplotlib():
    try:
        import matplotlib

        matplotlib.use("Agg")  # headless; never require a display
        import matplotlib.pyplot as plt

        return plt
    except ImportError as exc:  # pragma: no cover
        raise ImportError(
            "attention PNG rendering needs matplotlib; install it or drop --png"
        ) from exc


def _robust_limits(a: np.ndarray) -> tuple:
    lo, hi = np.percentile(a, [1.0, 99.0])
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        lo, hi = float(np.min(a)), float(np.max(a))
        if hi <= lo:
            hi = lo + 1e-12
    return float(lo), float(hi)


def save_attention_png(
    attn: np.ndarray,
    out_path: str,
    *,
    row_labels: Optional[Sequence[str]] = None,
    title: Optional[str] = None,
) -> str:
    """Render an attention map [N, M] (or [M]) to ``out_path``.

    N >= 2 rows (survival co-attention: one row per omic signature) render as
    a heatmap with the patch axis along x; a single row (GE MIL path scores)
    renders as a filled attention profile over patch index.
    """
    plt = _matplotlib()
    a = np.asarray(attn, np.float32)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"attention map must be 1-D or 2-D, got shape {a.shape}")
    n, m = a.shape
    lo, hi = _robust_limits(a)

    if n == 1:
        fig, ax = plt.subplots(figsize=(10, 2.8), dpi=150)
        x = np.arange(m)
        y = a[0]
        ax.fill_between(x, y, color="#93c5fd", alpha=0.55, linewidth=0)
        ax.plot(x, y, color="#1d4ed8", linewidth=1.2)
        ax.set_ylabel("attention", color=_MUTED, fontsize=9)
        ax.margins(x=0)
    else:
        # figure width tracks M a little, capped: 20k patches stays readable
        fig, ax = plt.subplots(
            figsize=(min(12.0, 6.0 + m / 4000.0), 1.1 + 0.42 * n), dpi=150
        )
        im = ax.imshow(
            a,
            aspect="auto",
            interpolation="nearest" if m <= 4096 else "antialiased",
            cmap="Blues",
            vmin=lo,
            vmax=hi,
        )
        cbar = fig.colorbar(im, ax=ax, fraction=0.04, pad=0.02)
        cbar.set_label("attention weight", color=_MUTED, fontsize=9)
        cbar.ax.tick_params(labelsize=8, colors=_MUTED)
        cbar.outline.set_visible(False)
        if row_labels is not None and len(row_labels) == n:
            ax.set_yticks(range(n))
            ax.set_yticklabels(row_labels, fontsize=8, color=_INK)
        else:
            ax.set_yticks(range(n))
            ax.set_yticklabels(
                [f"q{i}" for i in range(n)], fontsize=8, color=_MUTED
            )
    ax.set_xlabel(f"patch index (M={m})", color=_MUTED, fontsize=9)
    ax.tick_params(labelsize=8, colors=_MUTED)
    for s in ax.spines.values():
        s.set_color("#d1d5db")
    if title:
        ax.set_title(title, fontsize=10, color=_INK, loc="left")
    fig.tight_layout()
    root, ext = os.path.splitext(out_path)
    if ext.lower() != ".png":
        out_path = out_path + ".png"
    fig.savefig(out_path, facecolor="white")
    plt.close(fig)
    return out_path


def save_km_png(
    km_by_group,
    out_path: str,
    *,
    p_value: Optional[float] = None,
    title: Optional[str] = None,
) -> str:
    """Render Kaplan-Meier step curves, one per group.

    ``km_by_group``: dict label -> (event_times, S(t)) as produced by
    train/metrics.py::kaplan_meier. Curves start at (0, 1) and step down at
    each event time; the log-rank p-value (train/metrics.py::logrank_test)
    is annotated when given. The standard figure of the MCAT-family papers;
    the reference renders nothing.
    """
    plt = _matplotlib()
    fig, ax = plt.subplots(figsize=(6, 4.5), dpi=120)
    for label, (times, surv) in km_by_group.items():
        times = np.asarray(times, dtype=float)
        surv = np.asarray(surv, dtype=float)
        xs = np.concatenate([[0.0], times])
        ys = np.concatenate([[1.0], surv])
        ax.step(xs, ys, where="post", label=str(label))
    ax.set_xlabel("survival months")
    ax.set_ylabel("survival probability")
    ax.set_ylim(0.0, 1.02)
    if title:
        ax.set_title(title)
    if p_value is not None:
        ax.annotate(
            f"log-rank p = {p_value:.3g}",
            xy=(0.97, 0.95), xycoords="axes fraction", ha="right", va="top",
        )
    ax.legend(loc="lower left")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
