"""Host-side matplotlib visualization (reference: plotting.py, the 3-D
scatter in main.py:300-315, and calibration.py:53-72).  Matplotlib is an
optional dependency imported lazily: without it every plot is skipped with
a warning, and with show_plot=False the Agg backend renders straight to
file so the pipeline runs headless."""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _plt(show: bool):
    """matplotlib.pyplot, or None (with a warning) when it is not
    installed."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed; skipping the plot.")
        return None
    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_correlation_heatmap(corr_matrix, mic_positions,
                             title: str = "Heatmap of peak correlations between microphone pairs",
                             show_plot: bool = True,
                             save_path: Optional[str] = None) -> None:
    """N x N peak-correlation heatmap (plotting.py:7-28)."""
    plt = _plt(show_plot)
    if plt is None:
        return
    corr_matrix = np.asarray(corr_matrix)
    num_mics = len(mic_positions)
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(corr_matrix, cmap="viridis")
    ax.set_xticks(np.arange(num_mics))
    ax.set_yticks(np.arange(num_mics))
    ax.set_xticklabels([f"Mic {i + 1}" for i in range(num_mics)])
    ax.set_yticklabels([f"Mic {i + 1}" for i in range(num_mics)])
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right",
             rotation_mode="anchor")
    cbar = ax.figure.colorbar(im, ax=ax)
    cbar.ax.set_ylabel("Peak Correlation", rotation=-90, va="bottom")
    ax.set_title(title)
    fig.tight_layout()
    if save_path:
        plt.savefig(save_path)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_correlation_3d(corr_data, mic_pairs, fs,
                        title: str = "3D Cross-Correlation Plots",
                        show_plot: bool = True,
                        save_path: Optional[str] = None) -> None:
    """One 3-D line per mic pair: lag x pair-index x correlation
    (plotting.py:30-48, including its symmetric-linspace lag axis)."""
    plt = _plt(show_plot)
    if plt is None:
        return
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    for idx, (corr, pair) in enumerate(zip(corr_data, mic_pairs)):
        corr = np.asarray(corr)
        lags = np.linspace(-(len(corr) - 1) / fs, (len(corr) - 1) / fs, len(corr))
        ax.plot(lags, [idx] * len(lags), corr,
                label=f"Mic {pair[0] + 1} - Mic {pair[1] + 1}")
    ax.set_xlabel("Lags (s)")
    ax.set_ylabel("Microphone Pairs")
    ax.set_zlabel("Correlation")
    ax.set_title(title)
    ax.legend()
    if save_path:
        plt.savefig(save_path)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_localization_3d(mic_positions, actual_position, estimated_position,
                         show_plot: bool = True,
                         save_path: Optional[str] = "localization_result.png"
                         ) -> None:
    """Mics / true source / estimate scatter (main.py:300-315)."""
    plt = _plt(show_plot)
    if plt is None:
        return
    mic_positions = np.asarray(mic_positions)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(mic_positions[:, 0], mic_positions[:, 1], mic_positions[:, 2],
               c="r", marker="o", label="Microphones")
    if actual_position is not None:
        ax.scatter(*np.asarray(actual_position), c="g", marker="*", s=100,
                   label="Actual source")
    ax.scatter(*np.asarray(estimated_position), c="b", marker="x", s=100,
               label="Estimated source")
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_zlabel("Z (m)")
    ax.legend()
    plt.title("Sound Source Localization")
    if show_plot:
        plt.show()
    elif save_path:
        plt.savefig(save_path)
    plt.close(fig)


def plot_calibration_results(results: Sequence[dict],
                             show_plot: bool = True,
                             save_path: Optional[str] = None) -> None:
    """Per-mic delay bars + amplitude line (calibration.py:53-72)."""
    plt = _plt(show_plot)
    if plt is None:
        return
    delays = [res["delay"] for res in results]
    amplitudes = [res["amplitude"] for res in results]
    fig, ax1 = plt.subplots(figsize=(8, 5))
    indices = np.arange(len(results))
    ax1.bar(indices, delays, color="skyblue", alpha=0.7, label="Delay (s)")
    ax1.set_xlabel("Microphone Index")
    ax1.set_ylabel("Delay (s)", color="b")
    ax1.tick_params(axis="y", labelcolor="b")
    ax2 = ax1.twinx()
    ax2.plot(indices, amplitudes, "r-o", label="Amplitude")
    ax2.set_ylabel("Cross-correlation Amplitude", color="r")
    ax2.tick_params(axis="y", labelcolor="r")
    plt.title("Calibration Results per Microphone")
    fig.tight_layout()
    if save_path:
        plt.savefig(save_path)
    if show_plot:
        plt.show()
    plt.close(fig)
