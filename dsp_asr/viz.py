"""Visualization of pipeline internals (the reference's GUI/plot analog).

Renders a 4-panel figure for one utterance — waveform with the detected
VAD region, per-frame energy/ZCR with thresholds, the MFCC(+deltas)
heatmap, and DTW distances against a bank — to a PNG (headless Agg
backend, no display needed).  CLI: ``python -m dsp_asr plot``.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from dsp_asr.config import PipelineConfig  # noqa: E402
from dsp_asr.golden import frontend as gfe  # noqa: E402
from dsp_asr.golden import vad as gvad  # noqa: E402


def plot_pipeline(x: np.ndarray, out_path: str,
                  cfg: PipelineConfig = PipelineConfig(),
                  recognizer=None, title: str = "") -> None:
    """Render the pipeline view of signal ``x`` to ``out_path`` (PNG)."""
    f = cfg.frontend
    x = np.asarray(x, dtype=np.float32)
    frames = gfe.frame_signal(x, f.frame_len, f.hop_len)
    e = gvad.short_time_energy(frames)
    z = gvad.zero_crossing_rate(frames)
    start, end, found = gvad.detect_endpoints(x, f, cfg.vad)

    n_rows = 4 if recognizer is not None else 3
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, 2.2 * n_rows))

    t_sig = np.arange(len(x)) / f.sample_rate
    axes[0].plot(t_sig, x, lw=0.4)
    if found:
        axes[0].axvspan(start * f.hop_len / f.sample_rate,
                        end * f.hop_len / f.sample_rate,
                        color="tab:green", alpha=0.2, label="VAD region")
        axes[0].legend(loc="upper right", fontsize=8)
    axes[0].set_title(title or "waveform")
    axes[0].set_xlabel("s")

    t_frm = np.arange(len(e)) * f.hop_len / f.sample_rate
    axes[1].semilogy(t_frm, np.maximum(e, 1e-10), label="energy")
    ax2 = axes[1].twinx()
    ax2.plot(t_frm, z, color="tab:orange", lw=0.7, label="ZCR")
    axes[1].set_title("short-time energy (log) / ZCR")
    axes[1].set_xlabel("s")

    from dsp_asr.golden.pipeline import extract_features
    feats, _ = extract_features(x, cfg)
    im = axes[2].imshow(feats.T, aspect="auto", origin="lower",
                        interpolation="nearest", cmap="magma")
    axes[2].set_title(f"features after VAD trim [{feats.shape[0]} x {feats.shape[1]}]")
    axes[2].set_xlabel("frame")
    fig.colorbar(im, ax=axes[2], fraction=0.025)

    if recognizer is not None:
        labels, dists = recognizer.classify_batch([x], return_distances=True)
        order = np.argsort(dists[0])
        names = [recognizer.labels[recognizer._bank_label_ids[i]] for i in order]
        axes[3].bar(range(len(order)), dists[0][order],
                    color=["tab:green" if n == labels[0] else "tab:blue"
                           for n in names])
        axes[3].set_xticks(range(len(order)))
        axes[3].set_xticklabels(names, rotation=45, fontsize=7)
        axes[3].set_title(f"DTW distance per template -> '{labels[0]}'")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
