"""Golden numpy LPC / LPCC front-end.

Linear-predictive features are the classical alternative to MFCC in
DSP-course recognizers (SURVEY.md §6 flags LPC as a possible reference
feature; implementing it closes that gap either way).  Chain:

    pre-emphasis -> framing -> Hamming -> autocorrelation (p+1 lags)
    -> Levinson-Durbin  => LPC a[1..p], gain E
    -> cepstral recursion => LPCC c[0..n-1]   (c[0] = ln E)

Conventions: prediction model x[n] ~ sum_k a[k] x[n-k]; autocorrelation
is raw (biased, unnormalised); the LPCC recursion follows Rabiner &
Juang eq. 3.91.
"""

from __future__ import annotations

import numpy as np

from dsp_asr.config import FrontendConfig
from dsp_asr.golden.frontend import frame_signal, hamming, preemphasis


def autocorrelation(frames: np.ndarray, order: int) -> np.ndarray:
    """Lags 0..order of each frame: [T, L] -> [T, order+1]."""
    t, length = frames.shape
    r = np.zeros((t, order + 1), dtype=np.float64)
    for k in range(order + 1):
        r[:, k] = np.sum(frames[:, : length - k] * frames[:, k:], axis=-1)
    return r


def levinson_durbin(r: np.ndarray, order: int):
    """Solve Toeplitz(r) a = r[1:] per frame.

    Args: r [T, order+1].  Returns (a [T, order] with a[k] ~ coefficient
    of x[n-k-1], gain E [T]).
    """
    t = r.shape[0]
    a = np.zeros((t, order), dtype=np.float64)
    e = r[:, 0].copy()
    e = np.where(e <= 0, 1e-10, e)
    for k in range(order):
        acc = r[:, k + 1].copy()
        for j in range(k):
            acc -= a[:, j] * r[:, k - j]
        lam = acc / e
        new_a = a.copy()
        new_a[:, k] = lam
        for j in range(k):
            new_a[:, j] = a[:, j] - lam * a[:, k - 1 - j]
        a = new_a
        e = e * (1.0 - lam * lam)
        e = np.where(e <= 0, 1e-10, e)
    return a, e


def lpcc_from_lpc(a: np.ndarray, gain: np.ndarray, n_ceps: int) -> np.ndarray:
    """LPC -> cepstra: c[0] = ln E; recursion for c[1..n_ceps-1]."""
    t, p = a.shape
    c = np.zeros((t, n_ceps), dtype=np.float64)
    c[:, 0] = np.log(np.maximum(gain, 1e-10))
    for n in range(1, n_ceps):
        acc = a[:, n - 1].copy() if n <= p else np.zeros(t)
        for k in range(1, n):
            if 0 <= n - k - 1 < p:
                acc += (k / n) * c[:, k] * a[:, n - k - 1]
        c[:, n] = acc
    return c


def lpcc(x: np.ndarray, cfg: FrontendConfig = FrontendConfig()) -> np.ndarray:
    """Signal [N] -> LPCC [T, n_mfcc] on the standard framing grid."""
    y = preemphasis(x, cfg.preemphasis)
    frames = frame_signal(y, cfg.frame_len, cfg.hop_len)
    wframes = frames * hamming(cfg.frame_len)[None, :]
    r = autocorrelation(wframes, cfg.lpc_order)
    a, e = levinson_durbin(r, cfg.lpc_order)
    return lpcc_from_lpc(a, e, cfg.n_mfcc)
