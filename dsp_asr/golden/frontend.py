"""Golden numpy MFCC front-end.

Implements the classical chain the reference provides (SURVEY.md §2a;
conventions follow Muda et al., arXiv:1003.4083 §B):

    pre-emphasis -> framing -> Hamming -> rFFT power -> mel filterbank
    -> log -> DCT-II -> lifter -> (optional energy) -> delta / delta-delta

All math is float64 numpy; this module is the float-tolerance oracle for
the JAX ops (dsp_asr/ops/frontend.py) and Pallas kernels
(dsp_asr/kernels/mfcc_pallas.py).
"""

from __future__ import annotations

import numpy as np

from dsp_asr.config import FrontendConfig


def preemphasis(x: np.ndarray, alpha: float = 0.97) -> np.ndarray:
    """y[n] = x[n] - alpha * x[n-1]; y[0] = x[0]."""
    x = np.asarray(x, dtype=np.float64)
    y = np.empty_like(x)
    y[0] = x[0]
    for n in range(1, len(x)):
        y[n] = x[n] - alpha * x[n - 1]
    return y


def frame_signal(x: np.ndarray, frame_len: int, hop_len: int) -> np.ndarray:
    """Slice x into overlapping frames [n_frames, frame_len].

    n_frames = 1 + floor((N - frame_len) / hop_len); the tail that does not
    fill a whole frame is dropped.  Signals shorter than one frame yield
    zero frames.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < frame_len:
        return np.zeros((0, frame_len), dtype=np.float64)
    n_frames = 1 + (n - frame_len) // hop_len
    out = np.zeros((n_frames, frame_len), dtype=np.float64)
    for t in range(n_frames):
        out[t] = x[t * hop_len : t * hop_len + frame_len]
    return out


def hamming(n: int) -> np.ndarray:
    """Symmetric Hamming window: 0.54 - 0.46 cos(2 pi k / (n-1))."""
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def power_spectrum(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """|rFFT(frame, n_fft)|^2 / n_fft   -> [n_frames, n_fft//2 + 1]."""
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return (spec.real**2 + spec.imag**2) / float(n_fft)


def spectral_subtract(pspec: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Berouti spectral subtraction over a power spectrogram [T, K].

    Noise PSD = mean PSD of the ``max(3, floor(n_valid*ss_frac))``
    lowest-energy frames with energy > 0, where n_valid counts the
    non-silent frames — digital-zero padding is excluded AND does not
    change k, so the estimate is padding-invariant.  Output is
    ``max(P - ss_alpha*N, ss_beta*P)``.  With no valid frames (all-zero
    input) the spectrogram is returned unchanged.
    """
    e = pspec.sum(axis=1)
    valid = e > 0.0
    n_valid = int(valid.sum())
    if n_valid == 0:
        return pspec.copy()
    k = max(3, int(n_valid * cfg.ss_frac))
    order = np.argsort(np.where(valid, e, np.inf), kind="stable")[:k]
    order = order[valid[order]]
    noise = pspec[order].mean(axis=0)
    return np.maximum(pspec - cfg.ss_alpha * noise[None, :],
                      cfg.ss_beta * pspec)


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """HTK-style triangular mel filterbank [n_mels, n_fft//2 + 1].

    Filter m rises linearly (in FFT-bin index) from bin point m to m+1 and
    falls to m+2, with the n_mels+2 bin points equally spaced on the mel
    scale between fmin and fmax and rounded down to FFT bins
    (floor((n_fft+1) * f / sr)).  Unnormalised (peak 1).
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(np.int64)
    fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        for k in range(left, center):
            if center > left:
                fb[m, k] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fb[m, k] = (right - k) / (right - center)
    return fb


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in] (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= np.sqrt(0.5)
    return mat


def lifter_coeffs(n_mfcc: int, lifter: int) -> np.ndarray:
    """Sinusoidal liftering weights: 1 + (L/2) sin(pi k / L)."""
    if lifter <= 0:
        return np.ones(n_mfcc, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    return 1.0 + (lifter / 2.0) * np.sin(np.pi * k / lifter)


def mfcc(x: np.ndarray, cfg: FrontendConfig = FrontendConfig()) -> np.ndarray:
    """Full MFCC chain: signal [N] -> coefficients [n_frames, n_mfcc]."""
    y = preemphasis(x, cfg.preemphasis)
    frames = frame_signal(y, cfg.frame_len, cfg.hop_len)
    win = hamming(cfg.frame_len)
    wframes = frames * win[None, :]
    pspec = power_spectrum(wframes, cfg.n_fft)
    if cfg.denoise == "spectral_subtraction":
        pspec = spectral_subtract(pspec, cfg)
    fb = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, cfg.fmax_hz)
    mel_energy = pspec @ fb.T
    log_mel = np.log(np.maximum(mel_energy, cfg.log_floor))
    dct = dct_matrix(cfg.n_mfcc, cfg.n_mels)
    ceps = log_mel @ dct.T
    ceps = ceps * lifter_coeffs(cfg.n_mfcc, cfg.lifter)[None, :]
    if cfg.use_energy:
        frame_e = np.sum(frames * frames, axis=-1)
        ceps[:, 0] = np.log(np.maximum(frame_e, cfg.log_floor))
    return ceps


def deltas(feats: np.ndarray, width: int = 2) -> np.ndarray:
    """Regression deltas over +/-width frames with edge replication.

    d[t] = sum_{n=1..W} n * (c[t+n] - c[t-n]) / (2 * sum_{n=1..W} n^2)
    """
    t_len = feats.shape[0]
    denom = 2.0 * sum(n * n for n in range(1, width + 1))
    out = np.zeros_like(feats)
    for t in range(t_len):
        acc = np.zeros(feats.shape[1], dtype=np.float64)
        for n in range(1, width + 1):
            hi = min(t + n, t_len - 1)
            lo = max(t - n, 0)
            acc += n * (feats[hi] - feats[lo])
        out[t] = acc / denom
    return out


def causal_cmn(feats: np.ndarray, alpha: float) -> np.ndarray:
    """Loop spec of ops/frontend.causal_cmn (cmn_mode="causal"):
    per-frame subtraction of the bias-corrected exponential running mean

        num_t = alpha * num_{t-1} + (1 - alpha) * c_t
        out_t = c_t - num_t / (1 - alpha^(t+1))
    """
    out = np.zeros_like(feats)
    num = np.zeros(feats.shape[-1], dtype=np.float64)
    for t in range(feats.shape[0]):
        num = alpha * num + (1.0 - alpha) * feats[t].astype(np.float64)
        out[t] = feats[t] - num / (1.0 - alpha ** (t + 1))
    return out


def mfcc_with_deltas(x: np.ndarray, cfg: FrontendConfig = FrontendConfig()) -> np.ndarray:
    """MFCC plus delta and delta-delta, stacked -> [n_frames, 3*n_mfcc]."""
    c = mfcc(x, cfg)
    if not cfg.add_deltas:
        return c
    d1 = deltas(c, cfg.delta_width)
    d2 = deltas(d1, cfg.delta_width)
    return np.concatenate([c, d1, d2], axis=-1)
