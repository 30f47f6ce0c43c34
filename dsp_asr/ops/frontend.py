"""MFCC front-end ops (JAX).

Design (SURVEY.md §1b N2/N3; MelT "GEMM-native NDFT", PAPERS.md): the whole
front-end chain is expressed as a fusion of elementwise ops and **matrix
multiplies** so it maps onto the matrix units:

    frames --(window)--> [*, L]
      @ DFT_cos / DFT_sin [L, K]      (rFFT as two matmuls; zero-padding to
                                       NFFT is implicit because the padded
                                       tail multiplies zero rows)
      square+add -> power [*, K]
      @ mel_fb [K, M] -> log -> @ DCT [M, C] -> lifter

All constant matrices are generated by the golden oracle
(dsp_asr/golden/frontend.py) so both implementations share one source of
truth for the DSP conventions.  An exact `jnp.fft.rfft` path is kept for
parity testing; the matmul path is the production path.

Everything is statically shaped; variable utterance length is handled by
frame masks and by the length-clamped delta gather (`masked_deltas`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr.config import FrontendConfig
from dsp_asr.golden import frontend as gold


class FrontendMatrices(NamedTuple):
    """Constant matrices of the front-end, device-resident, float32."""

    window: jax.Array     # [L]
    dft_cos: jax.Array    # [L, K]  cos(2 pi k n / NFFT)
    dft_sin: jax.Array    # [L, K]  -sin(2 pi k n / NFFT)
    mel_fb_t: jax.Array   # [K, M]
    dct_t: jax.Array      # [M, C]
    lifter: jax.Array     # [C]


@functools.lru_cache(maxsize=8)
def _matrices_np(cfg: FrontendConfig):
    length, k = cfg.frame_len, cfg.n_bins
    n = np.arange(length, dtype=np.float64)[:, None]
    kk = np.arange(k, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * kk / cfg.n_fft
    return (
        gold.hamming(length),
        np.cos(ang),
        -np.sin(ang),
        gold.mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                            cfg.fmin, cfg.fmax_hz).T,
        gold.dct_matrix(cfg.n_mfcc, cfg.n_mels).T,
        gold.lifter_coeffs(cfg.n_mfcc, cfg.lifter),
    )


def make_matrices(cfg: FrontendConfig = FrontendConfig(),
                  dtype=jnp.float32) -> FrontendMatrices:
    return FrontendMatrices(*(jnp.asarray(m, dtype=dtype) for m in _matrices_np(cfg)))


def preemphasis(x: jax.Array, alpha: float = 0.97) -> jax.Array:
    """y[n] = x[n] - alpha x[n-1], y[0] = x[0]; any leading batch dims."""
    shifted = jnp.pad(x[..., :-1], [(0, 0)] * (x.ndim - 1) + [(1, 0)])
    return x - alpha * shifted


def frame(x: jax.Array, frame_len: int, hop_len: int) -> jax.Array:
    """[..., N] -> [..., T, frame_len] with T = 1 + (N - frame_len)//hop."""
    n = x.shape[-1]
    if n < frame_len:
        raise ValueError(f"signal ({n}) shorter than one frame ({frame_len})")
    t = 1 + (n - frame_len) // hop_len
    idx = (np.arange(t)[:, None] * hop_len + np.arange(frame_len)[None, :]).reshape(-1)
    out = jnp.take(x, jnp.asarray(idx), axis=-1)
    return out.reshape(*x.shape[:-1], t, frame_len)


def power_spectrum_fft(wframes: jax.Array, n_fft: int) -> jax.Array:
    """Exact rFFT power spectrum (parity path)."""
    spec = jnp.fft.rfft(wframes, n=n_fft, axis=-1)
    return (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) / float(n_fft)


def power_spectrum_dft(wframes: jax.Array, mats: FrontendMatrices, n_fft: int,
                       precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """rFFT power as two matmuls (MelT GEMM-native NDFT)."""
    re = jnp.matmul(wframes, mats.dft_cos, precision=precision)
    im = jnp.matmul(wframes, mats.dft_sin, precision=precision)
    return (re * re + im * im) / float(n_fft)


def spectral_subtract(pspec: jax.Array, cfg: FrontendConfig) -> jax.Array:
    """Berouti spectral subtraction on [..., T, K] power spectrograms.

    Vectorized mirror of golden/frontend.py:spectral_subtract: noise PSD
    is the masked mean over the k lowest-energy frames with energy > 0
    (zero-padding frames rank +inf and are mask-excluded), then
    ``max(P - ss_alpha*N, ss_beta*P)``.  All-silent input is a no-op.
    """
    e = jnp.sum(pspec, axis=-1)                              # [..., T]
    valid = e > 0.0
    # k scales with the VALID frame count (not the static shape), so the
    # estimate is invariant under digital-zero padding
    n_valid = jnp.sum(valid, axis=-1, keepdims=True)         # [..., 1]
    k_dyn = jnp.maximum(
        3, (n_valid.astype(jnp.float32) * cfg.ss_frac).astype(jnp.int32))
    order = jnp.argsort(jnp.where(valid, e, jnp.inf), axis=-1)
    rank = jnp.argsort(order, axis=-1)                       # [..., T]
    pick = ((rank < k_dyn) & valid).astype(pspec.dtype)      # [..., T]
    cnt = jnp.sum(pick, axis=-1)[..., None]
    noise = (jnp.sum(pspec * pick[..., None], axis=-2)
             / jnp.maximum(cnt, 1.0))                        # [..., K]
    sub = pspec - jnp.asarray(cfg.ss_alpha, pspec.dtype) * noise[..., None, :]
    return jnp.maximum(sub, jnp.asarray(cfg.ss_beta, pspec.dtype) * pspec)


def mfcc_from_pspec(pspec: jax.Array, frames_: jax.Array,
                    mats: FrontendMatrices,
                    cfg: FrontendConfig = FrontendConfig(),
                    precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Power spectrogram [..., T, K] (+ raw frames for the energy
    coefficient) -> MFCC [..., T, C].  The mel→log→DCT tail of
    ``mfcc_from_frames``, split out so callers that denoise the power
    spectrum themselves (the streaming front-end's causal cross-chunk
    estimate, ops/streaming.py) share one cepstrum definition."""
    mel_e = jnp.matmul(pspec, mats.mel_fb_t, precision=precision)
    log_mel = jnp.log(jnp.maximum(mel_e, cfg.log_floor))
    ceps = jnp.matmul(log_mel, mats.dct_t, precision=precision) * mats.lifter
    if cfg.use_energy:
        frame_e = jnp.sum(frames_ * frames_, axis=-1)
        c0 = jnp.log(jnp.maximum(frame_e, cfg.log_floor))
        ceps = ceps.at[..., 0].set(c0)
    return ceps


def mfcc_from_frames(frames_: jax.Array, mats: FrontendMatrices,
                     cfg: FrontendConfig = FrontendConfig(),
                     use_fft: bool = False,
                     precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Frames of the pre-emphasised signal [..., T, L] -> MFCC [..., T, C]."""
    wframes = frames_ * mats.window
    if use_fft:
        pspec = power_spectrum_fft(wframes, cfg.n_fft)
    else:
        pspec = power_spectrum_dft(wframes, mats, cfg.n_fft, precision)
    if cfg.denoise == "spectral_subtraction":
        pspec = spectral_subtract(pspec, cfg)
    elif cfg.denoise is not None:
        raise ValueError(f"unknown FrontendConfig.denoise {cfg.denoise!r}")
    return mfcc_from_pspec(pspec, frames_, mats, cfg, precision)


def mfcc(x: jax.Array, cfg: FrontendConfig = FrontendConfig(),
         mats: FrontendMatrices | None = None, use_fft: bool = False,
         precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Signal [..., N] -> MFCC [..., T, n_mfcc]."""
    if mats is None:
        mats = make_matrices(cfg)
    y = preemphasis(x, cfg.preemphasis)
    frames_ = frame(y, cfg.frame_len, cfg.hop_len)
    return mfcc_from_frames(frames_, mats, cfg, use_fft, precision)


def deltas(feats: jax.Array, width: int = 2) -> jax.Array:
    """Regression deltas with edge replication (static length)."""
    t = feats.shape[-2]
    denom = 2.0 * sum(n * n for n in range(1, width + 1))
    acc = jnp.zeros_like(feats)
    idx = np.arange(t)
    for n in range(1, width + 1):
        hi = jnp.asarray(np.minimum(idx + n, t - 1))
        lo = jnp.asarray(np.maximum(idx - n, 0))
        acc = acc + n * (jnp.take(feats, hi, axis=-2) - jnp.take(feats, lo, axis=-2))
    return acc / denom


def masked_deltas(feats: jax.Array, length: jax.Array, width: int = 2) -> jax.Array:
    """Deltas where the replicated edge is the *true* last frame.

    ``length`` is the (traced) number of valid frames; gather indices are
    clamped to [0, length-1] so padded garbage frames never leak into the
    deltas of valid frames (padding-invariance, SURVEY.md §4.6).
    """
    t = feats.shape[-2]
    denom = 2.0 * sum(n * n for n in range(1, width + 1))
    idx = jnp.arange(t)
    hi_cap = jnp.maximum(length - 1, 0)
    acc = jnp.zeros_like(feats)
    for n in range(1, width + 1):
        hi = jnp.clip(idx + n, 0, hi_cap)
        lo = jnp.clip(idx - n, 0, hi_cap)
        acc = acc + n * (jnp.take(feats, hi, axis=-2) - jnp.take(feats, lo, axis=-2))
    return acc / denom


def causal_cmn(feats: jax.Array, alpha: float) -> jax.Array:
    """Causal cepstral mean subtraction (FrontendConfig.cmn_mode="causal").

    Bias-corrected exponential running mean over the time axis (-2):

        num_t = alpha * num_{t-1} + (1 - alpha) * c_t,   num_{-1} = 0
        m_t   = num_t / (1 - alpha^(t+1))                 (bias correction)
        out_t = c_t - m_t

    PREFIX-STABLE: out_t depends only on c_{0..t}, so a frame's
    normalized value never changes as more audio arrives — the property
    the online DPs need (models/streaming.py, the utterance-mean mode
    cannot provide it).  On a stationary channel m_t converges to the
    channel mean, i.e. toward what cmn_mode="utterance" subtracts.

    The first-order recurrence runs as a ``jax.lax.associative_scan``
    over affine maps (a, b) ∘ composition — log-depth, no
    sequential scan.  Padded rows are harmless: row t only sees rows
    <= t, and callers mask the tail afterwards (pipeline._finalize_window).
    """
    a = jnp.asarray(alpha, feats.dtype)
    t = feats.shape[-2]
    coeff = jnp.broadcast_to(a, feats.shape[:-1] + (1,))

    def combine(left, right):
        al, bl = left
        ar, br = right
        return al * ar, bl * ar + br

    _, num = jax.lax.associative_scan(
        combine, (coeff, (1.0 - a) * feats), axis=-2)
    steps = jnp.arange(1, t + 1, dtype=feats.dtype)
    bias = 1.0 - jnp.power(a, steps)[..., :, None]
    return feats - num / bias


def time_normalize(feats: jax.Array, length: jax.Array,
                   target_len: int) -> jax.Array:
    """Linear time normalization: [..., T, F] + true length -> [..., L, F].

    The classical pre-DTW matcher resamples every utterance to a fixed
    frame count so templates compare frame-by-frame (linear time warping);
    it also makes every pair equal-length, the precondition for exact
    static banding.  Fractional positions use linear interpolation
    (matches numpy.interp on the grid p = linspace(0, length-1, L)).
    """
    t = feats.shape[-2]
    pos = (jnp.arange(target_len, dtype=jnp.float32)
           * (jnp.maximum(length - 1, 0).astype(jnp.float32)
              / max(target_len - 1, 1)))
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, t - 1)
    hi = jnp.clip(lo + 1, 0, t - 1)
    frac = (pos - lo.astype(jnp.float32))[..., None]
    f_lo = jnp.take(feats, lo, axis=-2)
    f_hi = jnp.take(feats, hi, axis=-2)
    return f_lo + frac * (f_hi - f_lo)


def add_deltas(feats: jax.Array, cfg: FrontendConfig,
               length: jax.Array | None = None) -> jax.Array:
    """Stack [c, delta, delta-delta] -> [..., T, 3*n_mfcc]."""
    if not cfg.add_deltas:
        return feats
    if length is None:
        d1 = deltas(feats, cfg.delta_width)
        d2 = deltas(d1, cfg.delta_width)
    else:
        d1 = masked_deltas(feats, length, cfg.delta_width)
        d2 = masked_deltas(d1, length, cfg.delta_width)
    return jnp.concatenate([feats, d1, d2], axis=-1)
