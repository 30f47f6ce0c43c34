"""Automatic noise-mismatch compensation for the GMM-HMM family.

The connected-WER matrix (docs/RESULTS.md) shows the GMM-HMM collapsing
under additive-noise mismatch (WER 0.804 at sigma=0.05) while template
matchers survive; the measured remedy was a MANUAL in-noise refit
(``--train-noise``).  This module automates it with the classical
log-add Parallel Model Combination of Gales & Young (1993): estimate
the test-time noise floor from the frames the VAD REJECTED (exactly the
data the detector already computes and throws away), map every Gaussian
mean back to the log-mel domain, add the noise power, and map forward —
no labels, no retraining data, one pass (VERDICT r3 #5).

Pipeline-exact inversion: MFCC = lifter * DCT(log(mel_power))
(ops/frontend.py:mfcc_from_pspec, natural log).  The static mean is
un-liftered, lifted back to log-mel through the truncated-DCT
pseudo-inverse (the standard smooth PMC approximation; D @ pinv(D) = I
on the 13 kept coefficients, so ZERO noise reproduces the means
exactly), combined as ``log(exp(m) + g * exp(n))``, and re-projected.
Delta/delta-delta blocks are left untouched: the noise estimate is
stationary by construction, and stationary noise has (approximately)
zero cepstral deltas — the standard simple-PMC treatment, like keeping
the variances.

Assumes the default front end: ``use_energy=False`` (c0 is a DCT
coefficient, so it participates in the inversion) and ``cmn=False``
(CMN already removes stationary offsets; combining both is neither
needed nor modeled).  Callers gate on these.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr.config import FrontendConfig, VadConfig
from dsp_asr.ops import frontend as fe
from dsp_asr.ops import vad as jvad


@functools.partial(jax.jit, static_argnames=("cfg", "vad_cfg", "precision"))
def estimate_noise_cepstrum(signals: jax.Array, n_samples: jax.Array,
                            mats: fe.FrontendMatrices,
                            cfg: FrontendConfig = FrontendConfig(),
                            vad_cfg: VadConfig = VadConfig(),
                            precision=jax.lax.Precision.HIGHEST):
    """Batch [B, N] -> (mean STATIC cepstrum [C] of VAD-rejected frames,
    rejected-frame count).

    Pools every valid frame outside the detected speech window across
    the whole batch (leading/trailing silence).  When a batch has NO
    rejected frames (speech wall-to-wall), falls back to the lowest-
    energy ``ss_frac`` of valid frames per signal — the same floor rule
    the spectral-subtraction denoiser uses for its PSD estimate.
    """

    def one(x, n):
        c = fe.mfcc(x, cfg, mats, use_fft=False, precision=precision)
        t_rec = c.shape[0]
        n_frames = jnp.maximum(0, 1 + (n - cfg.frame_len) // cfg.hop_len)
        start, end, _ = jvad.detect_endpoints(x, cfg, vad_cfg, n)
        idx = jnp.arange(t_rec)
        valid = idx < n_frames
        rejected = valid & ((idx < start) | (idx >= end))
        # energy-rank fallback picks (the denoiser's floor rule); raw
        # frames like the VAD grid
        frames_ = fe.frame(x, cfg.frame_len, cfg.hop_len)
        e = jnp.sum(frames_ * frames_, axis=-1)
        k_dyn = jnp.maximum(3, (jnp.sum(valid).astype(jnp.float32)
                                * cfg.ss_frac).astype(jnp.int32))
        order = jnp.argsort(jnp.where(valid, e, jnp.inf))
        rank = jnp.argsort(order)
        low_e = (rank < k_dyn) & valid
        return c, rejected, low_e

    c, rejected, low_e = jax.vmap(one)(signals, n_samples)    # [B,T,C] ...
    n_rej = jnp.sum(rejected)
    pick = jnp.where(n_rej > 0, rejected, low_e).astype(c.dtype)[..., None]
    mean = (jnp.sum(c * pick, axis=(0, 1))
            / jnp.maximum(jnp.sum(pick), 1.0))                # [C]
    return mean, n_rej


@functools.partial(jax.jit, static_argnames=("cfg", "n_static"))
def pmc_adapt_means(means: jax.Array, noise_ceps: jax.Array,
                    mats: fe.FrontendMatrices,
                    cfg: FrontendConfig = FrontendConfig(),
                    gain: jax.Array | float = 1.0,
                    n_static: int | None = None) -> jax.Array:
    """Log-add PMC on Gaussian means [..., F] -> adapted means.

    Only the first ``n_static`` (default ``cfg.n_mfcc``) coefficients —
    the static cepstral block — are compensated; delta blocks pass
    through (module docstring).  ``gain`` scales the estimated noise
    power (1.0 = trust the estimate).
    """
    n_static = cfg.n_mfcc if n_static is None else n_static
    static = means[..., :n_static]                            # [..., C]
    lifter = mats.lifter                                      # [C]
    d = mats.dct_t.T                                          # [C, M]
    d_pinv = jnp.linalg.pinv(d)                               # [M, C]

    def to_logmel(ceps):
        return jnp.matmul(ceps / lifter, d_pinv.T)            # [..., M]

    noise_logmel = to_logmel(noise_ceps)                      # [M]
    m = to_logmel(static)                                     # [..., M]
    gain = jnp.asarray(gain, m.dtype)
    # log-add in the mel-power domain, floored like the forward path
    combined = jnp.log(jnp.maximum(jnp.exp(m) + gain * jnp.exp(noise_logmel),
                                   cfg.log_floor))
    adapted = jnp.matmul(combined, d.T) * lifter              # [..., C]
    return jnp.concatenate([adapted, means[..., n_static:]], axis=-1)


def pmc_supported(cfg: FrontendConfig) -> str | None:
    """None when PMC applies to this front end; else the reason it can't."""
    if cfg.feature_type != "mfcc":
        return "PMC inverts the MFCC chain (feature_type='mfcc' only)"
    if cfg.use_energy:
        return "use_energy replaces c0 — the cepstral inversion breaks"
    if cfg.cmn:
        return ("cmn already removes stationary offsets; PMC on CMN'd "
                "means is not modeled")
    return None
