"""LPC / LPCC front-end ops (JAX).

The per-frame Levinson-Durbin recursion is sequential in the *order*
dimension only (p ~ 12 steps); each step is fully vectorized over all
frames of the batch, so the scan carry is [n_frames, p] and the whole
batch solves in p scan iterations.  The LPCC cepstral recursion is the
same shape (n_ceps steps).  Autocorrelation is p+1 fused shift-multiply
reductions (p is tiny; no FFT needed at these sizes).

Oracle: dsp_asr/golden/lpc.py (loop implementation, itself checked
against a direct Toeplitz solve in tests/test_lpc.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dsp_asr.config import FrontendConfig
from dsp_asr.ops import frontend as fe


def autocorrelation(frames: jax.Array, order: int) -> jax.Array:
    """[..., L] -> [..., order+1] raw autocorrelation lags."""
    length = frames.shape[-1]
    cols = [jnp.sum(frames[..., : length - k] * frames[..., k:], axis=-1)
            for k in range(order + 1)]
    return jnp.stack(cols, axis=-1)


def levinson_durbin(r: jax.Array, order: int):
    """Batched Levinson-Durbin: r [..., order+1] -> (a [..., order], E [...])."""
    lead = r.shape[:-1]
    a0 = jnp.zeros((*lead, order), r.dtype)
    e0 = jnp.maximum(r[..., 0], 1e-10)
    idx = jnp.arange(order)

    def step(carry, k):
        a, e = carry
        # acc = r[k+1] - sum_{j<k} a[j] r[k-j]
        r_rev = jnp.take(r, jnp.clip(k - idx, 0, order), axis=-1)  # r[k-j]
        mask = (idx < k).astype(r.dtype)
        acc = jnp.take(r, k + 1, axis=-1) - jnp.sum(a * r_rev * mask, axis=-1)
        lam = acc / e
        # a[j] <- a[j] - lam * a[k-1-j]  (j < k);  a[k] <- lam
        a_rev = jnp.take(a, jnp.clip(k - 1 - idx, 0, order - 1), axis=-1)
        new_a = a - lam[..., None] * a_rev * mask
        new_a = jnp.where(idx == k, lam[..., None], new_a)
        new_e = jnp.maximum(e * (1.0 - lam * lam), 1e-10)
        return (new_a, new_e), None

    (a, e), _ = jax.lax.scan(step, (a0, e0), jnp.arange(order))
    return a, e


def lpcc_from_lpc(a: jax.Array, gain: jax.Array, n_ceps: int) -> jax.Array:
    """LPC coefficients -> cepstra [..., n_ceps] (c[0] = ln E)."""
    lead = a.shape[:-1]
    p = a.shape[-1]
    a_pad = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, max(0, n_ceps - p))])
    c0 = jnp.zeros((*lead, n_ceps), a.dtype)
    c0 = c0.at[..., 0].set(jnp.log(jnp.maximum(gain, 1e-10)))
    ks = jnp.arange(n_ceps, dtype=a.dtype)
    kidx = jnp.arange(n_ceps)

    def step(c, n):
        # c[n] = a[n-1] + sum_{k=1..n-1} (k/n) c[k] a[n-k-1]
        a_n = jnp.take(a_pad, jnp.clip(n - 1, 0, n_ceps - 1), axis=-1)
        a_shift = jnp.take(a_pad, jnp.clip(n - kidx - 1, 0, n_ceps - 1), axis=-1)
        mask = ((kidx >= 1) & (kidx < n) & (n - kidx - 1 >= 0)
                & (n - kidx - 1 < p)).astype(a.dtype)
        term = jnp.sum((ks / n.astype(a.dtype)) * c * a_shift * mask, axis=-1)
        val = jnp.where(n - 1 < p, a_n, 0.0) + term
        c = jnp.where(kidx == n, val[..., None], c)
        return c, None

    c, _ = jax.lax.scan(step, c0, jnp.arange(1, n_ceps))
    return c


def lpcc_from_frames(frames: jax.Array, cfg: FrontendConfig) -> jax.Array:
    """Windowed pre-emphasised frames [..., T, L] -> LPCC [..., T, n_mfcc]."""
    win = jnp.asarray(fe.make_matrices(cfg).window)
    wframes = frames * win
    r = autocorrelation(wframes, cfg.lpc_order)
    a, e = levinson_durbin(r, cfg.lpc_order)
    return lpcc_from_lpc(a, e, cfg.n_mfcc)


def lpcc(x: jax.Array, cfg: FrontendConfig = FrontendConfig()) -> jax.Array:
    """Signal [..., N] -> LPCC [..., T, n_mfcc]."""
    if cfg.denoise is not None:
        raise ValueError("FrontendConfig.denoise is a power-spectrum "
                         "operation; feature_type='lpcc' does not support "
                         "it (LPC analyses the time-domain frames)")
    y = fe.preemphasis(x, cfg.preemphasis)
    frames = fe.frame(y, cfg.frame_len, cfg.hop_len)
    return lpcc_from_frames(frames, cfg)
