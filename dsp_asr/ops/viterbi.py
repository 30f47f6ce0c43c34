"""Batched log-space HMM lattice ops (Viterbi max-product + forward).

The reference's GMM-HMM decode path (SURVEY.md L3', BASELINE.json config
3) "ports as a batched log-space scan": the time recursion is a
`lax.scan`, and everything else — states, words, utterances — is batched
into the vector dimensions, so one scan decodes the whole vocabulary for
a whole batch at once ([B, W, S] log-alphas).

Variable-length sequences: frames at t >= length are skipped by carrying
the previous alpha through unchanged (mask on the scan step).
Exact-parity oracle: dsp_asr/golden/hmm.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def viterbi_score(log_pi: jax.Array, log_a: jax.Array, log_b: jax.Array,
                  length: jax.Array | None = None) -> jax.Array:
    """Best-path log-likelihood.

    Args:
      log_pi: [..., S] initial log-probs.
      log_a:  [..., S, S] transition log-probs (from -> to).
      log_b:  [T, ..., S] emission log-likelihoods, time-major.
      length: optional [...] valid frame counts.

    Leading ``...`` dims broadcast (batch utterances and/or word models).
    Returns [...] best log-likelihood.
    """
    t = log_b.shape[0]
    if length is None:
        length = jnp.asarray(t)
    delta0 = log_pi + log_b[0]

    def step(delta, inp):
        emit, ti = inp
        scores = jnp.max(delta[..., :, None] + log_a, axis=-2) + emit
        new = jnp.where((ti < length)[..., None], scores, delta)
        return new, None

    delta, _ = jax.lax.scan(step, delta0, (log_b[1:], jnp.arange(1, t)))
    return jnp.max(delta, axis=-1)


def viterbi_decode(log_pi: jax.Array, log_a: jax.Array, log_b: jax.Array,
                   length: jax.Array | None = None):
    """Best path + score for a single sequence (log_b [T, S]).

    Backtrace via scanned argmax pointers; used for state-level alignment
    in GMM-HMM training, not the hot decode path.  Frames at t >= length
    carry delta through unchanged with identity backpointers, so the
    returned path is valid on [0, length) and constant after.
    """
    t, s = log_b.shape
    if length is None:
        length = jnp.asarray(t)
    identity = jnp.arange(s)

    def fwd(delta, inp):
        emit, ti = inp
        scores = delta[:, None] + log_a
        psi = jnp.argmax(scores, axis=0)
        new = jnp.take_along_axis(scores, psi[None, :], axis=0)[0] + emit
        keep = ti < length
        return (jnp.where(keep, new, delta),
                jnp.where(keep, psi, identity))

    delta, psis = jax.lax.scan(fwd, log_pi + log_b[0],
                               (log_b[1:], jnp.arange(1, t)))
    last = jnp.argmax(delta)

    def back(state, psi):
        # reverse scan: processing psis[i] (the i -> i+1 transition) with
        # carry path[i+1] emits path[i] at output position i
        prev = psi[state]
        return prev, prev

    _, rev_path = jax.lax.scan(back, last, psis, reverse=True)
    path = jnp.concatenate([rev_path, last[None]])
    return jnp.max(delta), path


def forward_score(log_pi: jax.Array, log_a: jax.Array, log_b: jax.Array,
                  length: jax.Array | None = None) -> jax.Array:
    """Total log-likelihood (sum-product), same batching as viterbi_score."""
    t = log_b.shape[0]
    if length is None:
        length = jnp.asarray(t)
    alpha0 = log_pi + log_b[0]

    def step(alpha, inp):
        emit, ti = inp
        scores = jax.nn.logsumexp(alpha[..., :, None] + log_a, axis=-2) + emit
        new = jnp.where((ti < length)[..., None], scores, alpha)
        return new, None

    alpha, _ = jax.lax.scan(step, alpha0, (log_b[1:], jnp.arange(1, t)))
    return jax.nn.logsumexp(alpha, axis=-1)
