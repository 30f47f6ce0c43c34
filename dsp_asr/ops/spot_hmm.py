"""HMM keyword spotting: open-endpoint Viterbi + UBM filler ratio.

The GMM-HMM family's analog of ops/spot.py (the classical
keyword/filler network, Rose & Paul 1990): each word HMM may enter at
any stream frame and exit at any later frame; candidate spans score by
the per-frame Viterbi log-likelihood RATIO against the universal
background GMM (models/gmm_hmm.py:fit_ubm) — the existing UBM doubles
as the filler model, so a `train-hmm --train-mode map` checkpoint
spots keywords with zero extra training.

Device mapping:

* emissions for ALL (frame, word, state) triples in one batched GEMM
  (models/gmm_hmm.py:emission_logb — the same matmul path scoring uses);
* the DP is frame-synchronous over the stream with a [W, S] carry and
  NO intra-frame dependency (left-right, no skips: every predecessor
  lives at frame j-1), so one `lax.scan` step is pure elementwise
  max-plus work — cheaper per frame than the DTW spotter's
  associative scan;
* entry-frame witnesses ride the argmax; the filler term is a prefix
  sum of per-frame UBM log-liks, subtracted per span at readout.

Scores are per-frame LLRs: > 0 means the word HMM explains the span
better than the background model.  Event extraction reuses
ops/spot.py:extract_events on the NEGATED field (it minimises).

Golden oracle: dsp_asr/golden/spot_hmm.py (tie order: fresh start >
stay > advance, matched here exactly).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsp_asr.models.gmm_hmm import NEG_INF, HmmParams, emission_logb, \
    gmm_loglik_flat


def spot_viterbi(logb: jax.Array, log_a: jax.Array):
    """Open-begin Viterbi over a stream for stacked word HMMs.

    logb [U, W, S] emission log-liks, log_a [W, S, S] left-right
    transitions.  Returns (v_last [W, U], start [W, U]): best-path
    log-lik ENDING at (frame j, last state) and its entry-frame
    witness.
    """
    u, w, s = logb.shape
    stay = jnp.diagonal(log_a, axis1=-2, axis2=-1)           # [W, S]
    adv = jnp.diagonal(log_a, offset=1, axis1=-2, axis2=-1)  # [W, S-1]
    ninf_col = jnp.full((w, 1), NEG_INF)

    def step(carry, inp):
        v, st = carry                                        # [W, S] each
        lb, j = inp                                          # [W, S], []
        stay_v = v + stay
        adv_v = jnp.concatenate([ninf_col, v[:, :-1] + adv], axis=1)
        # tie order stay > advance...
        m = jnp.maximum(stay_v, adv_v)
        sm = jnp.where(stay_v >= adv_v,
                       st, jnp.concatenate([st[:, :1], st[:, :-1]], axis=1))
        # ...and fresh start beats both on ties (golden order), state 0
        is0 = jnp.arange(s)[None, :] == 0
        fresh_wins = is0 & (0.0 >= m)
        m = jnp.where(fresh_wins, 0.0, m)
        sm = jnp.where(fresh_wins, j, sm)
        v_new = lb + m
        out = (v_new[:, -1], sm[:, -1])
        return (v_new, sm), out

    init = (jnp.full((w, s), NEG_INF) + 0.0 * logb[0],
            (0 * logb[0]).astype(jnp.int32))
    _, (v_last, starts) = jax.lax.scan(
        step, init, (logb, jnp.arange(u)))
    return v_last.T, starts.T                                # [W, U]


def _llr_readout(v_last, starts, ubm_ll, stream_len):
    """(v_last [W, U], starts [W, U], ubm_ll [U]) -> per-frame LLR."""
    u = v_last.shape[1]
    p = jnp.concatenate([jnp.zeros(1, ubm_ll.dtype),
                         jnp.cumsum(ubm_ll)])                # [U+1]
    j = jnp.arange(u)[None, :]
    span = (j - starts + 1).astype(v_last.dtype)
    ubm_span = p[j + 1] - jnp.take(p, starts)
    llr = (v_last - ubm_span) / span
    return jnp.where(j < stream_len, llr, NEG_INF)


def spot_hmm_impl(streams: jax.Array, stream_lens: jax.Array,
                  params: HmmParams, ubm):
    """Unjitted body (shared with any future mesh path).

    streams [B, U, F], params stacked [W, ...], ubm = (means [M, F],
    log_var [M, F], log_mix [M]).  Returns (llr [B, W, U], start
    [B, W, U]).
    """
    means, log_var, log_mix = ubm

    def one(stream, slen):
        logb = emission_logb(stream, params)                 # [U, W, S]
        # mask frames past the true length: NEG_INF emissions keep any
        # path through them unusable (readout masks them anyway)
        valid = (jnp.arange(stream.shape[0]) < slen)[:, None, None]
        logb = jnp.where(valid, logb, NEG_INF)
        ull = gmm_loglik_flat(stream, means, log_var)        # [U, M]
        ubm_ll = jax.nn.logsumexp(ull + log_mix, axis=-1)    # [U]
        v_last, starts = spot_viterbi(logb, params.log_a)
        return _llr_readout(v_last, starts, ubm_ll, slen), starts

    return jax.vmap(one)(streams, stream_lens)


@jax.jit
def spot_hmm_batch(streams: jax.Array, stream_lens: jax.Array,
                   params: HmmParams, ubm):
    """Spot every word HMM in every stream (see spot_hmm_impl)."""
    return spot_hmm_impl(streams, stream_lens, params, ubm)


# ---------------------------------------------------------------- streaming

class SpotHmmState(NamedTuple):
    """Frame-synchronous keyword/filler DP state (streaming form).

    The offline readout (:func:`_llr_readout`) looks the UBM prefix up
    at every path's entry frame; a stream cannot keep that prefix array
    unbounded, so each (word, state) path carries the prefix AT ITS OWN
    ENTRY alongside the witness — both ride the same argmax selections.

    v [W, S]      best path log-lik ending at each state, last frame.
    st [W, S]     entry-frame witness of that path.
    p_st [W, S]   UBM log-lik prefix at that path's entry frame.
    p []          running UBM prefix (sum over all fed frames).
    n_fed [] i32  stream frames consumed so far.
    """
    v: jax.Array
    st: jax.Array
    p_st: jax.Array
    p: jax.Array
    n_fed: jax.Array


def spot_hmm_init(n_words: int, n_states: int,
                  dtype=jnp.float32) -> SpotHmmState:
    return SpotHmmState(jnp.full((n_words, n_states), NEG_INF, dtype),
                        jnp.zeros((n_words, n_states), jnp.int32),
                        jnp.zeros((n_words, n_states), dtype),
                        jnp.zeros((), dtype), jnp.zeros((), jnp.int32))


@jax.jit
def spot_hmm_chunk(state: SpotHmmState, chunk: jax.Array,
                   n_valid: jax.Array, params: HmmParams, ubm):
    """Advance the keyword/filler DP by a chunk of feature frames.

    chunk [C, F] (first n_valid rows real).  Returns (state', llr
    [W, C], start [W, C]) — per-frame LLR fields matching the offline
    :func:`spot_hmm_batch` columns.  Exactness envelope (measured,
    tests/test_spot_hmm.py): the DP itself is chunk-BOUNDARY-invariant
    (same sequential recurrence either way), so a fixed chunk size is
    bit-exact vs any other tiling into the same shapes; across
    DIFFERENT chunk shapes the per-frame emission GEMMs may round
    differently (~1e-4 nats observed at C=1 vs C=57), and vs offline
    the `jnp.cumsum` UBM prefix associates differently from this scan's
    running sum — witnesses stay integer-exact in both cases, LLRs
    match to ~4e-4.
    """
    means, log_var, log_mix = ubm
    w, s = params.log_pi.shape
    logb = emission_logb(chunk, params)                      # [C, W, S]
    ull = gmm_loglik_flat(chunk, means, log_var)
    ubm_ll = jax.nn.logsumexp(ull + log_mix, axis=-1)        # [C]
    stay = jnp.diagonal(params.log_a, axis1=-2, axis2=-1)
    adv = jnp.diagonal(params.log_a, offset=1, axis1=-2, axis2=-1)
    ninf_col = jnp.full((w, 1), NEG_INF)
    c = chunk.shape[0]
    valid = jnp.arange(c) < n_valid

    def step(carry, inp):
        v, st, p_st, p, j = carry
        lb, u_ll, ok = inp                                   # [W,S],[],bool
        stay_v = v + stay
        adv_v = jnp.concatenate([ninf_col, v[:, :-1] + adv], axis=1)
        # tie order mirrors spot_viterbi exactly: stay > advance...
        take_stay = stay_v >= adv_v
        m = jnp.maximum(stay_v, adv_v)
        sm = jnp.where(take_stay, st,
                       jnp.concatenate([st[:, :1], st[:, :-1]], axis=1))
        pm = jnp.where(take_stay, p_st,
                       jnp.concatenate([p_st[:, :1], p_st[:, :-1]],
                                       axis=1))
        # ...and a fresh start (state 0) beats both on ties; its entry
        # prefix is the running sum BEFORE this frame
        is0 = jnp.arange(s)[None, :] == 0
        fresh = is0 & (0.0 >= m)
        m = jnp.where(fresh, 0.0, m)
        sm = jnp.where(fresh, j, sm)
        pm = jnp.where(fresh, p, pm)
        v_new = lb + m
        p_new = p + u_ll
        span = (j - sm[:, -1] + 1).astype(v.dtype)
        llr = (v_new[:, -1] - (p_new - pm[:, -1])) / span
        llr = jnp.where(ok, llr, NEG_INF)
        v = jnp.where(ok, v_new, v)
        st = jnp.where(ok, sm, st)
        p_st = jnp.where(ok, pm, p_st)
        p = jnp.where(ok, p_new, p)
        return (v, st, p_st, p, j + ok.astype(jnp.int32)), (llr, sm[:, -1])

    (v, st, p_st, p, n_fed), (llrs, starts) = jax.lax.scan(
        step, (state.v, state.st, state.p_st, state.p, state.n_fed),
        (logb, ubm_ll, valid))
    return (SpotHmmState(v, st, p_st, p, n_fed),
            jnp.moveaxis(llrs, 0, 1), jnp.moveaxis(starts, 0, 1))
