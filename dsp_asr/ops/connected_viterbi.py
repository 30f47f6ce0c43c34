"""Level-synchronous connected-word Viterbi for the GMM-HMM family.

The statistical-family twin of ops/level_building.py: instead of
aligning query frames against stored templates, the joint DP threads
them through the word HMM network — word count, identities and
boundaries all come out of one dynamic program, so GAPLESS /
coarticulated recordings decode without the VAD splitter (which
``GmmHmmRecognizer.classify_connected(method="vad")`` still needs).
This is the classical connected-word HMM decoder (Rabiner & Juang
§8.4's level-building over HMMs) with the level axis kept explicit,
mirroring the template path's conventions exactly.

Semantics:
* entering word ``w`` at query frame ``t`` scores ``prev[t] -
  word_penalty + log_pi[w] + log_b[t, w, :]``;
* within a word, the usual Viterbi recursion through ``log_a[w]``;
* a word EXITS only from its LAST state (the left-to-right topology's
  terminal) — unlike the isolated scorer's max-over-states readout,
  boundaries must be committed at a definite model position;
* ``scores[l, t]`` = best joint log-lik of exactly ``l+1`` words
  consuming query frames ``0..t``.

Device mapping: emissions ``log_b [T, W, S]`` are the family's standard
GEMM Gaussian scorer (models/gmm_hmm.py:emission_logb — f32 matmul); each
level is a ``lax.scan`` over frames carrying the ``[W, S]`` Viterbi
front plus an int32 token plane (start-frame backpointers, identical
token passing to level_building); the level axis is an outer scan.

The MIN-convention bridge: callers negate the returned scores and feed
them straight to ``ops/level_building.backtrack`` — ``NEG_INF`` (-1e30)
maps onto BIG (1e30) exactly, so one backtrace serves both families
(pipeline.decode_level_generic).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = -1e30


@functools.partial(jax.jit, static_argnames=("max_levels",))
def connected_viterbi(q_feats: jax.Array, q_lens: jax.Array,
                      params, max_levels: int = 8,
                      word_penalty: jax.Array | float = 0.0):
    """Batched level-synchronous connected Viterbi.

    Args:
      q_feats: [B, T, F] whole-recording features (padding zeroed).
      q_lens:  [B] valid frame counts (readout only, like level_build).
      params:  stacked word HmmParams ([W, S] log_pi, [W, S, S] log_a,
               GMM emission params) — models/gmm_hmm.py:HmmParams.
      max_levels: static max word count L.
      word_penalty: subtracted once per word (>= 0 discourages
               over-segmentation; 0 = pure likelihood).

    Returns (scores [B, L, T], words [B, L, T] int32, starts [B, L, T]):
    entry [l, t] = best log-lik of l+1 words consuming frames 0..t, its
    last word, and the frames consumed before that word began.
    """
    from dsp_asr.models.gmm_hmm import emission_logb

    word_penalty = jnp.asarray(word_penalty, jnp.float32)
    log_pi, log_a = params.log_pi, params.log_a           # [W,S], [W,S,S]
    w, s = log_pi.shape

    def one(q, _qlen):
        logb = emission_logb(q, params)                   # [T, W, S]
        t_frames = logb.shape[0]

        def level(prev, _):
            entries = prev[:t_frames] - word_penalty      # [T]

            def step(carry, inp):
                delta, tok = carry                        # [W,S] f32/i32
                b_t, e_t, t = inp
                # within-word transition: max-plus through log_a
                trans = delta[:, :, None] + log_a         # [W, S', S]
                s_prev = jnp.argmax(trans, axis=1)        # [W, S]
                within = jnp.max(trans, axis=1)           # [W, S]
                tok_within = jnp.take_along_axis(tok, s_prev, axis=1)
                enter = e_t + log_pi                      # [W, S]
                take_enter = enter > within
                delta = jnp.where(take_enter, enter, within) + b_t
                # finite-NEG_INF discipline (mirror of level_building's
                # BIG clamp): stacked dead terms must not drift past f32
                delta = jnp.maximum(delta, NEG_INF)
                tok = jnp.where(take_enter, t, tok_within)
                ends = delta[:, s - 1]                    # exit = last state
                best_w = jnp.argmax(ends)
                out = (ends[best_w], best_w.astype(jnp.int32),
                       tok[best_w, s - 1])
                return (delta, tok), out

            init = (jnp.full((w, s), NEG_INF, jnp.float32),
                    jnp.zeros((w, s), jnp.int32))
            (_, _), (score_t, w_t, s_t) = jax.lax.scan(
                step, init,
                (logb, entries, jnp.arange(t_frames, dtype=jnp.int32)))
            nxt = jnp.concatenate([jnp.asarray([NEG_INF], jnp.float32),
                                   score_t])
            return nxt, (score_t, w_t, s_t)

        prev0 = jnp.full((t_frames + 1,), NEG_INF,
                         jnp.float32).at[0].set(0.0)
        _, (scores, words, starts) = jax.lax.scan(
            level, prev0, None, length=max_levels)
        return scores, words, starts

    return jax.vmap(one)(q_feats, q_lens)


@functools.partial(jax.jit, static_argnames=("max_levels",))
def connected_viterbi_grammar(q_feats: jax.Array, q_lens: jax.Array,
                              params, start_mask: jax.Array,
                              pair_mask: jax.Array, max_levels: int = 8,
                              word_penalty: jax.Array | float = 0.0):
    """Connected Viterbi under a finite-state word grammar.

    The HMM twin of ops/level_building.level_build_grammar: entry into
    word ``w`` is gated by which word ENDED the previous level
    (``pair_mask [W, W]``, ``start_mask [W]`` for level 0 — unit = word
    here, so the label-level grammar masks apply directly, no template
    expansion).  The per-frame front keeps the word axis — the best
    last word depends on its successor — so the returned planes are
    ``(scores [B, L, T, W], starts [B, L, T, W])``; callers negate the
    scores and read them back with level_building.backtrack_grammar
    (the usual NEG_INF -> BIG bridge; the ``end`` mask applies there).
    Masks are traced — editing the grammar never recompiles.
    """
    from dsp_asr.models.gmm_hmm import emission_logb

    word_penalty = jnp.asarray(word_penalty, jnp.float32)
    log_pi, log_a = params.log_pi, params.log_a           # [W,S], [W,S,S]
    w, s = log_pi.shape
    masks = jnp.concatenate(
        [jnp.broadcast_to(start_mask[None, None, :], (1, w, w)),
         jnp.broadcast_to(pair_mask[None], (max(max_levels - 1, 0), w, w))])

    def one(q, _qlen):
        logb = emission_logb(q, params)                   # [T, W, S]
        t_frames = logb.shape[0]

        def level(prev, mask):
            # prev: [T+1, W]; entry for word v at frame t = the best
            # ALLOWED predecessor's score (max-plus masked reduction)
            def step(carry, inp):
                delta, tok = carry                        # [W,S] f32/i32
                b_t, p_t, t = inp
                e_t = jnp.max(jnp.where(mask, p_t[:, None], NEG_INF),
                              axis=0)
                e_t = jnp.maximum(e_t - word_penalty, NEG_INF)  # [W]
                trans = delta[:, :, None] + log_a         # [W, S', S]
                s_prev = jnp.argmax(trans, axis=1)        # [W, S]
                within = jnp.max(trans, axis=1)
                tok_within = jnp.take_along_axis(tok, s_prev, axis=1)
                enter = e_t[:, None] + log_pi             # [W, S]
                take_enter = enter > within
                delta = jnp.maximum(
                    jnp.where(take_enter, enter, within) + b_t, NEG_INF)
                tok = jnp.where(take_enter, t, tok_within)
                return (delta, tok), (delta[:, s - 1], tok[:, s - 1])

            init = (jnp.full((w, s), NEG_INF, jnp.float32),
                    jnp.zeros((w, s), jnp.int32))
            (_, _), (score_tw, start_tw) = jax.lax.scan(
                step, init,
                (logb, prev[:t_frames],
                 jnp.arange(t_frames, dtype=jnp.int32)))
            nxt = jnp.concatenate(
                [jnp.full((1, w), NEG_INF, jnp.float32), score_tw])
            return nxt, (score_tw, start_tw)

        prev0 = jnp.full((t_frames + 1, w), NEG_INF,
                         jnp.float32).at[0].set(0.0)
        _, (scores, starts) = jax.lax.scan(level, prev0, masks)
        return scores, starts

    return jax.vmap(one)(q_feats, q_lens)
