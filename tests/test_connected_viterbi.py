"""Level-synchronous connected Viterbi (ops/connected_viterbi.py).

Proof structure mirrors test_level_building.py: (1) the DP equals
exhaustive segmentation x word-assignment enumeration with per-span
loop-level Viterbi (forced last-state exit) on tiny problems, (2) the
shared backtrace recovers sequences through the MIN-convention bridge,
(3) the GMM-HMM recognizer decodes GAPLESS recordings the VAD splitter
cannot (the family-level capability this closes).
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dsp_asr.models.gmm_hmm import HmmParams, emission_logb, _lr_log_a
from dsp_asr.ops.connected_viterbi import NEG_INF, connected_viterbi
from dsp_asr.ops.level_building import backtrack

RNG = np.random.default_rng(21)


def _random_params(w, s, m, f, rng):
    log_pi = np.full((w, s), NEG_INF, np.float32)
    log_pi[:, 0] = 0.0
    log_a = np.stack([np.asarray(_lr_log_a(jnp.full((s,), 0.5), s))
                      for _ in range(w)])
    means = rng.standard_normal((w, s, m, f)).astype(np.float32)
    return HmmParams(
        log_pi=jnp.asarray(log_pi), log_a=jnp.asarray(log_a),
        means=jnp.asarray(means),
        log_var=jnp.zeros((w, s, m, f), jnp.float32),
        log_mix=jnp.full((w, s, m), -np.log(m), jnp.float32))


def _span_viterbi_lastexit(logb, log_pi, log_a):
    """Loop Viterbi over one span, path must END in the last state."""
    t, s = logb.shape
    delta = log_pi + logb[0]
    for i in range(1, t):
        delta = np.max(delta[:, None] + log_a, axis=0) + logb[i]
        delta = np.maximum(delta, NEG_INF)
    return float(delta[-1])


def _brute_connected_hmm(logb, log_pi, log_a, max_levels, penalty=0.0):
    """Exhaustive min over segmentations x word choices (max log-lik)."""
    t, w, _ = logb.shape
    best, best_seq = NEG_INF, []
    for n_words in range(1, max_levels + 1):
        for cuts in itertools.combinations(range(1, t), n_words - 1):
            bounds = (0,) + cuts + (t,)
            score, seq = 0.0, []
            for i in range(n_words):
                a, b = bounds[i], bounds[i + 1]
                spans = [_span_viterbi_lastexit(logb[a:b, v], log_pi[v],
                                                log_a[v]) for v in range(w)]
                v_best = int(np.argmax(spans))
                score += spans[v_best] - penalty
                seq.append(v_best)
            if score > best:
                best, best_seq = score, seq
    return best_seq, best


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("penalty", [0.0, 1.5])
def test_connected_viterbi_matches_brute(seed, penalty):
    rng = np.random.default_rng(seed)
    t, w, s, m, f = 7, 3, 3, 2, 2
    params = _random_params(w, s, m, f, rng)
    q = rng.standard_normal((1, t, f)).astype(np.float32)
    logb = np.asarray(emission_logb(jnp.asarray(q[0]), params))  # [T,W,S]

    scores, words, starts = connected_viterbi(
        jnp.asarray(q), jnp.asarray([t], jnp.int32), params,
        max_levels=3, word_penalty=penalty)
    want_seq, want = _brute_connected_hmm(
        logb, np.asarray(params.log_pi), np.asarray(params.log_a), 3,
        penalty)
    got = float(np.max(np.asarray(scores)[0, :, -1]))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-4)
    seq, cost = backtrack(-np.asarray(scores)[0], np.asarray(words)[0],
                          np.asarray(starts)[0], t)
    assert cost == pytest.approx(-want, rel=1e-5, abs=1e-4)
    assert seq == want_seq


def test_connected_viterbi_batched_consistent():
    """vmap consistency: a 2-recording batch equals two 1-recording runs."""
    rng = np.random.default_rng(9)
    t, w, s, m, f = 9, 2, 3, 2, 3
    params = _random_params(w, s, m, f, rng)
    q = rng.standard_normal((2, t, f)).astype(np.float32)
    lens = jnp.asarray([t, t], jnp.int32)
    sc2, w2, s2 = connected_viterbi(jnp.asarray(q), lens, params,
                                    max_levels=2)
    for b in range(2):
        sc1, w1, s1 = connected_viterbi(jnp.asarray(q[b:b + 1]),
                                        lens[b:b + 1], params, max_levels=2)
        np.testing.assert_allclose(np.asarray(sc1)[0], np.asarray(sc2)[b],
                                   rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(w1)[0], np.asarray(w2)[b])


def test_hmm_gapless_level_method_e2e():
    """The capability: GMM-HMM decodes a GAPLESS 3-word recording with
    method='level' where the VAD splitter under-segments."""
    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import make_corpus, synth_connected
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    cfg = PipelineConfig()
    labels = ["zero", "one", "two"]
    rec = GmmHmmRecognizer(cfg, HmmConfig(n_states=4, n_mix=2, n_iter=5))
    rec.fit(make_corpus(labels, n_per_word=3, seed=0))

    truth = ["two", "zero", "one"]
    gapless = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                              lead_ms=(50.0, 60.0))
    vad_out = rec.classify_connected([gapless], max_segments=4)[0]
    level_out = rec.classify_connected([gapless], max_segments=4,
                                       method="level")[0]
    assert len(vad_out) < len(truth)
    assert level_out == truth

    # gapped recordings keep decoding correctly through the same DP
    gapped = synth_connected(truth, seed=6)
    assert rec.classify_connected([gapped], max_segments=4,
                                  method="level")[0] == truth


def _brute_connected_hmm_grammar(logb, log_pi, log_a, start, pairs, end,
                                 max_levels, penalty=0.0):
    """Grammar-filtered exhaustive max: full K^n assignment product
    (the grammar couples consecutive words, so per-span argmax no
    longer applies)."""
    t, w, _ = logb.shape
    best, best_seq = NEG_INF, []
    for n_words in range(1, max_levels + 1):
        for cuts in itertools.combinations(range(1, t), n_words - 1):
            bounds = (0,) + cuts + (t,)
            spans = np.asarray(
                [[_span_viterbi_lastexit(logb[a:b, v], log_pi[v], log_a[v])
                  for v in range(w)]
                 for a, b in zip(bounds, bounds[1:])])
            for ids in itertools.product(range(w), repeat=n_words):
                if not (start[ids[0]] and end[ids[-1]]):
                    continue
                if any(not pairs[ids[i], ids[i + 1]]
                       for i in range(n_words - 1)):
                    continue
                score = sum(spans[i, v] for i, v in enumerate(ids)) \
                    - penalty * n_words
                if score > best:
                    best, best_seq = score, list(ids)
    return best_seq, best


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grammar_connected_viterbi_matches_brute(seed):
    from dsp_asr.ops.connected_viterbi import connected_viterbi_grammar
    from dsp_asr.ops.level_building import backtrack_grammar

    rng = np.random.default_rng(200 + seed)
    t, w, s, m, f = 6, 3, 3, 2, 2
    params = _random_params(w, s, m, f, rng)
    q = rng.standard_normal((1, t, f)).astype(np.float32)
    logb = np.asarray(emission_logb(jnp.asarray(q[0]), params))
    start = rng.random(w) < 0.7
    end = rng.random(w) < 0.7
    pairs = rng.random((w, w)) < 0.7
    start[int(rng.integers(w))] = True
    end[int(rng.integers(w))] = True

    scores, starts_p = connected_viterbi_grammar(
        jnp.asarray(q), jnp.asarray([t], jnp.int32), params,
        jnp.asarray(start), jnp.asarray(pairs), max_levels=3,
        word_penalty=0.5)
    got_seq, got_cost = backtrack_grammar(
        -np.asarray(scores)[0], np.asarray(starts_p)[0], pairs, end, t)
    want_seq, want = _brute_connected_hmm_grammar(
        logb, np.asarray(params.log_pi), np.asarray(params.log_a),
        start, pairs, end, 3, 0.5)
    if want <= NEG_INF / 2:
        assert got_seq == []
    else:
        assert got_cost == pytest.approx(-want, rel=1e-5, abs=1e-4)
        assert got_seq == want_seq


def test_grammar_loop_equals_unconstrained_viterbi():
    from dsp_asr.ops.connected_viterbi import connected_viterbi_grammar
    from dsp_asr.ops.level_building import backtrack_grammar

    rng = np.random.default_rng(77)
    t, w, s, m, f = 8, 3, 3, 2, 2
    params = _random_params(w, s, m, f, rng)
    q = rng.standard_normal((1, t, f)).astype(np.float32)
    lens = jnp.asarray([t], jnp.int32)
    ones, loop = np.ones(w, bool), np.ones((w, w), bool)
    sc_g, st_g = connected_viterbi_grammar(
        jnp.asarray(q), lens, params, jnp.asarray(ones),
        jnp.asarray(loop), max_levels=3)
    sc, wd, st = connected_viterbi(jnp.asarray(q), lens, params,
                                   max_levels=3)
    np.testing.assert_allclose(np.asarray(sc_g).max(-1), np.asarray(sc),
                               rtol=1e-6)
    seq_g, cost_g = backtrack_grammar(-np.asarray(sc_g)[0],
                                      np.asarray(st_g)[0], loop, ones, t)
    seq, cost = backtrack(-np.asarray(sc)[0], np.asarray(wd)[0],
                          np.asarray(st)[0], t)
    assert seq_g == seq and cost_g == pytest.approx(cost, rel=1e-6)


def test_hmm_grammar_e2e_reroute():
    """Model surface: a grammar that matches the truth is a no-op; one
    that forbids the true start forces a different grammatical decode."""
    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import make_corpus, synth_connected
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    cfg = PipelineConfig()
    labels = ["zero", "one", "two"]
    rec = GmmHmmRecognizer(cfg, HmmConfig(n_states=4, n_mix=2, n_iter=5))
    rec.fit(make_corpus(labels, n_per_word=3, seed=0))

    truth = ["two", "zero", "one"]
    gapless = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                              lead_ms=(50.0, 60.0))
    assert rec.classify_connected(
        [gapless], max_segments=4, method="level",
        grammar={"no_repeat": True})[0] == truth
    got = rec.classify_connected(
        [gapless], max_segments=4, method="level",
        grammar={"start": ["zero", "one"]})[0]
    assert got and got[0] != "two"
    with pytest.raises(ValueError, match="require method='level'"):
        rec.classify_connected([gapless], grammar={"no_repeat": True})


def test_hmm_level_method_rejects_unknown():
    from dsp_asr.config import PipelineConfig
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    rec = GmmHmmRecognizer(PipelineConfig())
    rec.labels, rec.params = ["x"], object()
    with pytest.raises(ValueError, match="unknown connected method"):
        rec.classify_connected([np.zeros(4000, np.float32)],
                               method="nope")
