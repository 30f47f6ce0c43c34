"""Level-building connected decode (ops/level_building.py).

Three-layer proof: (1) the golden loop-level DP equals exhaustive
segmentation x assignment enumeration on tiny problems, (2) the jax
scan-of-scans equals the golden DP bit-for-bit-ish on random ragged
banks, (3) backtrack recovers the true word sequence on synthetic
GAPLESS recordings where the VAD splitter cannot (the capability this
module exists for — VERDICT r3 #4).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.golden import level_building as gl
from dsp_asr.ops import level_building as lb

RNG = np.random.default_rng(11)


def _ragged_bank(k, u_max, f, rng):
    lens = rng.integers(3, u_max + 1, size=k)
    templates = [rng.standard_normal((int(u), f)).astype(np.float32)
                 for u in lens]
    padded = np.zeros((k, u_max, f), np.float32)
    for v, tm in enumerate(templates):
        padded[v, : len(tm)] = tm
    return templates, padded, lens.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("penalty", [0.0, 0.7])
def test_golden_dp_matches_brute_enumeration(seed, penalty):
    rng = np.random.default_rng(seed)
    t, f, k = 8, 2, 3
    q = rng.standard_normal((t, f)).astype(np.float32)
    templates, _, _ = _ragged_bank(k, 4, f, rng)
    max_l = 3
    costs, words, starts = gl.level_build_ref(q, templates, max_l, penalty)
    want_seq, want_cost = gl.brute_connected(q, templates, max_l, penalty)
    final = costs[:, -1] + 0.0   # cost of l+1 words consuming ALL frames
    got_cost = float(np.min(final))
    assert got_cost == pytest.approx(want_cost, rel=1e-6)
    got_seq, bt_cost = lb.backtrack(costs, words, starts, t)
    assert bt_cost == pytest.approx(want_cost, rel=1e-6)
    assert got_seq == want_seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jax_level_build_matches_golden(seed):
    rng = np.random.default_rng(100 + seed)
    t, f, k, u_max, max_l = 12, 3, 4, 6, 4
    q = rng.standard_normal((2, t, f)).astype(np.float32)
    templates, padded, lens = _ragged_bank(k, u_max, f, rng)
    costs, words, starts = lb.level_build(
        jnp.asarray(q), jnp.asarray([t, t], jnp.int32),
        jnp.asarray(padded), jnp.asarray(lens), max_levels=max_l,
        word_penalty=0.3)
    for b in range(2):
        rc, rw, rs = gl.level_build_ref(q[b], templates, max_l, 0.3)
        live = rc < gl.BIG / 2
        np.testing.assert_allclose(np.asarray(costs[b])[live], rc[live],
                                   rtol=2e-4, atol=2e-4)
        got_live = np.asarray(costs[b]) < gl.BIG / 2
        np.testing.assert_array_equal(got_live, live)
        np.testing.assert_array_equal(np.asarray(words[b])[live], rw[live])
        np.testing.assert_array_equal(np.asarray(starts[b])[live], rs[live])


def test_jax_matches_golden_squared_cost():
    rng = np.random.default_rng(7)
    t, f, k, u_max = 10, 2, 3, 5
    q = rng.standard_normal((1, t, f)).astype(np.float32)
    templates, padded, lens = _ragged_bank(k, u_max, f, rng)
    costs, _, _ = lb.level_build(
        jnp.asarray(q), jnp.asarray([t], jnp.int32), jnp.asarray(padded),
        jnp.asarray(lens), max_levels=3, squared=True)
    rc, _, _ = gl.level_build_ref(q[0], templates, 3, 0.0, squared=True)
    live = rc < gl.BIG / 2
    np.testing.assert_allclose(np.asarray(costs[0])[live], rc[live],
                               rtol=2e-4, atol=2e-4)


def test_backtrack_infeasible_returns_empty():
    """Every template longer than 2x the recording -> nothing reachable."""
    costs = np.full((2, 4), gl.BIG)
    words = np.zeros((2, 4), np.int32)
    starts = np.zeros((2, 4), np.int32)
    seq, cost = lb.backtrack(costs, words, starts, 4)
    assert seq == [] and cost >= gl.BIG / 2


def test_backtrack_zero_length():
    seq, cost = lb.backtrack(np.zeros((1, 1)), np.zeros((1, 1), np.int32),
                             np.zeros((1, 1), np.int32), 0)
    assert seq == []


def test_gapless_recording_level_beats_vad_splitter():
    """The capability gap this module closes (VERDICT r3 #4): words
    butted together with NO silence gap.  The VAD splitter sees one
    segment and under-counts; level building recovers the sequence."""
    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import synth_connected, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    cfg = PipelineConfig()
    rec = KnnDtwRecognizer(cfg)
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])

    truth = ["two", "zero", "one"]
    sig = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                          lead_ms=(50.0, 60.0))
    vad_out = rec.classify_connected([sig], max_segments=4)[0]
    level_out = rec.classify_connected([sig], max_segments=4,
                                       method="level")[0]
    assert len(vad_out) < len(truth)     # splitter under-segments
    assert level_out == truth

    # and the level decoder keeps working on a normally-gapped recording
    gapped = synth_connected(truth, seed=6)
    assert rec.classify_connected([gapped], max_segments=4,
                                  method="level")[0] == truth


def _random_grammar(k, rng, density=0.7):
    """Random masks with a guaranteed feasible loop: at least one
    start word, one end word, and every word keeps one successor."""
    start = rng.random(k) < density
    end = rng.random(k) < density
    pairs = rng.random((k, k)) < density
    start[int(rng.integers(k))] = True
    end[int(rng.integers(k))] = True
    pairs[np.arange(k), rng.integers(0, k, size=k)] = True
    return start, pairs, end


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("penalty", [0.0, 0.7])
def test_grammar_golden_matches_brute(seed, penalty):
    """Grammar-constrained DP == doubly-exponential enumeration."""
    rng = np.random.default_rng(40 + seed)
    t, f, k = 7, 2, 3
    q = rng.standard_normal((t, f)).astype(np.float32)
    templates, _, _ = _ragged_bank(k, 4, f, rng)
    start, pairs, end = _random_grammar(k, rng)
    max_l = 3
    costs, starts = gl.level_build_grammar_ref(
        q, templates, start, pairs, max_l, penalty)
    got_seq, got_cost = lb.backtrack_grammar(costs, starts, pairs, end, t)
    want_seq, want_cost = gl.brute_connected_grammar(
        q, templates, start, pairs, end, max_l, penalty)
    if want_cost >= gl.BIG / 2:
        assert got_seq == [] and got_cost >= gl.BIG / 2
    else:
        assert got_cost == pytest.approx(want_cost, rel=1e-6)
        assert got_seq == want_seq
        # the decode respects the grammar it was given
        assert start[got_seq[0]] and end[got_seq[-1]]
        assert all(pairs[u, v] for u, v in zip(got_seq, got_seq[1:]))


@pytest.mark.parametrize("seed", [0, 1])
def test_grammar_loop_equals_unconstrained(seed):
    """The all-allowed grammar must reproduce the plain DP exactly."""
    rng = np.random.default_rng(60 + seed)
    t, f, k = 9, 2, 3
    q = rng.standard_normal((t, f)).astype(np.float32)
    templates, _, _ = _ragged_bank(k, 4, f, rng)
    ones = np.ones(k, bool)
    costs_g, starts_g = gl.level_build_grammar_ref(
        q, templates, ones, np.ones((k, k), bool), 3, 0.4)
    costs, words, starts = gl.level_build_ref(q, templates, 3, 0.4)
    # reduced-over-K grammar planes == the unconstrained best-word planes
    np.testing.assert_allclose(costs_g.min(-1), costs, rtol=1e-6)
    seq_g, cost_g = lb.backtrack_grammar(costs_g, starts_g,
                                         np.ones((k, k), bool), ones, t)
    seq, cost = lb.backtrack(costs, words, starts, t)
    assert seq_g == seq and cost_g == pytest.approx(cost, rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jax_grammar_matches_golden(seed):
    rng = np.random.default_rng(80 + seed)
    t, f, k, u_max, max_l = 11, 3, 4, 6, 4
    q = rng.standard_normal((2, t, f)).astype(np.float32)
    templates, padded, lens = _ragged_bank(k, u_max, f, rng)
    start, pairs, end = _random_grammar(k, rng)
    costs, starts = lb.level_build_grammar(
        jnp.asarray(q), jnp.asarray([t, t], jnp.int32),
        jnp.asarray(padded), jnp.asarray(lens),
        jnp.asarray(start), jnp.asarray(pairs),
        max_levels=max_l, word_penalty=0.3)
    for b in range(2):
        rc, rs = gl.level_build_grammar_ref(
            q[b], templates, start, pairs, max_l, 0.3)
        live = rc < gl.BIG / 2
        got = np.asarray(costs[b])
        np.testing.assert_array_equal(got < gl.BIG / 2, live)
        np.testing.assert_allclose(got[live], rc[live], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_array_equal(np.asarray(starts[b])[live],
                                      rs[live])
        # end-to-end: backtracking the jax planes = backtracking golden's
        np.testing.assert_array_equal(
            lb.backtrack_grammar(got, np.asarray(starts[b]), pairs, end, t)[0],
            lb.backtrack_grammar(rc, rs, pairs, end, t)[0])


def test_grammar_forbids_the_unconstrained_winner():
    """A no-repeat grammar must reroute a decode whose unconstrained
    optimum is a repetition."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    near = (w + 0.01 * rng.standard_normal(w.shape)).astype(np.float32)
    q = np.concatenate([w, w])              # truth: [0, 0]
    templates = [w, near]
    k = 2
    loop = np.ones((k, k), bool)
    ones = np.ones(k, bool)
    costs_u, starts_u = gl.level_build_grammar_ref(
        q, templates, ones, loop, 3)
    assert lb.backtrack_grammar(costs_u, starts_u, loop, ones,
                                len(q))[0] == [0, 0]
    norep = loop.copy()
    np.fill_diagonal(norep, False)
    costs_n, starts_n = gl.level_build_grammar_ref(
        q, templates, ones, norep, 3)
    seq_n, _ = lb.backtrack_grammar(costs_n, starts_n, norep, ones, len(q))
    assert seq_n in ([0, 1], [1, 0])        # rerouted through the twin


def test_grammar_infeasible_end_returns_empty():
    """End mask excludes every reachable terminal -> ([], BIG)."""
    rng = np.random.default_rng(12)
    t, f = 6, 2
    q = rng.standard_normal((t, f)).astype(np.float32)
    templates = [rng.standard_normal((3, f)).astype(np.float32)]
    ones = np.ones(1, bool)
    costs, starts = gl.level_build_grammar_ref(
        q, templates, ones, np.ones((1, 1), bool), 2)
    seq, cost = lb.backtrack_grammar(costs, starts, np.ones((1, 1), bool),
                                     np.zeros(1, bool), t)
    assert seq == [] and cost >= gl.BIG / 2


@pytest.fixture(scope="module")
def grammar_rec():
    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    return rec


def test_model_grammar_loop_matches_unconstrained(grammar_rec):
    """An all-allowed grammar must not change the gapless decode."""
    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.ops.grammar import Grammar

    truth = ["two", "zero", "one"]
    sig = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                          lead_ms=(50.0, 60.0))
    plain = grammar_rec.classify_connected([sig], max_segments=4,
                                           method="level")[0]
    loop = grammar_rec.classify_connected(
        [sig], max_segments=4, method="level",
        grammar=Grammar.loop(grammar_rec.labels))[0]
    assert plain == loop == truth


def test_model_grammar_reroutes_forbidden_decode(grammar_rec):
    """Forbid the true first word from starting: the decoder must pick
    the best GRAMMATICAL sequence instead (and flag nothing for the
    grammar that matches the truth)."""
    from dsp_asr.io.dataset import synth_connected

    truth = ["two", "zero", "one"]
    sig = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                          lead_ms=(50.0, 60.0))
    ok = {"start": ["two"], "pairs": [["two", "zero"], ["zero", "one"]],
          "end": ["one"]}
    assert grammar_rec.classify_connected(
        [sig], max_segments=4, method="level", grammar=ok)[0] == truth
    # starting with "two" forbidden -> truth is ungrammatical
    bad = {"start": ["zero", "one"]}
    got = grammar_rec.classify_connected(
        [sig], max_segments=4, method="level", grammar=bad)[0]
    assert got and got[0] != "two"


def test_model_grammar_spec_path_and_validation(grammar_rec, tmp_path):
    import json

    from dsp_asr.io.dataset import synth_connected

    truth = ["one", "two"]
    sig = synth_connected(truth, seed=8, gap_ms=(0.0, 1.0),
                          lead_ms=(50.0, 60.0))
    p = tmp_path / "grammar.json"
    p.write_text(json.dumps({"no_repeat": True}))
    assert grammar_rec.classify_connected(
        [sig], max_segments=3, method="level", grammar=str(p))[0] == truth
    with pytest.raises(ValueError, match="require method='level'"):
        grammar_rec.classify_connected([sig], grammar={"no_repeat": True})
    from dsp_asr.ops.grammar import Grammar
    with pytest.raises(ValueError, match="does not cover"):
        grammar_rec.classify_connected(
            [sig], method="level", grammar=Grammar.loop(("zero", "one")))


@pytest.mark.parametrize("chunks", [[1] * 12, [3, 3, 3, 3], [5, 7], [12]])
def test_streaming_chunks_match_batch_dp(chunks):
    """level_build_chunk over ANY chunking == the one-shot level_build
    planes (the DP is frame-synchronous, so it streams exactly)."""
    rng = np.random.default_rng(55)
    t, f, k, u_max, max_l = 12, 3, 4, 6, 3
    q = rng.standard_normal((t, f)).astype(np.float32)
    templates, padded, lens = _ragged_bank(k, u_max, f, rng)

    want_c, want_w, want_s = (np.asarray(x)[0] for x in lb.level_build(
        jnp.asarray(q[None]), jnp.asarray([t], jnp.int32),
        jnp.asarray(padded), jnp.asarray(lens), max_levels=max_l,
        word_penalty=0.3))

    state = lb.level_stream_init(max_l, k, u_max)
    got_c, got_w, got_s = [], [], []
    lo = 0
    for n in chunks:
        state, (cs, ws, ss) = lb.level_build_chunk(
            state, jnp.asarray(q[lo:lo + n]), jnp.asarray(padded),
            jnp.asarray(lens), word_penalty=0.3)
        got_c.append(np.asarray(cs))
        got_w.append(np.asarray(ws))
        got_s.append(np.asarray(ss))
        lo += n
    got_c = np.concatenate(got_c, axis=1)
    got_w = np.concatenate(got_w, axis=1)
    got_s = np.concatenate(got_s, axis=1)
    live = want_c < gl.BIG / 2
    np.testing.assert_array_equal(got_c < gl.BIG / 2, live)
    np.testing.assert_allclose(got_c[live], want_c[live], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_w[live], want_w[live])
    np.testing.assert_array_equal(got_s[live], want_s[live])
    # and the backtrack over the accumulated planes decodes identically
    assert lb.backtrack(got_c, got_w, got_s, t) == \
        lb.backtrack(want_c, want_w, want_s, t)


def test_streaming_state_resume_is_pure():
    """Feeding the same chunk from a saved state twice gives identical
    results (the state is a value, not hidden mutation)."""
    rng = np.random.default_rng(56)
    q = rng.standard_normal((8, 2)).astype(np.float32)
    templates, padded, lens = _ragged_bank(3, 4, 2, rng)
    st0 = lb.level_stream_init(2, 3, 4)
    st1, _ = lb.level_build_chunk(st0, jnp.asarray(q[:4]),
                                  jnp.asarray(padded), jnp.asarray(lens))
    _, (a, _, _) = lb.level_build_chunk(st1, jnp.asarray(q[4:]),
                                        jnp.asarray(padded),
                                        jnp.asarray(lens))
    _, (b, _, _) = lb.level_build_chunk(st1, jnp.asarray(q[4:]),
                                        jnp.asarray(padded),
                                        jnp.asarray(lens))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_word_penalty_prefers_fewer_words():
    """Two identical adjacent words: with a huge per-word penalty a
    single long template (the two concatenated) must win over two
    short decodes."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    q = np.concatenate([w, w])                       # 8 frames, two "words"
    # the one-word decode is slightly imperfect, so at zero penalty the
    # two exact short matches win strictly (an exact long template would
    # TIE at cost 0 and the earlier level wins ties)
    templates = [w, np.concatenate([w, w]) + 0.05]
    costs0, words0, starts0 = gl.level_build_ref(q, templates, 3, 0.0)
    seq0, _ = lb.backtrack(costs0, words0, starts0, len(q))
    assert seq0 == [0, 0]        # free: two exact short matches
    costs9, words9, starts9 = gl.level_build_ref(q, templates, 3, 50.0)
    seq9, _ = lb.backtrack(costs9, words9, starts9, len(q))
    assert seq9 == [1]           # heavy penalty: one long exact match
