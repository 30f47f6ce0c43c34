"""HMM keyword spotting (ops/spot_hmm.py + models/spotter.py:HmmSpotter).

Proof layers: (1) the golden open-begin Viterbi equals brute
enumeration over entry frames (forced state-0 entry, last-state exit,
per-span classical Viterbi), (2) the jax frame-synchronous scan matches
the golden tables — values AND entry witnesses — on random left-right
HMMs, (3) the LLR readout matches the golden formula, (4) e2e: a fitted
GmmHmmRecognizer spots its words inside streams of out-of-vocabulary
distractors using its stored UBM as the filler.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.golden import spot_hmm as gsh
from dsp_asr.models import gmm_hmm as gh
from dsp_asr.ops import spot_hmm as osh

NEG_INF = gsh.NEG_INF


def _random_lr_hmm(rng, s):
    stay = rng.uniform(0.3, 0.8, size=s)
    log_a = np.full((s, s), NEG_INF)
    di = np.arange(s)
    log_a[di, di] = np.log(stay)
    log_a[di[:-1], di[:-1] + 1] = np.log1p(-stay[:-1])
    log_a[s - 1, s - 1] = 0.0
    return log_a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_golden_matches_brute_entry_enumeration(seed):
    """V[e, S-1] must equal the max over entry frames s of the classical
    Viterbi log-lik of span [s, e] with forced state-0 entry and
    last-state readout; the witness must achieve it."""
    rng = np.random.default_rng(seed)
    u, s = 12, 3
    log_a = _random_lr_hmm(rng, s)
    log_b = rng.normal(-2.0, 1.0, size=(u, s))
    v, st = gsh.spot_viterbi_tables(log_a, log_b)

    def forced(entry, end):
        delta = np.full(s, NEG_INF)
        delta[0] = log_b[entry, 0]
        for j in range(entry + 1, end + 1):
            nxt = np.full(s, NEG_INF)
            for k in range(s):
                best = delta[k] + log_a[k, k]
                if k > 0:
                    best = max(best, delta[k - 1] + log_a[k - 1, k])
                nxt[k] = log_b[j, k] + best
            delta = nxt
        return delta[s - 1]

    for e in range(u):
        want = max(forced(st_, e) for st_ in range(e + 1))
        np.testing.assert_allclose(v[e, s - 1], want, rtol=1e-12,
                                   err_msg=f"end {e}")
        np.testing.assert_allclose(forced(int(st[e, s - 1]), e), want,
                                   rtol=1e-12, err_msg=f"witness {e}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_jax_matches_golden(seed):
    rng = np.random.default_rng(seed)
    u, w, s = 17, 4, 3
    log_a = np.stack([_random_lr_hmm(rng, s) for _ in range(w)])
    logb = rng.normal(-3.0, 2.0, size=(u, w, s)).astype(np.float32)
    v_last, starts = osh.spot_viterbi(jnp.asarray(logb), jnp.asarray(log_a))
    v_last, starts = np.asarray(v_last), np.asarray(starts)
    for wi in range(w):
        gv, gst = gsh.spot_viterbi_tables(log_a[wi], logb[:, wi])
        np.testing.assert_allclose(v_last[wi], gv[:, -1], rtol=2e-5,
                                   atol=1e-4, err_msg=f"word {wi}")
        np.testing.assert_array_equal(starts[wi], gst[:, -1])


def test_llr_readout_matches_golden():
    rng = np.random.default_rng(7)
    u, s = 14, 3
    log_a = _random_lr_hmm(rng, s)
    logb = rng.normal(-2.0, 1.0, size=(u, s))
    ubm_ll = rng.normal(-3.0, 0.5, size=u)
    gv, gst = gsh.spot_viterbi_tables(log_a, logb)
    want_llr, want_st = gsh.spot_llr(gv, gst, ubm_ll)
    v_last, starts = osh.spot_viterbi(
        jnp.asarray(logb[:, None, :], dtype=jnp.float32),
        jnp.asarray(log_a[None], dtype=jnp.float32))
    got = np.asarray(osh._llr_readout(
        v_last, starts, jnp.asarray(ubm_ll, jnp.float32),
        jnp.asarray(u)))[0]
    np.testing.assert_allclose(got, want_llr, rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(starts)[0], want_st)


@pytest.fixture(scope="module")
def hmm_rec():
    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import make_corpus

    corpus = make_corpus(["zero", "one"], n_per_word=5, seed=0)
    rec = gh.GmmHmmRecognizer(PipelineConfig(),
                              HmmConfig(n_states=4, n_mix=2, n_iter=4))
    rec.fit(corpus)
    assert rec.ubm is not None      # fit always stores the filler now
    return rec


def test_hmm_spotter_finds_keywords(hmm_rec):
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_spotter import _build_stream

    from dsp_asr.models.spotter import HmmSpotter

    sig, spans = _build_stream(
        ["three", "zero", "four", "one", "five"], seed=2)
    spotter = HmmSpotter(hmm_rec)
    (llr, start), = spotter.scores([sig])
    truth = [sp for sp in spans if sp[0] in {"zero", "one"}]
    # the per-frame LLR peaks on the high-contrast CORE of the word
    # (short landmark spans), so hits use the standard KWS midpoint
    # criterion: a candidate is true iff its span midpoint lies inside
    # a same-label planted keyword
    k, t = llr.shape
    cols = np.arange(t)
    mid = (start + cols[None, :]) / 2.0
    hit = np.zeros((k, t), bool)
    labels = np.asarray(spotter.rec.labels)
    for lab, s, e in truth:
        ov = (mid >= s) & (mid <= e) & (labels == lab)[:, None]
        hit |= ov
    # EVERY keyword's peak must beat the best non-keyword column, so a
    # single threshold catches all plants with zero false alarms
    worst_true = min(
        float(np.where(hit & (labels == lab)[:, None], llr, -np.inf).max())
        for lab, _, _ in truth)
    best_false = float(np.where(hit, -np.inf, llr).max())
    assert worst_true > best_false, (worst_true, best_false)
    thr = (worst_true + best_false) / 2.0
    events, = spotter.spot([sig], threshold=thr)
    assert [ev[0] for ev in events] == [sp[0] for sp in truth]
    for (lab, s, e, sc), (tl, ts, te) in zip(events, truth):
        assert ts <= (s + e) / 2.0 <= te, (lab, (s, e), (ts, te))


def test_ubm_persists_through_save_load(hmm_rec, tmp_path):
    from dsp_asr.config import PipelineConfig

    p = str(tmp_path / "hmm.npz")
    hmm_rec.save(p)
    loaded = gh.GmmHmmRecognizer.load(p, PipelineConfig(), hmm_rec.hmm)
    assert loaded.ubm is not None
    for a, b in zip(loaded.ubm, hmm_rec.ubm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("chunks", [[57], [10, 20, 27], [13, 44],
                                    [8] * 7 + [1]])
def test_spot_hmm_chunk_matches_offline(hmm_rec, chunks):
    """Streaming column update vs the offline batch: entry witnesses
    integer-exact, LLR within float tolerance (the offline cumsum UBM
    prefix vs the scan's running sum, and emission-GEMM shape rounding
    — ops/spot_hmm.py:spot_hmm_chunk docstring)."""
    import jax.numpy as jnp

    from dsp_asr.ops.spot_hmm import (spot_hmm_batch, spot_hmm_chunk,
                                      spot_hmm_init)

    params, ubm = hmm_rec.params, hmm_rec.ubm
    rng = np.random.default_rng(3)
    u, f = sum(chunks), 39
    stream = rng.normal(0.0, 3.0, size=(u, f)).astype(np.float32)
    llr_off, st_off = spot_hmm_batch(
        stream[None], jnp.asarray([u]), params, ubm)
    llr_off, st_off = np.asarray(llr_off)[0], np.asarray(st_off)[0]

    state = spot_hmm_init(*params.log_pi.shape)
    llrs, starts = [], []
    lo = 0
    for c in chunks:
        state, llr, s0 = spot_hmm_chunk(
            state, jnp.asarray(stream[lo:lo + c]),
            jnp.asarray(c, jnp.int32), params, ubm)
        llrs.append(np.asarray(llr))
        starts.append(np.asarray(s0))
        lo += c
    np.testing.assert_array_equal(np.concatenate(starts, 1), st_off)
    np.testing.assert_allclose(np.concatenate(llrs, 1), llr_off,
                               rtol=1e-4, atol=2e-3)


def test_spot_hmm_chunk_padding_rows_ignored(hmm_rec):
    """Rows past n_valid must not advance the DP: a padded feed equals
    the exact-length feed bit-for-bit."""
    import jax.numpy as jnp

    from dsp_asr.ops.spot_hmm import spot_hmm_chunk, spot_hmm_init

    params, ubm = hmm_rec.params, hmm_rec.ubm
    rng = np.random.default_rng(4)
    rows = rng.normal(0.0, 3.0, size=(11, 39)).astype(np.float32)
    s1 = spot_hmm_init(*params.log_pi.shape)
    s1, l1, w1 = spot_hmm_chunk(s1, jnp.asarray(rows),
                                jnp.asarray(11, jnp.int32), params, ubm)
    padded = np.concatenate([rows, 7.7 * np.ones((5, 39), np.float32)])
    s2 = spot_hmm_init(*params.log_pi.shape)
    s2, l2, w2 = spot_hmm_chunk(s2, jnp.asarray(padded),
                                jnp.asarray(11, jnp.int32), params, ubm)
    np.testing.assert_array_equal(np.asarray(s1.v), np.asarray(s2.v))
    np.testing.assert_array_equal(np.asarray(s1.p), np.asarray(s2.p))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2)[:, :11])
    assert (np.asarray(l2)[:, 11:] <= -1e29).all()


def test_streaming_hmm_spotter_matches_offline_events(hmm_rec):
    """StreamingHmmSpotter feed/flush vs the offline HmmSpotter at the
    same threshold/min_gap: same labels in order, landmark spans within
    a couple of frames, LLR scores close."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_spotter import _build_stream

    from dsp_asr.models.spotter import HmmSpotter, StreamingHmmSpotter

    sig, spans = _build_stream(
        ["three", "zero", "four", "one", "five"], seed=2)
    thr = -30.0
    offline, = HmmSpotter(hmm_rec, threshold=thr).spot([sig])
    assert offline, "offline spotter found nothing — bad fixture"

    ss = StreamingHmmSpotter(hmm_rec, chunk_len=1600, threshold=thr)
    n_full = len(sig) // 1600 * 1600
    events = []
    for lo in range(0, n_full, 1600):
        events += ss.feed(sig[lo:lo + 1600])
    events += ss.flush(sig[n_full:])

    assert [e[0] for e in events] == [e[0] for e in offline], (events,
                                                               offline)
    for (l1, s1, e1, c1), (l2, s2, e2, c2) in zip(events, offline):
        assert abs(s1 - s2) <= 2 and abs(e1 - e2) <= 2, (events, offline)
        np.testing.assert_allclose(c1, c2, rtol=1e-3, atol=2e-3)


def test_streaming_hmm_spotter_chunk_size_invariance(hmm_rec):
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_spotter import _build_stream

    from dsp_asr.models.spotter import StreamingHmmSpotter

    sig, _ = _build_stream(["zero", "three"], seed=5)
    outs = []
    for cl in (800, 1600):
        ss = StreamingHmmSpotter(hmm_rec, chunk_len=cl, threshold=-30.0)
        n_full = len(sig) // cl * cl
        events = []
        for lo in range(0, n_full, cl):
            events += ss.feed(sig[lo:lo + cl])
        events += ss.flush(sig[n_full:])
        outs.append(events)
    assert [e[:3] for e in outs[0]] == [e[:3] for e in outs[1]]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(a[3], b[3], rtol=1e-4, atol=1e-3)
