"""Cascade keyword spotting (models/spotter.py:CascadeSpotter).

The two-stage spotter: HMM keyword/filler landmarks propose candidate
spans (stage 1, cheap parametric scan), exact subsequence DTW against
the template bank relabels and re-spans each widened candidate window
(stage 2, one batched cost GEMM).  Proof layers: (1) e2e — planted
keywords inside distractor streams come back with full-word spans and
correct labels at the shipped defaults, (2) every rescored event's span
contains the landmark midpoint of some stage-1 candidate (the
containment constraint that stops a stronger NEIGHBORING word from
stealing the rescore), (3) ``spot`` is exactly
filter-by-threshold + greedy suppression over ``rescored`` (the eval
harness relies on this to sweep thresholds without re-running either
stage), (4) degenerate inputs and config-mismatch guards.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_spotter import _build_stream  # noqa: E402

from dsp_asr.config import HmmConfig, PipelineConfig  # noqa: E402
from dsp_asr.io.dataset import make_corpus, synth_word  # noqa: E402
from dsp_asr.models.gmm_hmm import GmmHmmRecognizer  # noqa: E402
from dsp_asr.models.knn_dtw import KnnDtwRecognizer  # noqa: E402
from dsp_asr.models.spotter import CascadeSpotter  # noqa: E402

KEYWORDS = ["zero", "one"]


@pytest.fixture(scope="module")
def hmm_rec():
    rec = GmmHmmRecognizer(PipelineConfig(),
                           HmmConfig(n_states=4, n_mix=2, n_iter=4))
    rec.fit(make_corpus(KEYWORDS, n_per_word=5, seed=0))
    return rec


@pytest.fixture(scope="module")
def bank_rec():
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in KEYWORDS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    return rec


@pytest.fixture(scope="module")
def cascade(hmm_rec, bank_rec):
    return CascadeSpotter(hmm_rec, bank_rec)


def _truth(spans):
    return [sp for sp in spans if sp[0] in set(KEYWORDS)]


def test_cascade_finds_keywords_with_full_spans(cascade):
    """Planted keywords among distractors: every plant detected with
    the right label and a >= 50%-overlap FULL-WORD span (unlike the HMM
    spotter's landmark spans), zero false alarms, at defaults."""
    sig, spans = _build_stream(
        ["three", "zero", "four", "one", "five"], seed=2)
    truth = _truth(spans)
    events, = cascade.spot([sig])
    assert [ev[0] for ev in events] == [sp[0] for sp in truth], events
    for (lab, s, e, sc), (tl, ts, te) in zip(events, truth):
        ov = min(e, te) - max(s, ts) + 1
        assert ov >= 0.5 * (te - ts), (lab, (s, e), (ts, te))
        assert sc < cascade.threshold


def test_cascade_multiple_streams_and_repeats(cascade):
    """Batched input; a stream with the same keyword twice yields two
    separate events (suppression must not merge distinct plants)."""
    s1, sp1 = _build_stream(["zero", "six", "zero"], seed=5)
    s2, sp2 = _build_stream(["seven", "one", "eight"], seed=6)
    got = cascade.spot([s1, s2])
    for events, spans in zip(got, (sp1, sp2)):
        truth = _truth(spans)
        assert [ev[0] for ev in events] == [sp[0] for sp in truth], events
        for (lab, s, e, _), (tl, ts, te) in zip(events, truth):
            ov = min(e, te) - max(s, ts) + 1
            assert ov >= 0.5 * (te - ts), (lab, (s, e), (ts, te))


def test_rescored_events_contain_a_landmark_midpoint(cascade):
    """The rescore is constrained to spans containing the generating
    landmark's midpoint — no event may be a 'stolen' match on a
    neighboring word outside every candidate."""
    sig, _ = _build_stream(["one", "nine", "zero", "two"], seed=7)
    cands, = cascade.stage1.spot([sig], threshold=cascade.hmm_threshold)
    mids = [(s + e) / 2.0 for _, s, e, _ in cands]
    resc, = cascade.rescored([sig])
    assert resc, "stage 1 produced no candidates at the default floor"
    for lab, s, e, sc in resc:
        assert any(s <= m <= e for m in mids), ((lab, s, e), mids)


def test_spot_is_filtered_suppressed_rescored(cascade):
    """spot(thr) == suppress(filter(rescored, thr)) for any threshold —
    the harness contract for threshold sweeps."""
    sig, _ = _build_stream(["zero", "six", "one"], seed=8)
    resc, = cascade.rescored([sig])
    for thr in (0.0, 20.0, cascade.threshold, 1e9):
        want = cascade.suppress([ev for ev in resc if ev[3] < thr])
        got, = cascade.spot([sig], threshold=thr)
        assert got == want, thr
    assert cascade.spot([sig], threshold=0.0) == [[]]


def test_suppress_keeps_best_of_overlapping():
    evs = [("a", 10, 30, 5.0), ("b", 25, 40, 3.0),   # overlap: b wins
           ("c", 50, 60, 9.0),                        # disjoint: kept
           ("d", 55, 58, 9.5)]                        # inside c: dropped
    kept = CascadeSpotter.suppress(evs)
    assert kept == [("b", 25, 40, 3.0), ("c", 50, 60, 9.0)]
    assert CascadeSpotter.suppress([]) == []


def test_silence_and_empty_inputs(cascade):
    sr = cascade.cfg.frontend.sample_rate
    assert cascade.spot([np.zeros(sr, np.float32)]) == [[]]
    assert cascade.spot([]) == []


def test_frame_grid_mismatch_raises(hmm_rec):
    import dataclasses
    cfg = PipelineConfig()
    other = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, hop_len=200))
    brec = KnnDtwRecognizer(other)
    with pytest.raises(ValueError, match="frame grid"):
        CascadeSpotter(hmm_rec, brec)


# ---------------------------------------------------------------- streaming

from dsp_asr.models.spotter import StreamingCascadeSpotter  # noqa: E402

CHUNK = 1600


def _run_stream(sc, sig):
    events = []
    n_full = len(sig) // CHUNK
    for c in range(n_full):
        events += sc.feed(sig[c * CHUNK:(c + 1) * CHUNK])
    events += sc.flush(sig[n_full * CHUNK:])
    return events


def test_streaming_cascade_matches_offline(hmm_rec, bank_rec, cascade):
    """VERDICT r4 #8 'Done' criterion: streaming == offline event
    parity on gap-separated keywords — same labels in order, spans
    within a few frames (stage-1 landmark confirmation timing is the
    only difference; the rerank windows are offline-exact rows)."""
    sig, spans = _build_stream(
        ["three", "zero", "four", "one", "five"], seed=2)
    offline, = cascade.spot([sig])
    sc = StreamingCascadeSpotter(hmm_rec, bank_rec)
    got = _run_stream(sc, sig)
    assert [ev[0] for ev in got] == [ev[0] for ev in offline], (got,
                                                                offline)
    for (gl, gs, ge, gsc), (ol, os_, oe, osc) in zip(got, offline):
        assert abs(gs - os_) <= 3 and abs(ge - oe) <= 3, (got, offline)
        assert gsc < cascade.threshold


def test_streaming_cascade_bounded_lag(hmm_rec, bank_rec):
    """An early keyword's rescored event must emit well before the
    stream ends (bounded lag, not flush-time batch processing)."""
    sig, spans = _build_stream(
        ["zero", "six", "seven", "eight", "nine", "three", "four"],
        seed=4, gap_s=0.4)
    sc = StreamingCascadeSpotter(hmm_rec, bank_rec)
    n_full = len(sig) // CHUNK
    first_at = None
    for c in range(n_full):
        if sc.feed(sig[c * CHUNK:(c + 1) * CHUNK]):
            first_at = c
            break
    assert first_at is not None and first_at < n_full - 2, first_at


def test_streaming_cascade_reset_reuses(hmm_rec, bank_rec):
    sig, _ = _build_stream(["one", "six"], seed=9)
    sc = StreamingCascadeSpotter(hmm_rec, bank_rec)
    ev1 = _run_stream(sc, sig)
    sc.reset()
    ev2 = _run_stream(sc, sig)
    assert ev1 == ev2
    assert [e[0] for e in ev1] == ["one"]


def test_streaming_cascade_rejects_cmn_bank(hmm_rec):
    import dataclasses as dc

    cfg = PipelineConfig()
    cfg = dc.replace(cfg, frontend=dc.replace(cfg.frontend, cmn=True))
    r = KnnDtwRecognizer(cfg)
    r.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingCascadeSpotter(hmm_rec, r)
