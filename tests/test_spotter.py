"""Keyword spotting end-to-end (models/spotter.py).

The capability the reference cannot express (SURVEY §2a: its endpoint
detector must isolate a word before DTW sees it): enrolled keywords are
found inside a long continuous recording that also contains
NON-enrolled distractor words, with frame-accurate spans — offline
batch and online (SPRING) streaming.
"""

import numpy as np
import pytest

from dsp_asr.config import PipelineConfig
from dsp_asr.io.dataset import synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.models.spotter import KeywordSpotter, StreamingSpotter

SR = 16000
HOP = 160


def _trimmed(label, seed):
    w = synth_word(label, seed, SR, max_samples=int(2.0 * SR), noise=0.0)
    nz = np.nonzero(np.abs(w) > 0)[0]
    return w[nz[0]: nz[-1] + 1]


def _build_stream(words, seed=0, gap_s=0.18, lead_s=0.15, noise=0.003):
    """Concatenate words with short gaps; returns (signal, spans) where
    spans[i] = (label, start_frame, end_frame) ground truth."""
    rng = np.random.default_rng(seed)
    pieces = [np.zeros(int(lead_s * SR))]
    spans = []
    pos = len(pieces[0])
    for i, lab in enumerate(words):
        w = _trimmed(lab, seed * 101 + i)
        spans.append((lab, pos // HOP, (pos + len(w)) // HOP))
        pieces.append(w)
        pos += len(w)
        g = np.zeros(int(gap_s * SR))
        pieces.append(g)
        pos += len(g)
    x = np.concatenate(pieces)
    return (x + noise * rng.standard_normal(len(x))).astype(np.float32), spans


@pytest.fixture(scope="module")
def rec():
    r = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one"]:
        r.enroll(lab, [synth_word(lab, i) for i in range(3)])
    return r


WORDS = ["three", "zero", "four", "one", "five"]
KEYWORDS = {"zero", "one"}


def _truth_spans(spans):
    return [sp for sp in spans if sp[0] in KEYWORDS]


def _separation(spotter, sig, spans):
    """(best score inside true keyword spans, best score elsewhere,
    calibrated threshold)."""
    (norm, start), = spotter.scores([sig])
    k, t = norm.shape
    ids = np.asarray(spotter.rec.device_bank()[1])
    labels = spotter.rec.labels
    # a candidate (template row, end column) is a HIT if its match span
    # [start, end] covers >= 50% of a planted keyword of the same label
    # (the detection-theoretic definition; end columns can trail into
    # the following gap without making the match false)
    hit = np.zeros((k, t), bool)
    cols = np.arange(t)
    for lab, s, e in _truth_spans(spans):
        ov = (np.minimum(cols[None, :], e)
              - np.maximum(start, s) + 1) >= 0.5 * (e - s)
        ov &= (np.asarray([labels[i] for i in ids]) == lab)[:, None]
        hit |= ov
    best_true = float(norm[hit].min())
    best_false = float(norm[~hit].min())
    return best_true, best_false, (best_true + best_false) / 2.0


def test_score_field_separates_keywords_from_distractors(rec):
    """Subsequence matches can cherry-pick the best-matching PORTION of
    a distractor word, so the margin is modest — but the best true-span
    score must still be clearly below everything else."""
    sig, spans = _build_stream(WORDS, seed=2)
    spotter = KeywordSpotter(rec)
    best_true, best_false, _ = _separation(spotter, sig, spans)
    assert best_true < 0.8 * best_false, (best_true, best_false)


def test_offline_spotting_events(rec):
    sig, spans = _build_stream(WORDS, seed=2)
    spotter = KeywordSpotter(rec)
    _, _, thr = _separation(spotter, sig, spans)
    events, = spotter.spot([sig], threshold=thr)
    truth = _truth_spans(spans)
    assert [ev[0] for ev in events] == [sp[0] for sp in truth]
    for (lab, s, e, sc), (tl, ts, te) in zip(events, truth):
        # the matched span overlaps the planted word substantially
        lo, hi = max(s, ts), min(e, te)
        assert hi - lo > 0.5 * (te - ts), (lab, (s, e), (ts, te))


def test_no_events_on_distractor_only_stream(rec):
    sig_d, spans_d = _build_stream(["three", "four", "five"], seed=3)
    sig_k, spans_k = _build_stream(WORDS, seed=2)
    spotter = KeywordSpotter(rec)
    _, _, thr = _separation(spotter, sig_k, spans_k)
    events, = spotter.spot([sig_d], threshold=thr)
    assert events == []


def test_batch_of_recordings(rec):
    sig1, spans1 = _build_stream(WORDS, seed=2)
    sig2, spans2 = _build_stream(["zero"], seed=7)
    spotter = KeywordSpotter(rec)
    _, _, thr = _separation(spotter, sig1, spans1)
    ev1, ev2 = spotter.spot([sig1, sig2], threshold=thr)
    assert [e[0] for e in ev1] == ["zero", "one"]
    assert [e[0] for e in ev2] == ["zero"]


def test_streaming_matches_offline(rec):
    sig, spans = _build_stream(WORDS, seed=2)
    spotter = KeywordSpotter(rec)
    _, _, thr = _separation(spotter, sig, spans)
    offline, = spotter.spot([sig], threshold=thr)

    ss = StreamingSpotter(rec, chunk_len=1600, threshold=thr)
    n_full = len(sig) // 1600 * 1600
    events = []
    for lo in range(0, n_full, 1600):
        events += ss.feed(sig[lo:lo + 1600])
    events += ss.flush(sig[n_full:])

    assert [e[0] for e in events] == [e[0] for e in offline]
    for (l1, s1, e1, c1), (l2, s2, e2, c2) in zip(events, offline):
        assert abs(s1 - s2) <= 2 and abs(e1 - e2) <= 2
        np.testing.assert_allclose(c1, c2, rtol=1e-3, atol=1e-5)


def test_streaming_chunk_size_invariance(rec):
    sig, spans = _build_stream(["zero", "three"], seed=5)
    outs = []
    for cl in (800, 1600):
        ss = StreamingSpotter(rec, chunk_len=cl, threshold=0.5)
        n_full = len(sig) // cl * cl
        events = []
        for lo in range(0, n_full, cl):
            events += ss.feed(sig[lo:lo + cl])
        events += ss.flush(sig[n_full:])
        outs.append(events)
    # identical events regardless of chunking (flush(tail) drops the
    # fabricated pad frames, so the streams are sample-identical)
    assert outs[0] == outs[1]


def test_mesh_spotting_matches_single_device(rec):
    """Bank-sharded spotting over a ('data','bank') mesh is bit-exact vs
    the single-device spotter (zero collectives — each device scans its
    template shard; padding templates score BIG and emit nothing)."""
    from dsp_asr import parallel as par

    sig1, _ = _build_stream(WORDS, seed=2)
    sig2, _ = _build_stream(["zero", "three"], seed=9)
    single = KeywordSpotter(rec)
    want = single.spot([sig1, sig2], threshold=30.0)

    mrec = KnnDtwRecognizer(PipelineConfig(), mesh=par.make_mesh(2, 4))
    for lab in ["zero", "one"]:
        mrec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    msp = KeywordSpotter(mrec)
    got = msp.spot([sig1, sig2], threshold=30.0)
    assert got == want
    # and the raw score planes agree exactly
    (n1, s1), = single.scores([sig1])
    (n2, s2), = msp.scores([sig1])
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(s1, s2)


def test_streaming_no_duplicate_emission(rec):
    """A single keyword followed by a long in-vocabulary-free stretch:
    the trailing sub-threshold columns of the SAME occurrence must not
    re-open a pending after the hangover emission (one event, exactly —
    the code-review regression)."""
    sig, spans = _build_stream(["zero", "three", "four", "five",
                                "three", "four"], seed=13)
    ss = StreamingSpotter(rec, chunk_len=1600, threshold=30.0,
                          hangover=10)
    n_full = len(sig) // 1600 * 1600
    events = []
    for lo in range(0, n_full, 1600):
        events += ss.feed(sig[lo:lo + 1600])
    events += ss.flush(sig[n_full:])
    assert [e[0] for e in events] == ["zero"], events


def test_calibrate_threshold_separates_and_matches_default_scale(rec):
    """The per-bank calibrated threshold must sit strictly between the
    bank's genuine and impostor score populations, admit the planted
    keywords of the standard stream, and land in the measured-good
    window of the 2-keyword bank."""
    spotter = KeywordSpotter(rec)
    thr = spotter.calibrate_threshold()
    sig, spans = _build_stream(WORDS, seed=2)
    events, = spotter.spot([sig], threshold=thr)
    truth = _truth_spans(spans)
    assert [ev[0] for ev in events] == [sp[0] for sp in truth], (thr,
                                                                 events)


def test_calibrate_threshold_requires_pairs():
    import pytest

    from dsp_asr.config import PipelineConfig

    r1 = KnnDtwRecognizer(PipelineConfig())
    r1.enroll("zero", [synth_word("zero", 0)])
    r1.enroll("one", [synth_word("one", 0)])
    with pytest.raises(ValueError, match="genuine"):
        KeywordSpotter(r1).calibrate_threshold()
    r2 = KnnDtwRecognizer(PipelineConfig())
    r2.enroll("zero", [synth_word("zero", i) for i in range(2)])
    with pytest.raises(ValueError, match="labels"):
        KeywordSpotter(r2).calibrate_threshold()


def test_threshold_resolution_order(rec, tmp_path):
    """Explicit threshold > bank-stored calibration > fixed default 40,
    and the stored calibration survives a checkpoint round trip."""
    from dsp_asr.models.spotter import DEFAULT_SPOT_THRESHOLD

    assert rec.spot_threshold is None
    sp0 = KeywordSpotter(rec)
    assert sp0.threshold == DEFAULT_SPOT_THRESHOLD
    assert sp0.threshold_source == "default"

    rec.spot_threshold = 33.5
    sp1 = KeywordSpotter(rec)
    assert sp1.threshold == 33.5
    assert sp1.threshold_source == "bank-calibrated"
    ss = StreamingSpotter(rec)
    assert ss.threshold == 33.5
    assert ss.threshold_source == "bank-calibrated"

    sp2 = KeywordSpotter(rec, threshold=41.0)
    assert sp2.threshold == 41.0
    assert sp2.threshold_source == "explicit"

    path = str(tmp_path / "bank.npz")
    rec.save(path)
    reloaded = KnnDtwRecognizer.load(path, rec.cfg)
    assert reloaded.spot_threshold == pytest.approx(33.5)
    # a pre-calibration checkpoint (or one saved with None) stays None
    rec.spot_threshold = None
    rec.save(path)
    assert KnnDtwRecognizer.load(path, rec.cfg).spot_threshold is None
