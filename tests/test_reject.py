"""Out-of-vocabulary rejection (utterance verification) tests.

SURVEY.md §1a L3: the reference's argmin classifier always elects the
nearest enrolled word; a production recognizer needs an accept/reject
decision for OOV words and garbage input.  calibrate_rejection derives
the threshold from the bank's own genuine/impostor score populations
(models/knn_dtw.py docstring) — the same separation rule the spotting
calibration uses.  Measured scenario this file pins (CPU, synthetic
words): threshold ~45.5 with in-vocab best distances <= 24 and OOV
best distances >= 60.
"""

import numpy as np
import pytest

from dsp_asr import KnnDtwRecognizer, PipelineConfig
from dsp_asr.io.dataset import synth_word
from dsp_asr.models.knn_dtw import REJECT

CFG = PipelineConfig()
IN_VOCAB = ["zero", "one", "two", "three", "four"]
# synth_word is procedural in the label string, so any word not in the
# bank is a deterministic out-of-vocabulary utterance
OOV = ["papa", "quebec", "victor"]


@pytest.fixture(scope="module")
def rec():
    r = KnnDtwRecognizer(CFG)
    for lab in IN_VOCAB:
        r.enroll(lab, [synth_word(lab, i) for i in range(3)])
    r.calibrate_rejection()
    return r


def _fresh_in_vocab():
    return [synth_word(lab, 50 + i) for i, lab in enumerate(IN_VOCAB)]


def _oov():
    return [synth_word(w, 7) for w in OOV]


def test_calibrated_threshold_separates_populations(rec):
    """The threshold lands between the measured populations."""
    assert rec.reject_threshold is not None
    assert np.isfinite(rec.reject_threshold)
    _, d_in = rec.classify_batch(_fresh_in_vocab(), return_distances=True)
    _, d_out = rec.classify_batch(_oov(), return_distances=True)
    assert d_in.min(axis=1).max() < rec.reject_threshold
    assert d_out.min(axis=1).min() > rec.reject_threshold


def test_in_vocab_accepted_oov_rejected(rec):
    got = rec.classify_batch(_fresh_in_vocab() + _oov(), reject=True)
    assert got[:len(IN_VOCAB)] == IN_VOCAB          # accepted AND correct
    assert got[len(IN_VOCAB):] == [REJECT] * len(OOV)


def test_reject_off_by_default(rec):
    """Without the flag the argmin elects a nearest word as always."""
    got = rec.classify_batch(_oov())
    assert REJECT not in got
    assert all(lab in IN_VOCAB for lab in got)


def test_recognize_single_utterance(rec):
    assert rec.recognize(synth_word("one", 77), reject=True) == "one"
    assert rec.recognize(synth_word("papa", 7), reject=True) == REJECT


def test_explicit_threshold_overrides(rec):
    sigs = _fresh_in_vocab()
    assert REJECT not in rec.classify_batch(sigs, reject=1e9)
    assert rec.classify_batch(sigs, reject=1e-6) == [REJECT] * len(sigs)


def test_reject_requires_calibration():
    r = KnnDtwRecognizer(CFG)
    r.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(ValueError, match="no rejection threshold"):
        r.classify_batch([synth_word("zero", 1)], reject=True)


def test_calibration_needs_pairs():
    r = KnnDtwRecognizer(CFG)
    r.enroll("zero", [synth_word("zero", 0)])
    r.enroll("one", [synth_word("one", 0)])
    with pytest.raises(ValueError, match="genuine"):
        r.calibrate_rejection()                     # no same-label pair
    r2 = KnnDtwRecognizer(CFG)
    r2.enroll("zero", [synth_word("zero", i) for i in range(2)])
    with pytest.raises(ValueError, match="labels"):
        r2.calibrate_rejection()                    # no wrong-label pair


def test_checkpoint_roundtrip(rec, tmp_path):
    path = str(tmp_path / "bank.npz")
    rec.save(path)
    back = KnnDtwRecognizer.load(path, CFG)
    assert back.reject_threshold == rec.reject_threshold
    assert back.reject_scale == rec.reject_scale == "dtw"
    assert back.classify_batch(_oov(), reject=True) == [REJECT] * len(OOV)


def test_matcher_scale_guard(rec, tmp_path):
    """A dtw-calibrated threshold must not silently gate ltw scores."""
    path = str(tmp_path / "bank.npz")
    rec.save(path)
    back = KnnDtwRecognizer.load(path, CFG)
    back.matcher = "ltw"
    with pytest.raises(ValueError, match="score units"):
        back.classify_batch(_oov(), reject=True)
    # explicit thresholds are the caller's responsibility — no guard
    assert back.classify_batch(_oov(), reject=1e9)


def test_ltw_matcher_calibrates_in_its_own_scale():
    r = KnnDtwRecognizer(CFG, matcher="ltw")
    for lab in IN_VOCAB:
        r.enroll(lab, [synth_word(lab, i) for i in range(3)])
    thr = r.calibrate_rejection()
    assert r.reject_scale == "ltw"
    got = r.classify_batch(_fresh_in_vocab() + _oov(), reject=True)
    assert got[:len(IN_VOCAB)] == IN_VOCAB
    assert got[len(IN_VOCAB):] == [REJECT] * len(OOV)
    # ltw scores are squared per-element means — a different magnitude
    # than DTW path costs; the guard above exists because of this
    assert thr != pytest.approx(45.5, abs=20)


def test_cascade_matcher_rejects():
    """Cascade shortlist distances are DTW-scale: the dtw calibration
    applies (models/knn_dtw.py:_score_scale)."""
    r = KnnDtwRecognizer(CFG, matcher="cascade")
    for lab in IN_VOCAB:
        r.enroll(lab, [synth_word(lab, i) for i in range(3)])
    r.calibrate_rejection()
    assert r.reject_scale == "dtw"
    got = r.classify_batch(_fresh_in_vocab() + _oov(), reject=True)
    assert got[:len(IN_VOCAB)] == IN_VOCAB
    assert got[len(IN_VOCAB):] == [REJECT] * len(OOV)


def test_mesh_reject_matches_single_device(rec):
    from dsp_asr import parallel as par

    sigs = _fresh_in_vocab() + _oov()
    want = rec.classify_batch(sigs, reject=True)
    mrec = KnnDtwRecognizer(CFG, mesh=par.make_mesh(2, 4))
    mrec.labels = list(rec.labels)
    mrec._bank_feats = list(rec._bank_feats)
    mrec._bank_lens = list(rec._bank_lens)
    mrec._bank_label_ids = list(rec._bank_label_ids)
    mrec.reject_threshold = rec.reject_threshold
    mrec.reject_scale = rec.reject_scale
    assert mrec.classify_batch(sigs, reject=True) == want


@pytest.fixture(scope="module")
def hmm_rec():
    from dsp_asr.config import HmmConfig
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    corpus = {w: [synth_word(w, i) for i in range(4)] for w in IN_VOCAB}
    r = GmmHmmRecognizer(CFG, HmmConfig(n_states=4, n_mix=2, n_iter=6))
    r.fit(corpus)
    r.calibrate_rejection(corpus)
    return r


def test_hmm_llr_separates(hmm_rec):
    """Measured scenario pinned: in-vocab per-frame LLR >= ~9 vs the
    UBM, OOV <= ~-25, calibrated threshold ~6.6 between them."""
    assert np.isfinite(hmm_rec.reject_threshold)
    got = hmm_rec.classify_batch(_fresh_in_vocab() + _oov(), reject=True)
    assert got[:len(IN_VOCAB)] == IN_VOCAB
    assert got[len(IN_VOCAB):] == [REJECT] * len(OOV)
    # off by default
    assert REJECT not in hmm_rec.classify_batch(_oov())


def test_hmm_recognize_and_explicit_threshold(hmm_rec):
    assert hmm_rec.recognize(synth_word("papa", 7), reject=True) == REJECT
    assert hmm_rec.recognize(synth_word("one", 77), reject=True) == "one"
    # explicit LLR threshold overrides (accept iff llr >= thr)
    sigs = _fresh_in_vocab()
    assert hmm_rec.classify_batch(sigs, reject=1e9) == [REJECT] * len(sigs)
    assert REJECT not in hmm_rec.classify_batch(sigs, reject=-1e9)


def test_hmm_checkpoint_roundtrip(hmm_rec, tmp_path):
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    path = str(tmp_path / "hmm.npz")
    hmm_rec.save(path)
    back = GmmHmmRecognizer.load(path, CFG)
    assert back.reject_threshold == hmm_rec.reject_threshold
    assert back.classify_batch(_oov(), reject=True) == [REJECT] * len(OOV)


def test_hmm_reject_requires_calibration_or_number(hmm_rec):
    from dsp_asr.config import HmmConfig
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    corpus = {w: [synth_word(w, i) for i in range(2)] for w in IN_VOCAB[:2]}
    r = GmmHmmRecognizer(CFG, HmmConfig(n_states=3, n_mix=1, n_iter=2))
    r.fit(corpus)
    with pytest.raises(ValueError, match="no rejection threshold"):
        r.classify_batch(_oov(), reject=True)


def test_hmm_evaluate_oov_protocol(hmm_rec):
    corpus = {lab: [synth_word(lab, 60)] for lab in IN_VOCAB}
    corpus["papa"] = [synth_word("papa", 7)]
    result = hmm_rec.evaluate(corpus, reject=True)
    assert result["accuracy"] == 1.0
    assert result["confusion"][REJECT] == {REJECT: 1}


def test_evaluate_oov_protocol(rec):
    """evaluate(reject=True): un-enrolled corpus labels are OOV truth —
    correct iff rejected; their confusion row is keyed REJECT."""
    corpus = {lab: [synth_word(lab, 50)] for lab in IN_VOCAB}
    corpus["papa"] = [synth_word("papa", 7)]
    corpus["quebec"] = [synth_word("quebec", 7)]
    result = rec.evaluate(corpus, reject=True)
    assert result["accuracy"] == 1.0
    assert result["n"] == len(IN_VOCAB) + 2
    assert result["confusion"][REJECT] == {REJECT: 2}
    # without rejection the OOV rows drag accuracy below 1 (argmin
    # elects some nearest enrolled word)
    plain = rec.evaluate(corpus)
    assert plain["accuracy"] < 1.0
