"""End-to-end recognizer tests: device pipeline vs golden pipeline parity,
self-classification accuracy, checkpoint round-trip (SURVEY.md §4.5)."""

import numpy as np
import pytest

from dsp_asr import KnnDtwRecognizer, PipelineConfig, extract_mfcc
from dsp_asr.golden import pipeline as gpipe
from dsp_asr.golden.frontend import mfcc_with_deltas
from dsp_asr.golden.vad import detect_endpoints as gold_vad
from dsp_asr.io.dataset import make_corpus, synth_word

CFG = PipelineConfig()
LABELS = ["zero", "one", "two", "three", "four"]


@pytest.fixture(scope="module")
def recognizer():
    rec = KnnDtwRecognizer(CFG)
    for lab in LABELS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    return rec


def test_feature_pipeline_parity_vs_golden(recognizer):
    """Device features == golden features (same VAD trim, same deltas)."""
    for lab in LABELS[:3]:
        x = synth_word(lab, 42)
        feats = recognizer.extract([x])
        length = int(np.asarray(feats.length)[0])
        got = np.asarray(feats.feats)[0, :length]
        want, want_len = gpipe.extract_features(x, CFG)
        assert length == want_len
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_extract_mfcc_api(recognizer):
    x = synth_word("one", 5)
    feats = extract_mfcc(x, CFG)
    want, want_len = gpipe.extract_features(x, CFG)
    assert feats.shape == (want_len, 39)


def test_recognize_matches_golden_label(recognizer):
    """Device argmin label == golden argmin label on fresh utterances."""
    gold_bank = []
    for lab in LABELS:
        for i in range(2):
            f, _ = gpipe.extract_features(synth_word(lab, i), CFG)
            gold_bank.append((lab, f))
    for lab in LABELS:
        x = synth_word(lab, 99)
        want_label, want_d = gpipe.recognize(x, gold_bank, CFG)
        got_labels, got_d = recognizer.classify_batch([x], return_distances=True)
        assert got_labels[0] == want_label
        want_d = np.asarray(want_d)
        # windowed-band unreachable pairs accumulate BIG differently per
        # impl — compare finiteness there, values elsewhere
        fin = (want_d < 1e20) & (got_d[0] < 1e20)
        assert ((want_d >= 1e20) == (got_d[0] >= 1e20)).all()
        np.testing.assert_allclose(got_d[0][fin], want_d[fin],
                                   rtol=5e-3, atol=5e-3)


def test_holdout_accuracy(recognizer):
    """100% on held-out synthetic utterances (distinct tone patterns)."""
    corpus = {lab: [synth_word(lab, 100 + i) for i in range(3)] for lab in LABELS}
    result = recognizer.evaluate(corpus)
    assert result["n"] == 15
    assert result["accuracy"] == 1.0


def test_padding_invariance(recognizer):
    """Extra trailing silence must not change the label (SURVEY.md §4.6)."""
    x = synth_word("two", 55, max_samples=24000)
    padded = np.zeros(32000, dtype=np.float32)
    padded[:24000] = x
    assert recognizer.recognize(x) == recognizer.recognize(padded) == "two"


def test_checkpoint_roundtrip(tmp_path, recognizer):
    path = str(tmp_path / "bank.npz")
    recognizer.save(path)
    loaded = KnnDtwRecognizer.load(path, CFG)
    assert loaded.labels == recognizer.labels
    assert loaded.n_templates == recognizer.n_templates
    x = synth_word("three", 77)
    assert loaded.recognize(x) == recognizer.recognize(x)


def test_knn_vote_k3():
    rec = KnnDtwRecognizer(CFG, k=3)
    for lab in LABELS[:3]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    for lab in LABELS[:3]:
        assert rec.recognize(synth_word(lab, 200)) == lab


def test_cmn_parity_and_recognition():
    """Cepstral mean normalization: device == golden, recognition works."""
    from dsp_asr.config import FrontendConfig
    cfg = PipelineConfig(frontend=FrontendConfig(cmn=True))
    rec = KnnDtwRecognizer(cfg)
    for lab in LABELS[:3]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    x = synth_word("one", 42)
    feats = rec.extract([x])
    length = int(np.asarray(feats.length)[0])
    got = np.asarray(feats.feats)[0, :length]
    want, want_len = gpipe.extract_features(x, cfg)
    assert length == want_len
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    # normalized static cepstra have ~zero mean over valid frames
    np.testing.assert_allclose(got[:, :13].mean(axis=0), 0.0, atol=1e-4)
    assert rec.recognize(synth_word("two", 50)) == "two"


def test_long_window_config():
    """A 4-second padded window (max_samples=64000) works end-to-end and
    max_frames is derived consistently."""
    cfg = PipelineConfig(max_samples=64000)
    assert cfg.max_frames == 1 + (64000 - 400) // 160
    rec = KnnDtwRecognizer(cfg)
    for lab in LABELS[:2]:
        rec.enroll(lab, [synth_word(lab, 0, max_samples=48000)])
    assert rec.recognize(synth_word(LABELS[1], 9, max_samples=48000)) == LABELS[1]
