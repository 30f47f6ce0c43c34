"""Edge-case robustness: degenerate signals, empty models, truncation."""

import numpy as np
import pytest

from dsp_asr import KnnDtwRecognizer, PipelineConfig, extract_mfcc
from dsp_asr.config import HmmConfig
from dsp_asr.io.dataset import synth_word
from dsp_asr.models.gmm_hmm import GmmHmmRecognizer


@pytest.fixture(scope="module")
def recognizer():
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one"]:
        rec.enroll(lab, [synth_word(lab, 0)])
    return rec


def test_empty_bank_raises():
    rec = KnnDtwRecognizer(PipelineConfig())
    with pytest.raises(ValueError, match="enroll"):
        rec.recognize(synth_word("zero", 0))


def test_hmm_unfitted_raises():
    rec = GmmHmmRecognizer(PipelineConfig(), HmmConfig())
    with pytest.raises(ValueError, match="not fitted"):
        rec.recognize(synth_word("zero", 0))


def test_tiny_signal_does_not_crash(recognizer):
    """Signals shorter than one frame must not error.  Since the k=1
    all-dead sentinel (ADVICE round 3) a zero-frame query — every
    distance unreachable — honestly reports NO_MATCH instead of
    silently electing the first template."""
    from dsp_asr.models.knn_dtw import NO_MATCH

    allowed = ["zero", "one", NO_MATCH]
    assert recognizer.recognize(np.zeros(10, dtype=np.float32)) in allowed
    assert recognizer.recognize(np.zeros(0, dtype=np.float32)) in allowed


def test_digital_silence_does_not_crash(recognizer):
    from dsp_asr.models.knn_dtw import NO_MATCH

    got = recognizer.recognize(np.zeros(16000, dtype=np.float32))
    assert got in ["zero", "one", NO_MATCH]


def test_overlong_signal_truncates(recognizer):
    x = np.concatenate([synth_word("one", 5), np.zeros(100000, np.float32)])
    assert recognizer.recognize(x) == "one"


def test_clipped_signal_still_recognized(recognizer):
    x = np.clip(5.0 * synth_word("one", 7), -1.0, 1.0)
    assert recognizer.recognize(x) == "one"


def test_extract_mfcc_on_noise_finite():
    x = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    feats = extract_mfcc(x)
    assert np.isfinite(feats).all()
    assert feats.shape[1] == 39


def test_reenroll_same_label_appends(recognizer):
    rec = KnnDtwRecognizer(PipelineConfig())
    rec.enroll("zero", [synth_word("zero", 0)])
    rec.enroll("zero", [synth_word("zero", 1)])
    assert rec.n_templates == 2
    assert rec.labels == ["zero"]


def test_no_vad_config_path():
    cfg = PipelineConfig(use_vad=False)
    rec = KnnDtwRecognizer(cfg)
    rec.enroll("zero", [synth_word("zero", 0)])
    rec.enroll("one", [synth_word("one", 0)])
    assert rec.recognize(synth_word("one", 3)) == "one"


def test_no_deltas_config_path():
    from dsp_asr.config import FrontendConfig
    cfg = PipelineConfig(frontend=FrontendConfig(add_deltas=False))
    rec = KnnDtwRecognizer(cfg)
    rec.enroll("zero", [synth_word("zero", 0)])
    rec.enroll("one", [synth_word("one", 0)])
    feats = rec.extract([synth_word("one", 1)])
    assert feats.feats.shape[-1] == 13
    assert rec.recognize(synth_word("one", 3)) == "one"


def test_classify_batch_chunking_matches_unchunked(recognizer):
    sigs = [synth_word(["zero", "one"][i % 2], 30 + i) for i in range(7)]
    want = recognizer.classify_batch(sigs, chunk=256)
    got = recognizer.classify_batch(sigs, chunk=3)
    assert got == want == [["zero", "one"][i % 2] for i in range(7)]


def test_profiling_helpers(tmp_path):
    import jax.numpy as jnp
    from dsp_asr.utils import StageTimer, stage

    timer = StageTimer()
    with timer.time("mfcc"):
        with stage("mfcc"):
            _ = jnp.sum(jnp.ones((8, 8)))
    rep = timer.report()
    assert "mfcc" in rep and rep["mfcc"] >= 0.0
