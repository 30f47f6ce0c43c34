"""Linear time normalization + LTW fast matcher tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dsp_asr.config import PipelineConfig
from dsp_asr.io.dataset import synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops.frontend import time_normalize


def test_time_normalize_matches_interp():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((20, 5)).astype(np.float32)
    length, target = 13, 8
    got = np.asarray(time_normalize(jnp.asarray(feats), jnp.asarray(length),
                                    target))
    pos = np.linspace(0, length - 1, target)
    for col in range(5):
        want = np.interp(pos, np.arange(20), feats[:, col])
        np.testing.assert_allclose(got[:, col], want, rtol=1e-5, atol=1e-6)


def test_time_normalize_identity():
    """length == target_len and integer grid -> exact copy."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((16, 4)).astype(np.float32)
    got = np.asarray(time_normalize(jnp.asarray(feats), jnp.asarray(16), 16))
    np.testing.assert_allclose(got, feats, rtol=1e-6)


def test_time_normalize_single_frame():
    feats = jnp.ones((10, 3))
    got = np.asarray(time_normalize(feats, jnp.asarray(1), 8))
    np.testing.assert_allclose(got, 1.0)


def test_ltw_recognizer_accuracy():
    labels = ["zero", "one", "two", "three"]
    rec = KnnDtwRecognizer(PipelineConfig(), matcher="ltw")
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    test = {lab: [synth_word(lab, 100 + i) for i in range(3)] for lab in labels}
    result = rec.evaluate(test)
    assert result["accuracy"] >= 10 / 12   # fast path trades a little accuracy


def test_ltw_distances_shape_and_self_similarity():
    rec = KnnDtwRecognizer(PipelineConfig(), matcher="ltw")
    rec.enroll("zero", [synth_word("zero", 0)])
    rec.enroll("one", [synth_word("one", 0)])
    labels, d = rec.classify_batch([synth_word("zero", 0)],
                                   return_distances=True)
    assert labels == ["zero"]
    assert d.shape == (1, 2)
    assert d[0, 0] < d[0, 1]
    assert d[0, 0] < 1e-3   # ~zero up to matmul-expansion f32 cancellation


def test_ltw_checkpoint_roundtrip(tmp_path):
    rec = KnnDtwRecognizer(PipelineConfig(), matcher="ltw", ltw_len=48)
    rec.enroll("zero", [synth_word("zero", 0)])
    rec.enroll("one", [synth_word("one", 0)])
    path = str(tmp_path / "ltw_bank.npz")
    rec.save(path)
    loaded = KnnDtwRecognizer.load(path, PipelineConfig())
    assert loaded.matcher == "ltw" and loaded.ltw_len == 48
    x = synth_word("one", 3)
    assert loaded.recognize(x) == rec.recognize(x)


def test_checkpoint_frontend_signature_mismatch_raises(tmp_path):
    """Loading a bank under a different front-end config must fail loudly
    (round-1 advisor finding: silent feature-space mismatch)."""
    import dataclasses

    import pytest

    from dsp_asr.config import PipelineConfig

    cfg = PipelineConfig()
    rec = KnnDtwRecognizer(cfg)
    rec.enroll("zero", [synth_word("zero", 0)])
    path = str(tmp_path / "bank.npz")
    rec.save(path)
    # same config loads fine
    KnnDtwRecognizer.load(path, cfg)
    # different feature space refuses
    bad = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, cmn=True))
    with pytest.raises(ValueError, match="front-end"):
        KnnDtwRecognizer.load(path, bad)
    bad2 = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, n_mfcc=20))
    with pytest.raises(ValueError, match="n_mfcc|n_feats"):
        KnnDtwRecognizer.load(path, bad2)


def test_cascade_matcher_matches_full_dtw():
    """LTW-shortlist + DTW-rerank picks the same labels as full DTW on the
    synthetic corpus, at a fraction of the DTW pairs."""
    labels = ["zero", "one", "two", "three", "four"]
    full = KnnDtwRecognizer(PipelineConfig())
    casc = KnnDtwRecognizer(PipelineConfig(), matcher="cascade", shortlist=4)
    for lab in labels:
        sigs = [synth_word(lab, i) for i in range(3)]
        full.enroll(lab, sigs)
        casc.enroll(lab, sigs)
    queries = [synth_word(lab, 60 + i) for i, lab in enumerate(labels * 2)]
    assert casc.classify_batch(queries) == full.classify_batch(queries)


def test_cascade_knn_vote():
    labels = ["zero", "one", "two"]
    casc = KnnDtwRecognizer(PipelineConfig(), matcher="cascade",
                            shortlist=6, k=3)
    for lab in labels:
        casc.enroll(lab, [synth_word(lab, i) for i in range(3)])
    queries = [synth_word(lab, 90) for lab in labels]
    assert casc.classify_batch(queries) == labels


def test_cascade_checkpoint_roundtrip(tmp_path):
    rec = KnnDtwRecognizer(PipelineConfig(), matcher="cascade", shortlist=5)
    rec.enroll("zero", [synth_word("zero", 0)])
    rec.enroll("one", [synth_word("one", 0)])
    path = str(tmp_path / "bank.npz")
    rec.save(path)
    loaded = KnnDtwRecognizer.load(path, PipelineConfig())
    assert loaded.matcher == "cascade" and loaded.shortlist == 5
    assert loaded.recognize(synth_word("one", 7)) == "one"
