"""Host-side length-bucketed classification (pipeline.classify_features_bucketed)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig
from dsp_asr.io.dataset import DIGITS, make_corpus, synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops import frontend as fe

CFG = PipelineConfig()


@pytest.fixture(scope="module")
def setup():
    """Mixed-length query features + a small bank."""
    rng = np.random.default_rng(0)
    bank_sigs = [synth_word(lab, i) for lab in DIGITS[:5] for i in range(2)]
    ids = np.repeat(np.arange(5), 2).astype(np.int32)
    # mixed lengths: truncate signals to varying durations
    q_sigs = []
    for i, lab in enumerate(DIGITS[:5] * 8):
        x = synth_word(lab, 100 + i)
        keep = int(len(x) * rng.uniform(0.3, 1.0))
        q_sigs.append(x[:keep])
    mats = fe.make_matrices(CFG.frontend)
    bx, bn = pl.pad_signals(bank_sigs, CFG.max_samples)
    bank = pl.extract_features(bx, bn, mats, CFG)
    qx, qn = pl.pad_signals(q_sigs, CFG.max_samples)
    feats = pl.extract_features(qx, qn, mats, CFG)
    return feats, bank, jnp.asarray(ids), q_sigs, bank_sigs


@pytest.mark.parametrize("k", [1, 3])
def test_bucketed_matches_unbucketed(setup, k):
    feats, bank, ids, _, _ = setup
    want_ids, want_d = pl.classify_features(
        feats, bank, ids, n_labels=5, k=k, cfg=CFG)
    got_ids, got_d = pl.classify_features_bucketed(
        feats, bank, ids, n_labels=5, k=k, cfg=CFG)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    want_d = np.asarray(want_d)
    fin = (want_d < 1e20) & (got_d < 1e20)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5, atol=1e-5)
    assert ((got_d >= 1e20) == (want_d >= 1e20)).all()


def test_bucket_assignment_covers_all_lengths(setup):
    feats, bank, ids, _, _ = setup
    # degenerate: every query shorter than the smallest bucket
    short = pl.Features(feats.feats[:, : feats.feats.shape[1] // 8],
                        jnp.minimum(feats.length,
                                    feats.feats.shape[1] // 8))
    got_ids, got_d = pl.classify_features_bucketed(
        short, bank, ids, n_labels=5, k=1, cfg=CFG)
    assert got_ids.shape == (feats.feats.shape[0],)
    assert np.isfinite(got_d[got_d < 1e20]).all()


def test_recognizer_bucketed_flag(setup):
    _, _, _, q_sigs, bank_sigs = setup
    rec_b = KnnDtwRecognizer(CFG, bucketed=True)
    rec_u = KnnDtwRecognizer(CFG, bucketed=False)
    for rec in (rec_b, rec_u):
        for j, lab in enumerate(DIGITS[:5]):
            rec.enroll(lab, bank_sigs[2 * j: 2 * j + 2])
    lb, db = rec_b.classify_batch(q_sigs, return_distances=True)
    lu, du = rec_u.classify_batch(q_sigs, return_distances=True)
    assert lb == lu
    fin = (db < 1e20) & (du < 1e20)
    np.testing.assert_allclose(db[fin], du[fin], rtol=1e-5, atol=1e-5)
