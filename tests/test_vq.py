"""VQ-codebook recognizer tests (models/vq.py)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import PipelineConfig, VqConfig
from dsp_asr.io.dataset import make_corpus
from dsp_asr.models.vq import VqRecognizer, kmeans_fit, vq_distortion, _sq_dists

LABELS = ["zero", "one", "two", "three", "four"]


def test_kmeans_reduces_distortion_and_is_deterministic():
    rng = np.random.default_rng(0)
    w, n, f, c = 3, 200, 8, 16
    frames = jnp.asarray(rng.standard_normal((w, n, f)), jnp.float32)
    mask = jnp.asarray((rng.random((w, n)) < 0.9), jnp.float32)

    def distortion(cb):
        d = np.asarray(_sq_dists(frames, cb)).min(axis=-1)
        m = np.asarray(mask)
        return float((d * m).sum() / m.sum())

    prev = np.inf
    for it in (1, 3, 10):
        cb = kmeans_fit(frames, mask, n_codes=c, n_iter=it)
        cur = distortion(cb)
        assert cur <= prev + 1e-6
        prev = cur
    cb2 = kmeans_fit(frames, mask, n_codes=c, n_iter=10)
    np.testing.assert_array_equal(np.asarray(cb), np.asarray(cb2))


def test_vq_distortion_masks_padding():
    rng = np.random.default_rng(1)
    feats = jnp.asarray(rng.standard_normal((2, 30, 6)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((4, 8, 6)), jnp.float32)
    lens = jnp.asarray([30, 12], jnp.int32)
    d = np.asarray(vq_distortion(feats, lens, cb))
    # corrupting padded frames must not change the distortion
    feats2 = feats.at[1, 12:].set(1e3)
    d2 = np.asarray(vq_distortion(feats2, lens, cb))
    np.testing.assert_allclose(d, d2, rtol=1e-6)


@pytest.fixture(scope="module")
def fitted():
    rec = VqRecognizer(PipelineConfig(), VqConfig(n_codes=32, n_iter=8))
    rec.fit(make_corpus(LABELS, n_per_word=3, seed=0))
    return rec


def test_vq_recognizer_accuracy(fitted):
    test = make_corpus(LABELS, n_per_word=4, seed=777)
    res = fitted.evaluate(test)
    assert res["accuracy"] >= 0.9, res


def test_vq_save_load_roundtrip(fitted, tmp_path):
    p = os.path.join(tmp_path, "vq.npz")
    fitted.save(p)
    rec2 = VqRecognizer.load(p, fitted.cfg)
    assert rec2.labels == fitted.labels
    np.testing.assert_array_equal(rec2.codebooks, fitted.codebooks)
    test = make_corpus(LABELS[:2], n_per_word=2, seed=55)
    sigs = [x for xs in test.values() for x in xs]
    assert rec2.classify_batch(sigs) == fitted.classify_batch(sigs)


def test_vq_load_rejects_mismatched_frontend(fitted, tmp_path):
    import dataclasses

    from dsp_asr.config import FrontendConfig

    p = os.path.join(tmp_path, "vq.npz")
    fitted.save(p)
    other = dataclasses.replace(fitted.cfg,
                                frontend=FrontendConfig(n_mfcc=20))
    with pytest.raises(ValueError):
        VqRecognizer.load(p, other)
