"""DTW alignment path + DBA template averaging tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import DtwConfig, PipelineConfig
from dsp_asr import golden
from dsp_asr.io.dataset import synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops import align as jalign


def test_alignment_path_matches_golden():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((9, 4)).astype(np.float32)
    b = rng.standard_normal((12, 4)).astype(np.float32)
    want_dist, want_path = golden.dtw_distance(a, b, return_path=True)
    dist, pi, pj, n = jalign.dtw_alignment(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(dist), want_dist, rtol=1e-5)
    n = int(n)
    got = list(zip(np.asarray(pi)[:n].tolist(), np.asarray(pj)[:n].tolist()))
    assert got[::-1] == want_path          # device path is end-first
    assert (np.asarray(pi)[n:] == -1).all()


def test_alignment_masked_lengths():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((15, 3)).astype(np.float32)
    b = rng.standard_normal((15, 3)).astype(np.float32)
    la, lb = 9, 6
    want_dist, want_path = golden.dtw_distance(a[:la], b[:lb], return_path=True)
    dist, pi, pj, n = jalign.dtw_alignment(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb))
    np.testing.assert_allclose(float(dist), want_dist, rtol=1e-5)
    got = list(zip(np.asarray(pi)[:int(n)], np.asarray(pj)[:int(n)]))[::-1]
    assert [tuple(map(int, p)) for p in got] == want_path


def test_medoid_identifies_central_sequence():
    rng = np.random.default_rng(2)
    base = rng.standard_normal((10, 5)).astype(np.float32)
    feats = np.stack([base + 0.05 * rng.standard_normal((10, 5)),
                      base + 0.05 * rng.standard_normal((10, 5)),
                      base + 2.0 * rng.standard_normal((10, 5))]).astype(np.float32)
    lens = np.full(3, 10, dtype=np.int32)
    m = int(jalign.medoid(jnp.asarray(feats), jnp.asarray(lens)))
    assert m in (0, 1)   # the outlier (2) cannot be the medoid


def test_dba_reduces_mean_distance():
    """A DBA center is closer (on average) to the set than the medoid."""
    from dsp_asr.ops.dtw import dtw_batch
    rng = np.random.default_rng(3)
    base = np.cumsum(rng.standard_normal((20, 4)), axis=0).astype(np.float32)
    feats = np.stack([base + 0.3 * rng.standard_normal((20, 4))
                      for _ in range(5)]).astype(np.float32)
    lens = np.full(5, 20, dtype=np.int32)
    mi = int(jalign.medoid(jnp.asarray(feats), jnp.asarray(lens)))
    center = jalign.dba_average(jnp.asarray(feats), jnp.asarray(lens),
                                jnp.asarray(feats[mi]), jnp.asarray(20), 3)
    def mean_dist(c):
        d = dtw_batch(jnp.asarray(feats), jnp.asarray(lens),
                      c[None], jnp.asarray([20], dtype=jnp.int32))
        return float(np.mean(np.asarray(d)))
    assert mean_dist(center) <= mean_dist(jnp.asarray(feats[mi])) + 1e-6


def test_recognizer_condense_keeps_accuracy():
    labels = ["zero", "one", "two"]
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    assert rec.n_templates == 9
    rec.condense("dba", n_iter=2)
    assert rec.n_templates == 3
    test = {lab: [synth_word(lab, 60 + i) for i in range(2)] for lab in labels}
    assert rec.evaluate(test)["accuracy"] == 1.0
