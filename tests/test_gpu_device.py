"""Checks that only a GPU can make (marked ``gpu``; they skip elsewhere).

Run on the card with ``python chip_smoke.py`` (its ``tests`` phase runs
them in its own process), or alone with
``DSP_ASR_DEVICE_TESTS=1 python -m pytest -m gpu tests/test_gpu_device.py``.

Covered: the fused banded DTW kernel as compiled for the card (Triton)
against the XLA scan, the routing that picks it, DEFAULT-vs-HIGHEST
label parity, the GMM fit's precision, connected decoding, grammar and
n-best, and keyword spotting, each against the CPU-verified behaviour.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dsp_asr import pipeline as pl
from dsp_asr.config import DtwConfig, PipelineConfig
from dsp_asr.io.dataset import DIGITS, synth_word
from dsp_asr.ops import frontend as fe

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")


def _problem(n_query=64, per_word=3):
    cfg = PipelineConfig()
    mats = fe.make_matrices(cfg.frontend)
    bank_sigs = np.stack([synth_word(lab, i, max_samples=cfg.max_samples)
                          for lab in DIGITS for i in range(per_word)])
    ids = np.repeat(np.arange(len(DIGITS), dtype=np.int32), per_word)
    q_sigs = np.stack([synth_word(DIGITS[i % 10], 500 + i,
                                  max_samples=cfg.max_samples)
                       for i in range(n_query)])
    ns = np.full(len(bank_sigs), cfg.max_samples, np.int32)
    qn = np.full(n_query, cfg.max_samples, np.int32)
    return cfg, mats, (jnp.asarray(q_sigs), jnp.asarray(qn),
                       jnp.asarray(bank_sigs), jnp.asarray(ns),
                       jnp.asarray(ids))


def test_default_precision_argmin_parity():
    """DEFAULT (TF32 GEMMs on the card) vs HIGHEST: same labels."""
    cfg, mats, (q, qn, b, bn, ids) = _problem()
    hi, lo = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
    bank_hi = pl.extract_features(b, bn, mats, cfg, hi)
    bank_lo = pl.extract_features(b, bn, mats, cfg, lo)
    lab_hi, _ = pl.recognize_batch(q, qn, mats, bank_hi, ids, cfg, hi)
    lab_lo, _ = pl.recognize_batch(q, qn, mats, bank_lo, ids, cfg, lo)
    np.testing.assert_array_equal(np.asarray(lab_hi), np.asarray(lab_lo))


@pytest.mark.parametrize("slope,squared", [(None, False), (None, True),
                                           ("itakura", False)])
def test_fused_banded_kernel_matches_scan_on_device(slope, squared):
    from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded
    from dsp_asr.ops.dtw import dtw_batch

    cfg, mats, (q, qn, b, bn, _) = _problem(n_query=40)
    dtw_cfg = dataclasses.replace(cfg.dtw, slope=slope, squared=squared)
    feats = pl.extract_features(q, qn, mats, cfg)
    bank = pl.extract_features(b, bn, mats, cfg)
    d_kernel = np.asarray(dtw_batch_fused_banded(
        feats.feats, feats.length, bank.feats, bank.length, dtw_cfg))
    d_scan = np.asarray(dtw_batch(
        feats.feats, feats.length, bank.feats, bank.length, dtw_cfg))
    fin = d_scan < 1e20
    np.testing.assert_array_equal(d_kernel < 1e20, fin)
    # f32 both, but (a-b)^2 summed per feature vs the scan's expanded
    # |a|^2 + |b|^2 - 2ab: the local costs round differently
    np.testing.assert_allclose(d_kernel[fin], d_scan[fin], rtol=1e-4)
    rows = fin.all(1)
    np.testing.assert_array_equal(d_kernel[rows].argmin(1),
                                  d_scan[rows].argmin(1))


def test_kernel_ragged_lengths_on_device():
    """Ragged random lengths, B and K not multiples of the lane block."""
    from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded
    from dsp_asr.ops.dtw import dtw_batch

    rng = np.random.default_rng(3)
    b, k, t, u, f = 37, 13, 198, 198, 39
    q = jnp.asarray(rng.standard_normal((b, t, f)), jnp.float32)
    bank = jnp.asarray(rng.standard_normal((k, u, f)), jnp.float32)
    ql = jnp.asarray(rng.integers(1, t + 1, size=b), jnp.int32)
    bl = jnp.asarray(rng.integers(1, u + 1, size=k), jnp.int32)
    for slope in (None, "itakura"):
        c = DtwConfig(slope=slope)
        d_k = np.asarray(dtw_batch_fused_banded(q, ql, bank, bl, c))
        d_s = np.asarray(dtw_batch(q, ql, bank, bl, c))
        fin = d_s < 1e20
        np.testing.assert_array_equal(d_k < 1e20, fin)
        np.testing.assert_allclose(d_k[fin], d_s[fin], rtol=1e-4)


def test_routing_picks_kernel_on_gpu():
    cfg, mats, (q, qn, b, bn, _) = _problem(n_query=8)
    t = u = cfg.max_frames
    assert pl.dtw_impl(cfg.dtw, 8, 30, t, u) == "fused_banded"
    assert pl.dtw_impl(DtwConfig(band_frac=None), 8, 30, t, u) == "scan"
    feats = pl.extract_features(q, qn, mats, cfg)
    bank = pl.extract_features(b, bn, mats, cfg)
    routed = np.asarray(pl.dtw_pairs(feats.feats, feats.length, bank.feats,
                                     bank.length, cfg.dtw))
    scan = np.asarray(pl.dtw_pairs(
        feats.feats, feats.length, bank.feats, bank.length,
        dataclasses.replace(cfg.dtw, impl="scan")))
    fin = scan < 1e20
    np.testing.assert_array_equal(routed < 1e20, fin)
    np.testing.assert_allclose(routed[fin], scan[fin], rtol=1e-4)


def test_decode_connected_on_device_matches_vad_truth():
    """The VAD splitter and the level-building DP both recover a known
    3-word sequence (level building also on a gapless recording)."""
    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    truth = ["two", "zero", "one"]
    gapped = synth_connected(truth, seed=6)
    gapless = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                              lead_ms=(50.0, 60.0))
    assert rec.classify_connected([gapped], max_segments=4)[0] == truth
    assert rec.classify_connected([gapless], max_segments=4,
                                  method="level")[0] == truth


def test_grammar_and_nbest_on_device():
    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    truth = ["two", "zero", "one"]
    gapless = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                              lead_ms=(50.0, 60.0))
    assert rec.classify_connected(
        [gapless], max_segments=4, method="level",
        grammar={"no_repeat": True})[0] == truth
    got = rec.classify_connected(
        [gapless], max_segments=4, method="level",
        grammar={"start": ["zero", "one"]})[0]
    assert got and got[0] != "two"
    sigs = [synth_word(lab, 9) for lab in ["zero", "one", "two"]]
    hyps = rec.classify_nbest(sigs, n=3)
    assert [h[0][0] for h in hyps] == rec.classify_batch(sigs)


def test_keyword_spotting_on_device():
    from dsp_asr.io.dataset import synth_spotting_stream
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.spotter import KeywordSpotter

    cfg = PipelineConfig()
    rec = KnnDtwRecognizer(cfg)
    for lab in ["zero", "one"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    vocab = ["zero", "one", "three", "four", "five"]
    sig, truth = synth_spotting_stream({"zero", "one"}, vocab, seed=11,
                                       n_words=6)
    events, = KeywordSpotter(rec, threshold=30.0).spot([sig])
    hop = cfg.frontend.hop_len
    want = [(lab, s // hop, e // hop) for lab, s, e in truth]
    assert [ev[0] for ev in events] == [w[0] for w in want]
    for (lab, s, e, sc), (tl, ts, te) in zip(events, want):
        lo, hi = max(s, ts), min(e, te)
        assert hi - lo > 0.5 * (te - ts), (lab, (s, e), (ts, te))


def test_gmm_fit_precision_on_device():
    """The EM fit's moment GEMMs must run at f32 precision: in TF32 the
    E[x^2] - mean^2 variance update cancels and corrupts the models.
    Every keyword's spotting LLR must peak above the candidate floor at
    its planted location, as the CPU fit does."""
    from dsp_asr.config import HmmConfig
    from dsp_asr.io.dataset import make_corpus, synth_spotting_stream
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    from dsp_asr.models.spotter import HmmSpotter

    cfg = PipelineConfig()
    keywords = DIGITS[:3]
    rec = GmmHmmRecognizer(cfg, HmmConfig(n_states=4, n_mix=2, n_iter=4))
    rec.fit(make_corpus(keywords, n_per_word=3, seed=0))
    sig, truth = synth_spotting_stream(
        keywords, keywords + DIGITS[5:8], seed=5000, n_words=6)
    (llr, _), = HmmSpotter(rec).scores([sig])
    hop = cfg.frontend.hop_len
    labels = list(rec.labels)
    for lab, s, e in truth:
        peak = float(llr[labels.index(lab), s // hop: e // hop + 1].max())
        assert peak > -40.0, (lab, peak)
