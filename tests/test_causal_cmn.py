"""Causal (prefix-stable) cepstral mean normalization — round 5,
VERDICT r4 #6: the streaming surfaces' CMN mode.

Properties pinned here:
  * ops/frontend.causal_cmn (associative_scan) == golden loop spec
  * prefix stability (the property utterance-mode CMN lacks)
  * convergence toward the utterance mean on stationary channels
  * device pipeline parity vs the golden pipeline under cmn_mode="causal"
  * streaming surfaces accept causal cmn and agree with offline
  * checkpoint signature catches a cmn-mode mismatch
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.golden import pipeline as gpl
from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig
from dsp_asr.golden.frontend import causal_cmn as causal_cmn_np
from dsp_asr.io.dataset import synth_connected, synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.models.streaming import (StreamingConnectedRecognizer,
                                      StreamingRecognizer)
from dsp_asr.ops import frontend as fe


def _causal_cfg(**kw):
    cfg = PipelineConfig()
    f = dataclasses.replace(cfg.frontend, cmn=True, cmn_mode="causal", **kw)
    return dataclasses.replace(cfg, frontend=f)


def test_causal_cmn_matches_golden_loop():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((137, 13)).astype(np.float32)
    got = np.asarray(fe.causal_cmn(jnp.asarray(c), 0.995))
    np.testing.assert_allclose(got, causal_cmn_np(c, 0.995),
                               rtol=2e-5, atol=2e-5)


def test_causal_cmn_batched_axes():
    rng = np.random.default_rng(1)
    c = rng.standard_normal((4, 61, 13)).astype(np.float32)
    got = np.asarray(fe.causal_cmn(jnp.asarray(c), 0.98))
    for b in range(4):
        np.testing.assert_allclose(got[b], causal_cmn_np(c[b], 0.98),
                                   rtol=2e-5, atol=2e-5)


def test_causal_cmn_prefix_stable():
    """out[:t] must be identical whether or not frames past t exist —
    the property that makes the mode streamable."""
    rng = np.random.default_rng(2)
    c = rng.standard_normal((90, 13)).astype(np.float32)
    full = np.asarray(fe.causal_cmn(jnp.asarray(c), 0.995))
    for t in (1, 7, 45, 89):
        pre = np.asarray(fe.causal_cmn(jnp.asarray(c[:t]), 0.995))
        np.testing.assert_allclose(pre, full[:t], rtol=1e-6, atol=1e-6)


def test_causal_cmn_converges_to_utterance_mean():
    """Stationary channel: the running mean the late frames subtract
    approaches the utterance mean (what cmn_mode='utterance' uses)."""
    rng = np.random.default_rng(3)
    base = 5.0 * rng.standard_normal(13).astype(np.float32)
    c = base + 0.1 * rng.standard_normal((800, 13)).astype(np.float32)
    out = np.asarray(fe.causal_cmn(jnp.asarray(c), 0.995))
    subtracted = c - out                       # the per-frame mean m_t
    utt_mean = c.mean(axis=0)
    # after ~3 time constants (600 frames @ alpha=.995) the EMA sits on
    # the channel mean to well within the noise scale
    late = subtracted[700:]
    assert np.abs(late - utt_mean).max() < 0.05, \
        np.abs(late - utt_mean).max()


def test_causal_cmn_first_frame_is_zeroed():
    """Bias correction makes m_0 = c_0 exactly, so frame 0 maps to 0 —
    same as utterance CMN on a length-1 utterance."""
    c = np.asarray([[3.0, -2.0, 0.5]], np.float32)
    out = np.asarray(fe.causal_cmn(jnp.asarray(c), 0.995))
    np.testing.assert_allclose(out, 0.0, atol=1e-6)


def test_pipeline_causal_cmn_matches_golden():
    """Device extract_features under cmn_mode='causal' == golden
    pipeline (same VAD window, causal mean, deltas)."""
    cfg = _causal_cfg()
    mats = fe.make_matrices(cfg.frontend)
    for seed, word in enumerate(["one", "five", "nine"]):
        x = synth_word(word, seed)
        want, t_want = gpl.extract_features(x, cfg)
        xs, ns = pl.pad_signals([x], cfg.max_samples)
        feats = pl.extract_features(jnp.asarray(xs), jnp.asarray(ns),
                                    mats, cfg)
        t = int(feats.length[0])
        assert t == min(t_want, cfg.max_frames)
        np.testing.assert_allclose(np.asarray(feats.feats[0, :t]),
                                   want[:t], rtol=2e-3, atol=2e-3)


def test_unknown_cmn_mode_raises():
    cfg = _causal_cfg()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, cmn_mode="global"))
    mats = fe.make_matrices(cfg.frontend)
    xs, ns = pl.pad_signals([synth_word("one", 0)], cfg.max_samples)
    with pytest.raises(ValueError, match="cmn_mode"):
        pl.extract_features(jnp.asarray(xs), jnp.asarray(ns), mats, cfg)


def test_recognizer_end_to_end_causal_cmn():
    """Enroll + classify entirely under causal cmn: the feature space is
    self-consistent, so accuracy on distinct synthetic words holds."""
    cfg = _causal_cfg()
    rec = KnnDtwRecognizer(cfg)
    labels = ["zero", "one", "two"]
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    queries = [synth_word(lab, 7 + i) for i, lab in enumerate(labels)]
    assert rec.classify_batch(queries) == labels


CHUNK = 1600


def test_streaming_recognizer_causal_cmn():
    """StreamingRecognizer under causal cmn classifies like offline
    (the guard test for VERDICT r4 #6's first surface)."""
    cfg = _causal_cfg()
    rec = KnnDtwRecognizer(cfg)
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])

    rng = np.random.default_rng(5)
    sig = 0.002 * rng.standard_normal(16000 * 3)
    w = synth_word("one", 77, max_samples=24000)
    sig[8000:8000 + len(w)] += w
    sig = sig.astype(np.float32)

    stream = StreamingRecognizer(rec, CHUNK)
    events = []
    for c in range(len(sig) // CHUNK):
        events += stream.feed(sig[c * CHUNK:(c + 1) * CHUNK])
    events += stream.flush()
    assert [e[0] for e in events] == ["one"], events


def _run_stream(sc, sig, chunk_len):
    pad = (-len(sig)) % chunk_len
    sig = np.concatenate([sig, np.zeros(pad, np.float32)])
    events = []
    for lo in range(0, len(sig), chunk_len):
        events += sc.feed(sig[lo:lo + chunk_len])
    events += sc.flush()
    return events


def test_streaming_connected_causal_cmn_matches_offline():
    """The online gapless DP accepts causal cmn (the narrowed guard) and
    agrees with the offline level decoder under the same config."""
    cfg = _causal_cfg()
    rec = KnnDtwRecognizer(cfg)
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    truth = ["two", "zero", "one"]
    sig = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                          lead_ms=(120.0, 130.0))
    offline = rec.classify_connected([sig], max_segments=4,
                                     method="level")[0]
    sc = StreamingConnectedRecognizer(rec, chunk_len=CHUNK, max_levels=4)
    events = _run_stream(sc, sig, CHUNK)
    got = [w for ev in events for w in ev[0]]
    assert got == offline == truth


def test_streaming_connected_still_rejects_utterance_cmn():
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, cmn=True))
    r = KnnDtwRecognizer(cfg)
    r.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingConnectedRecognizer(r)


def test_checkpoint_signature_catches_cmn_mode_mismatch(tmp_path):
    cfg = _causal_cfg()
    rec = KnnDtwRecognizer(cfg)
    rec.enroll("zero", [synth_word("zero", 0)])
    path = str(tmp_path / "bank.npz")
    rec.save(path)

    utt_cfg = PipelineConfig()
    utt_cfg = dataclasses.replace(
        utt_cfg, frontend=dataclasses.replace(utt_cfg.frontend, cmn=True))
    with pytest.raises(ValueError, match="front-end"):
        KnnDtwRecognizer.load(path, utt_cfg)
    # and the matching config round-trips
    back = KnnDtwRecognizer.load(path, cfg)
    assert back.classify_batch([synth_word("zero", 3)]) == ["zero"]
