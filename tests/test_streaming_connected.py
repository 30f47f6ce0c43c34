"""Online gapless connected decoding (models/streaming.py:
StreamingConnectedRecognizer + ops/level_building.py streaming DP)."""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.config import PipelineConfig
from dsp_asr.io.dataset import synth_connected, synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.models.streaming import (StreamingConnectedRecognizer,
                                      _np_deltas)
from dsp_asr.ops import frontend as fe


def test_np_deltas_matches_jax_deltas():
    rng = np.random.default_rng(3)
    c = rng.standard_normal((17, 13)).astype(np.float32)
    np.testing.assert_allclose(_np_deltas(c, 2),
                               np.asarray(fe.deltas(jnp.asarray(c), 2)),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def rec():
    r = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        r.enroll(lab, [synth_word(lab, i) for i in range(2)])
    return r


def _run_stream(sc, sig, chunk_len):
    pad = (-len(sig)) % chunk_len
    sig = np.concatenate([sig, np.zeros(pad, np.float32)])
    events, hyps = [], []
    for lo in range(0, len(sig), chunk_len):
        events += sc.feed(sig[lo:lo + chunk_len])
        h = sc.hypothesis()
        if h:
            hyps.append(h)
    events += sc.flush()
    return events, hyps


def test_streaming_gapless_recovers_sequence(rec):
    """The capability: words butted together with no gaps, decoded
    ONLINE — one event with the full word sequence, and mid-utterance
    hypotheses that build toward it."""
    truth = ["two", "zero", "one"]
    sig = synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                          lead_ms=(120.0, 130.0))
    sc = StreamingConnectedRecognizer(rec, chunk_len=1600, max_levels=4)
    events, hyps = _run_stream(sc, sig, 1600)
    assert len(events) == 1
    labels, start, end = events[0]
    assert labels == truth
    assert 0 <= start < end
    assert hyps and hyps[-1]                  # a running hypothesis existed
    assert all(h == truth[: len(h)] for h in hyps if h)   # prefixes


def test_streaming_matches_offline_level_decode(rec):
    """The streamed decode agrees with the batch level decoder on the
    same recording (same DP, same bank; boundary conditions differ only
    by the causal-vs-global VAD window)."""
    truth = ["one", "two"]
    sig = synth_connected(truth, seed=11, gap_ms=(0.0, 1.0),
                          lead_ms=(120.0, 130.0))
    offline = rec.classify_connected([sig], max_segments=4,
                                     method="level")[0]
    sc = StreamingConnectedRecognizer(rec, chunk_len=1600, max_levels=4)
    events, _ = _run_stream(sc, sig, 1600)
    assert [w for ev in events for w in ev[0]] == offline == truth


def test_streaming_gapped_words_one_utterance_per_gap(rec):
    """Long silences still split utterances (the causal VAD's job);
    each burst decodes through the same DP."""
    sig = np.concatenate([
        synth_connected(["zero"], seed=21, lead_ms=(150.0, 160.0)),
        np.zeros(8000, np.float32),
        synth_connected(["two", "one"], seed=22, gap_ms=(0.0, 1.0),
                        lead_ms=(150.0, 160.0)),
        np.zeros(4000, np.float32)])
    sc = StreamingConnectedRecognizer(rec, chunk_len=1600, max_levels=4)
    events, _ = _run_stream(sc, sig, 1600)
    assert [ev[0] for ev in events] == [["zero"], ["two", "one"]]
    assert events[0][2] <= events[1][1]       # non-overlapping windows


def test_streaming_connected_rejects_cmn():
    import dataclasses

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, cmn=True))
    r = KnnDtwRecognizer(cfg)
    r.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingConnectedRecognizer(r)


def test_streaming_reset_reuses_cleanly(rec):
    sig = synth_connected(["one"], seed=31, lead_ms=(150.0, 160.0))
    sc = StreamingConnectedRecognizer(rec, chunk_len=1600, max_levels=3)
    ev1, _ = _run_stream(sc, sig, 1600)
    sc.reset()
    ev2, _ = _run_stream(sc, sig, 1600)
    assert [e[0] for e in ev1] == [e[0] for e in ev2] == [["one"]]
