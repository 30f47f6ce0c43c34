"""Sanity and property tests for the golden numpy oracle itself.

The oracle is the parity target for the whole framework (SURVEY.md §4.1),
so its own conventions are pinned here with known-answer and property
tests before anything is tested against it.
"""

import numpy as np
import pytest

from dsp_asr.config import DtwConfig, FrontendConfig, VadConfig
from dsp_asr import golden
from dsp_asr.io.dataset import synth_word


def test_preemphasis_known_answer():
    x = np.array([1.0, 2.0, 3.0, 4.0])
    y = golden.preemphasis(x, 0.5)
    np.testing.assert_allclose(y, [1.0, 1.5, 2.0, 2.5])


def test_framing_counts_and_content():
    x = np.arange(1000, dtype=np.float64)
    frames = golden.frame_signal(x, 400, 160)
    assert frames.shape == (4, 400)  # 1 + (1000-400)//160 = 4
    np.testing.assert_array_equal(frames[0], x[0:400])
    np.testing.assert_array_equal(frames[3], x[480:880])
    assert golden.frame_signal(x[:399], 400, 160).shape == (0, 400)


def test_hamming_endpoints():
    w = golden.hamming(400)
    assert w.shape == (400,)
    np.testing.assert_allclose(w[0], 0.08, atol=1e-12)
    np.testing.assert_allclose(w[-1], 0.08, atol=1e-12)
    np.testing.assert_allclose(w[199], w[200], atol=1e-6)  # symmetric-ish peak


def test_power_spectrum_parseval_tone():
    # pure tone at an exact FFT bin concentrates power there
    n_fft = 512
    t = np.arange(400)
    x = np.sin(2 * np.pi * 16 * t / n_fft)  # bin 16
    p = golden.power_spectrum(x[None, :], n_fft)[0]
    assert p.shape == (257,)
    assert np.argmax(p) == 16


def test_mel_filterbank_shape_and_coverage():
    fb = golden.mel_filterbank(26, 512, 16000)
    assert fb.shape == (26, 257)
    assert np.all(fb >= 0)
    assert np.all(fb.max(axis=1) > 0)       # every filter non-empty
    assert fb.max() <= 1.0 + 1e-12           # unnormalised triangles peak at 1
    # mel scale known answer: 1000 Hz ~ 999.99 mel
    np.testing.assert_allclose(golden.frontend.hz_to_mel(1000.0), 999.9855, atol=1e-3)


def test_dct_matrix_orthonormal():
    d = golden.dct_matrix(26, 26)
    np.testing.assert_allclose(d @ d.T, np.eye(26), atol=1e-12)


def test_mfcc_shape_and_finite():
    cfg = FrontendConfig()
    x = synth_word("three", 0)
    c = golden.mfcc(x, cfg)
    assert c.shape == (198, 13)
    assert np.all(np.isfinite(c))
    f = golden.mfcc_with_deltas(x, cfg)
    assert f.shape == (198, 39)


def test_deltas_constant_input_is_zero():
    feats = np.ones((10, 13))
    np.testing.assert_allclose(golden.deltas(feats, 2), 0.0)


def test_deltas_linear_ramp_slope():
    # linear ramp c[t] = t -> delta = 1 in the interior
    feats = np.arange(20, dtype=np.float64)[:, None] * np.ones((1, 3))
    d = golden.deltas(feats, 2)
    np.testing.assert_allclose(d[4:-4], 1.0)


def test_vad_finds_speech_region():
    sr = 16000
    x = np.zeros(32000)
    rng = np.random.default_rng(0)
    x += 0.001 * rng.standard_normal(32000)
    t = np.arange(8000)
    x[8000:16000] += 0.5 * np.sin(2 * np.pi * 440 * t / sr)
    start, end, found = golden.detect_endpoints(x)
    assert found
    # speech spans samples 8000..16000 -> frames ~50..97
    assert 40 <= start <= 52
    assert 95 <= end <= 115


def test_vad_silence_returns_whole_signal():
    rng = np.random.default_rng(1)
    x = 0.0005 * rng.standard_normal(16000)
    start, end, found = golden.detect_endpoints(x)
    assert not found
    assert start == 0 and end == 98  # 1+(16000-400)//160


def test_dtw_identity_is_zero():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((17, 13))
    assert golden.dtw_distance(a, a) < 1e-12


def test_dtw_known_answer_small():
    # 1-D sequences, squared cost: classic hand-checkable table
    a = np.array([[0.0], [1.0], [2.0]])
    b = np.array([[0.0], [2.0]])
    d = golden.dtw_distance(a, b, DtwConfig(squared=True))
    # cost: [[0,4],[1,1],[4,0]] -> dp: [[0,4],[1,1],[5,1]] -> 1/(3+2)
    np.testing.assert_allclose(d, 1.0 / 5.0)


def test_dtw_symmetry():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((12, 5))
    b = rng.standard_normal((19, 5))
    noband = DtwConfig(band_frac=None)
    np.testing.assert_allclose(golden.dtw_distance(a, b, noband),
                               golden.dtw_distance(b, a, noband))


def test_dtw_path_properties():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((10, 4))
    b = rng.standard_normal((14, 4))
    _, path = golden.dtw_distance(a, b, return_path=True)
    assert path[0] == (0, 0) and path[-1] == (9, 13)
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        assert (i1 - i0, j1 - j0) in {(0, 1), (1, 0), (1, 1)}


def test_viterbi_known_answer():
    # 2-state toy: staying in state 0 then switching
    log_pi = np.log(np.array([0.9, 0.1]))
    log_a = np.log(np.array([[0.7, 0.3], [0.1, 0.9]]))
    log_b = np.log(np.array([[0.9, 0.1], [0.8, 0.2], [0.1, 0.9], [0.1, 0.9]]))
    ll, path = golden.viterbi_log(log_pi, log_a, log_b)
    np.testing.assert_array_equal(path, [0, 0, 1, 1])
    expect = (np.log(0.9) + np.log(0.9) + np.log(0.7) + np.log(0.8)
              + np.log(0.3) + np.log(0.9) + np.log(0.9) + np.log(0.9))
    np.testing.assert_allclose(ll, expect, rtol=1e-12)


def test_forward_geq_viterbi():
    rng = np.random.default_rng(4)
    s, t = 4, 11
    log_pi = np.log(rng.dirichlet(np.ones(s)))
    log_a = np.log(rng.dirichlet(np.ones(s), size=s))
    log_b = rng.standard_normal((t, s))
    vit, _ = golden.viterbi_log(log_pi, log_a, log_b)
    fwd = golden.forward_log(log_pi, log_a, log_b)
    assert fwd >= vit - 1e-10


def test_golden_self_classification():
    from dsp_asr.golden import classify
    from dsp_asr.golden.frontend import mfcc_with_deltas
    labels = ["zero", "one", "two"]
    bank = [(lab, mfcc_with_deltas(synth_word(lab, 0))) for lab in labels]
    for lab in labels:
        feats = mfcc_with_deltas(synth_word(lab, 1))  # different utterance
        pred, _ = classify(feats, bank, DtwConfig(band_frac=None))
        assert pred == lab
