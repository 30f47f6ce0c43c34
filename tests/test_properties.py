"""Property/fuzz tests (SURVEY.md §4.6): invariances that must hold for
randomly drawn inputs, not just curated cases."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dsp_asr.config import DtwConfig, FrontendConfig, PipelineConfig, VadConfig
from dsp_asr import golden
from dsp_asr.io.dataset import synth_word
from dsp_asr.ops import dtw as jdtw
from dsp_asr.ops import frontend as fe
from dsp_asr.ops import vad as jvad

FCFG = FrontendConfig()


def test_vad_parity_fuzz():
    """Random signals: jax VAD == golden VAD exactly (30 draws)."""
    rng = np.random.default_rng(0)
    for trial in range(30):
        kind = trial % 3
        n = int(rng.integers(1600, 32001))
        x = (0.002 * rng.standard_normal(n)).astype(np.float32)
        if kind == 0:   # one burst
            s = int(rng.integers(0, max(1, n - 4000)))
            d = int(rng.integers(2000, 6000))
            t = np.arange(min(d, n - s))
            x[s:s + len(t)] += 0.4 * np.sin(2 * np.pi * rng.uniform(200, 2000)
                                            * t / 16000)
        elif kind == 1:  # two bursts
            for _ in range(2):
                s = int(rng.integers(0, max(1, n - 3000)))
                t = np.arange(min(2500, n - s))
                x[s:s + len(t)] += 0.3 * np.sin(2 * np.pi * 500 * t / 16000)
        want = golden.detect_endpoints(x, FCFG, VadConfig())
        s_, e_, f_ = jvad.detect_endpoints(jnp.asarray(x), FCFG, VadConfig())
        assert (int(s_), int(e_), bool(f_)) == want, f"trial {trial}"


def test_dtw_masked_fuzz():
    """Random padded problems: masked DTW == golden on sliced arrays."""
    rng = np.random.default_rng(1)
    for trial in range(15):
        t, u, f = (int(rng.integers(2, 40)), int(rng.integers(2, 40)),
                   int(rng.integers(1, 20)))
        a = rng.standard_normal((40, f)).astype(np.float32)
        b = rng.standard_normal((40, f)).astype(np.float32)
        la, lb = int(rng.integers(1, t + 1)), int(rng.integers(1, u + 1))
        noband = DtwConfig(band_frac=None)
        want = golden.dtw_distance(a[:la], b[:lb], noband)
        got = float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(la), jnp.asarray(lb),
                                      noband))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"trial {trial} ({la},{lb},{f})")


def test_mfcc_numerically_robust():
    """Extreme inputs never produce non-finite features."""
    cases = [
        np.zeros(8000, np.float32),                      # silence
        np.full(8000, 1e-8, np.float32),                 # near-zero DC
        np.full(8000, 0.999, np.float32),                # hard DC
        np.sign(np.sin(np.arange(8000) * 0.7)).astype(np.float32),  # square
        (np.random.default_rng(0).standard_normal(8000) * 1e-6).astype(np.float32),
    ]
    for i, x in enumerate(cases):
        c = np.asarray(fe.mfcc(jnp.asarray(x), FCFG))
        assert np.isfinite(c).all(), f"case {i}"


def test_dtw_metric_like_properties_fuzz():
    """d(a,b) >= 0 and d is symmetric for random inputs."""
    rng = np.random.default_rng(2)
    for _ in range(10):
        a = rng.standard_normal((17, 6)).astype(np.float32)
        b = rng.standard_normal((23, 6)).astype(np.float32)
        noband = DtwConfig(band_frac=None)
        dab = float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(b),
                                      cfg=noband))
        dba = float(jdtw.dtw_distance(jnp.asarray(b), jnp.asarray(a),
                                      cfg=noband))
        assert dab >= 0
        np.testing.assert_allclose(dab, dba, rtol=1e-5)


def test_leading_silence_invariance():
    """Shifting a word later in the padded window keeps the label (VAD
    re-anchors the features)."""
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, 0)])
    rng = np.random.default_rng(3)
    base = synth_word("one", 9, max_samples=16000)
    for shift in (0, 1000, 4000, 9000):
        x = np.zeros(32000, np.float32)
        x += 0.001 * rng.standard_normal(32000).astype(np.float32)
        x[shift:shift + 16000] += base
        assert rec.recognize(x) == "one", f"shift {shift}"


def test_resampled_8k_wav_roundtrip(tmp_path):
    """A 8 kHz recording resampled to 16 kHz still classifies correctly."""
    from dsp_asr.io.wav import read_wav, write_wav
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one"]:
        rec.enroll(lab, [synth_word(lab, 0)])
    x16 = synth_word("one", 5)
    x8 = x16[::2]                                 # crude 8 kHz downsample
    p = str(tmp_path / "w8.wav")
    write_wav(p, 8000, x8)
    sr, y = read_wav(p, target_sr=16000)
    assert sr == 16000 and len(y) == len(x8) * 2
    assert rec.recognize(y) == "one"
