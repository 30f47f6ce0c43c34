"""JAX front-end ops vs golden oracle parity (SURVEY.md §4.2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import FrontendConfig
from dsp_asr import golden
from dsp_asr.io.dataset import synth_word
from dsp_asr.ops import frontend as fe

CFG = FrontendConfig()


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    tone = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32)
    chirp = np.sin(2 * np.pi * (100 + 3000 * np.linspace(0, 1, 16000) ** 2)
                   * np.linspace(0, 1, 16000)).astype(np.float32)
    noise = rng.standard_normal(16000).astype(np.float32)
    word = synth_word("five", 7, max_samples=16000)
    clipped = np.clip(3.0 * word, -1.0, 1.0)
    return [tone, chirp, noise, word, clipped]


def test_preemphasis_parity(signals):
    for x in signals:
        got = np.asarray(fe.preemphasis(jnp.asarray(x), CFG.preemphasis))
        want = golden.preemphasis(x, CFG.preemphasis)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_frame_parity(signals):
    x = signals[0]
    got = np.asarray(fe.frame(jnp.asarray(x), CFG.frame_len, CFG.hop_len))
    want = golden.frame_signal(x, CFG.frame_len, CFG.hop_len)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_frame_batched():
    x = np.random.default_rng(1).standard_normal((3, 4000)).astype(np.float32)
    got = np.asarray(fe.frame(jnp.asarray(x), 400, 160))
    for b in range(3):
        np.testing.assert_allclose(
            got[b], golden.frame_signal(x[b], 400, 160), rtol=1e-6)


@pytest.mark.parametrize("use_fft", [True, False])
def test_mfcc_parity(signals, use_fft):
    """MFCC matches the float64 oracle via both the exact-FFT path and the
    production DFT-matmul path."""
    for x in signals:
        got = np.asarray(fe.mfcc(jnp.asarray(x), CFG, use_fft=use_fft))
        want = golden.mfcc(x, CFG)
        assert got.shape == want.shape
        # f32 vs f64 through log: tolerances are on the final coefficients
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_mfcc_energy_variant(signals):
    cfg = FrontendConfig(use_energy=True)
    x = signals[3]
    got = np.asarray(fe.mfcc(jnp.asarray(x), cfg))
    want = golden.mfcc(x, cfg)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_deltas_parity(signals):
    feats = golden.mfcc(signals[3], CFG)
    got = np.asarray(fe.deltas(jnp.asarray(feats, dtype=jnp.float32), CFG.delta_width))
    want = golden.deltas(feats, CFG.delta_width)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_masked_deltas_equals_unpadded():
    """Padding-invariance: deltas of a padded sequence with true length L
    match deltas of the unpadded sequence (SURVEY.md §4.6)."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((20, 13)).astype(np.float32)
    lengths = [20, 13, 5]
    padded = np.zeros((32, 13), dtype=np.float32)
    for length in lengths:
        padded[:] = rng.standard_normal((32, 13))
        padded[:length] = feats[:length]
        got = np.asarray(fe.masked_deltas(jnp.asarray(padded), jnp.asarray(length)))
        want = golden.deltas(feats[:length].astype(np.float64), 2)
        np.testing.assert_allclose(got[:length], want, rtol=1e-4, atol=1e-5)


def test_full_feature_stack_parity(signals):
    x = signals[3]
    c = fe.mfcc(jnp.asarray(x), CFG)
    got = np.asarray(fe.add_deltas(c, CFG))
    want = golden.mfcc_with_deltas(x, CFG)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("cfg", [
    FrontendConfig(sample_rate=8000, frame_len=200, hop_len=80, n_fft=256),
    FrontendConfig(n_fft=1024, n_mels=40, n_mfcc=20, lifter=0),
    FrontendConfig(frame_len=512, hop_len=256),
])
def test_mfcc_parity_nondefault_configs(cfg):
    """Golden<->JAX parity holds across the config space, not just defaults."""
    rng = np.random.default_rng(11)
    n = cfg.sample_rate  # 1 second
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    got = np.asarray(fe.mfcc(jnp.asarray(x), cfg, fe.make_matrices(cfg)))
    want = golden.mfcc(x, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
