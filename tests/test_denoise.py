"""Spectral-subtraction denoising (FrontendConfig.denoise).

Covers the golden/jax parity of the Berouti subtraction, its
zero-padding exclusion property, the recognizer-level effect under
noise, and the unsupported-path guards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import FrontendConfig, PipelineConfig
from dsp_asr.golden import frontend as gold
from dsp_asr.io.dataset import DIGITS, make_corpus, synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops import frontend as fe

SS = FrontendConfig(denoise="spectral_subtraction")


def _noisy(x, snr_db, rng):
    p = float(np.mean(np.square(x)))
    pn = p / (10.0 ** (snr_db / 10.0))
    return (x + rng.standard_normal(len(x)) * np.sqrt(pn)).astype(np.float32)


def test_spectral_subtract_matches_golden():
    rng = np.random.default_rng(0)
    pspec = rng.random((50, 257)).astype(np.float32) * \
        (0.1 + rng.random((50, 1)).astype(np.float32))
    want = gold.spectral_subtract(pspec.astype(np.float64), SS)
    got = np.asarray(fe.spectral_subtract(jnp.asarray(pspec), SS))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_mfcc_with_denoise_matches_golden():
    rng = np.random.default_rng(1)
    x = _noisy(synth_word("three", 7), 15, rng)
    want = gold.mfcc(x.astype(np.float64), SS)
    got = np.asarray(fe.mfcc(jnp.asarray(x), SS, use_fft=True))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_zero_frames_excluded_from_noise_estimate():
    """Appending digital-silence frames must not change the result on
    the valid frames (padding invariance of the noise estimate)."""
    rng = np.random.default_rng(2)
    pspec = (rng.random((40, 129)) + 0.05).astype(np.float32)
    padded = np.concatenate([pspec, np.zeros((20, 129), np.float32)])
    a = np.asarray(fe.spectral_subtract(jnp.asarray(pspec), SS))
    b = np.asarray(fe.spectral_subtract(jnp.asarray(padded), SS))[:40]
    # XLA reduction order differs between static shapes -> last-ulp noise
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-7)


def test_all_silent_input_is_noop():
    z = np.zeros((30, 129), np.float32)
    out = np.asarray(fe.spectral_subtract(jnp.asarray(z), SS))
    np.testing.assert_array_equal(out, z)
    np.testing.assert_array_equal(gold.spectral_subtract(z.astype(float), SS),
                                  z)


def test_subtraction_reduces_noise_floor():
    """In noise-only frames the subtracted power collapses to the
    spectral floor (ss_beta * P)."""
    rng = np.random.default_rng(3)
    noise = (0.9 + 0.2 * rng.random((60, 129))).astype(np.float32)
    out = np.asarray(fe.spectral_subtract(jnp.asarray(noise), SS))
    # alpha=2 over-subtraction drives ~uniform noise to the beta floor
    assert np.mean(out <= SS.ss_beta * noise + 1e-6) > 0.95


def test_recognizer_with_denoise_under_noise():
    """Denoised front-end stays accurate on clean AND noisy queries (the
    banded default loses accuracy in noise from VAD drift; subtraction
    must not make it worse)."""
    cfg = dataclasses.replace(PipelineConfig(), frontend=SS)
    train = make_corpus(DIGITS[:5], n_per_word=3, seed=0)
    test = make_corpus(DIGITS[:5], n_per_word=2, seed=9000)
    rec = KnnDtwRecognizer(cfg)
    for lab, sigs in train.items():
        rec.enroll(lab, sigs)
    assert rec.evaluate(test)["accuracy"] >= 0.9
    rng = np.random.default_rng(1)
    noisy = {lab: [_noisy(x, 10, rng) for x in xs]
             for lab, xs in test.items()}
    assert rec.evaluate(noisy)["accuracy"] >= 0.8


def test_unsupported_paths_raise():
    x = jnp.zeros(4000, jnp.float32)
    from dsp_asr.ops.lpc import lpcc
    with pytest.raises(ValueError, match="denoise"):
        lpcc(x, dataclasses.replace(SS, feature_type="lpcc"))
    from dsp_asr.ops import streaming as st
    bogus = dataclasses.replace(SS, denoise="bogus")
    with pytest.raises(ValueError, match="denoise"):
        st.process_chunk(st.init_state(bogus, 1600), jnp.zeros(1600),
                         fe.make_matrices(bogus), bogus, chunk_len=1600)
    with pytest.raises(ValueError, match="denoise"):
        fe.mfcc(x, dataclasses.replace(SS, denoise="bogus"))


def test_checkpoint_refuses_mismatched_ss_params(tmp_path):
    import os

    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    cfg = dataclasses.replace(PipelineConfig(), frontend=SS)
    rec = KnnDtwRecognizer(cfg)
    rec.enroll("one", [synth_word("one", 0)])
    p = os.path.join(tmp_path, "bank.npz")
    rec.save(p)
    other = dataclasses.replace(
        cfg, frontend=dataclasses.replace(SS, ss_alpha=5.0))
    with pytest.raises(ValueError, match="front-end"):
        KnnDtwRecognizer.load(p, other)
    KnnDtwRecognizer.load(p, cfg)          # matching params still load
