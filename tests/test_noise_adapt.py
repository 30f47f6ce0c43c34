"""Automatic noise-mismatch compensation (ops/noise_adapt.py).

Pins the two primitives (noise-floor estimation from VAD-rejected
frames; log-add PMC mean mapping) and the headline recovery: a
clean-trained GMM-HMM collapsing under sigma=0.05 additive noise
recovers with ``noise_adapt=True`` and ZERO retraining data — the
automatic form of the manual --train-noise refit (VERDICT r3 #5,
docs/RESULTS.md connected-WER matrix).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.config import FrontendConfig, PipelineConfig, VadConfig
from dsp_asr.io.dataset import DIGITS, make_corpus, synth_connected, synth_word
from dsp_asr.ops import frontend as fe
from dsp_asr.ops.noise_adapt import (estimate_noise_cepstrum,
                                     pmc_adapt_means, pmc_supported)

CFG = FrontendConfig()
MATS = fe.make_matrices(CFG)


def test_pmc_silence_noise_is_identity():
    """Noise at the log floor adds nothing: D @ pinv(D) = I on the 13
    kept coefficients, and exp/log cancel, so means pass through."""
    rng = np.random.default_rng(0)
    means = jnp.asarray(0.5 * rng.standard_normal((2, 3, 4, 39)), jnp.float32)
    silent_logmel = np.full(CFG.n_mels, np.log(CFG.log_floor))
    d = np.asarray(MATS.dct_t.T)
    noise_c = jnp.asarray((silent_logmel @ d.T) * np.asarray(MATS.lifter),
                          jnp.float32)
    adapted = pmc_adapt_means(means, noise_c, MATS, CFG)
    np.testing.assert_allclose(np.asarray(adapted), np.asarray(means),
                               atol=1e-4)


def test_pmc_deltas_untouched_and_statics_move():
    rng = np.random.default_rng(1)
    means = jnp.asarray(rng.standard_normal((5, 39)), jnp.float32)
    # loud noise: flat log-mel at 0 -> statics must move
    loud_logmel = np.zeros(CFG.n_mels)
    d = np.asarray(MATS.dct_t.T)
    noise_c = jnp.asarray((loud_logmel @ d.T) * np.asarray(MATS.lifter),
                          jnp.float32)
    adapted = np.asarray(pmc_adapt_means(means, noise_c, MATS, CFG))
    np.testing.assert_array_equal(adapted[:, 13:], np.asarray(means)[:, 13:])
    assert np.max(np.abs(adapted[:, :13] - np.asarray(means)[:, :13])) > 0.1


def test_noise_estimate_matches_true_noise_cepstrum():
    """Rejected-frame estimate vs the cepstra of a noise-only signal at
    the same sigma: must agree closely in every static dimension."""
    rng = np.random.default_rng(2)
    sigma = 0.05
    x = np.stack([synth_word("zero", 0), synth_word("one", 1)])
    x = (x + sigma * rng.standard_normal(x.shape)).astype(np.float32)
    n = jnp.full(2, x.shape[1], jnp.int32)
    est, n_rej = estimate_noise_cepstrum(jnp.asarray(x), n, MATS, CFG,
                                         VadConfig())
    assert int(n_rej) > 50                     # lead/tail silence exists
    noise_only = (sigma * rng.standard_normal((2, x.shape[1]))
                  ).astype(np.float32)
    true_c = np.asarray(fe.mfcc(jnp.asarray(noise_only), CFG, MATS)
                        ).mean(axis=(0, 1))
    # atol=2: the two sides average DIFFERENT noise realizations, and
    # low-energy cepstral dims carry a few dB of sampling variance; the
    # end-to-end recovery test below is the functional check
    np.testing.assert_allclose(np.asarray(est), true_c, atol=2.0)


def test_noise_estimate_fallback_without_rejected_frames():
    """Speech wall-to-wall (no VAD-rejected frames): the low-energy
    fallback still returns a finite estimate."""
    x = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000.0)
    x = jnp.asarray(x[None], jnp.float32)
    est, n_rej = estimate_noise_cepstrum(x, jnp.asarray([16000], jnp.int32),
                                         MATS, CFG, VadConfig())
    assert np.isfinite(np.asarray(est)).all()


def test_pmc_supported_gates():
    assert pmc_supported(FrontendConfig()) is None
    assert "cmn" in pmc_supported(FrontendConfig(cmn=True))
    assert "energy" in pmc_supported(FrontendConfig(use_energy=True))
    assert "mfcc" in pmc_supported(FrontendConfig(feature_type="lpcc"))


def test_recognizer_rejects_unsupported_frontend():
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    cfg = PipelineConfig(frontend=FrontendConfig(cmn=True))
    rec = GmmHmmRecognizer(cfg, noise_adapt=True)
    rec.labels = ["zero"]
    rec.params = object()   # anything non-None
    with pytest.raises(ValueError, match="noise_adapt unavailable"):
        rec.classify_batch([synth_word("zero", 0)])


def test_hmm_noise_adapt_recovers_connected_wer():
    """The headline: clean-trained HMM at sigma=0.05 connected speech.
    Measured full-size (30 clips): 0.851 -> 0.000 WER.  This compact
    version must show the same collapse-and-recovery shape."""
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    from dsp_asr.pipeline import edit_distance

    cfg = PipelineConfig()
    corpus = make_corpus(n_per_word=3, seed=0, noise=0.005)
    rng = np.random.default_rng(100)
    truths, clips = [], []
    for i in range(8):
        labs = [DIGITS[int(rng.integers(10))]
                for _ in range(int(rng.integers(2, 5)))]
        truths.append(labs)
        clips.append(synth_connected(labs, 100 + i, noise=0.05))
    n_words = sum(len(t) for t in truths)

    hmm = GmmHmmRecognizer(cfg)
    hmm.fit(corpus)

    def wer():
        got = hmm.classify_connected(clips)
        return sum(edit_distance(g, t) for g, t in zip(got, truths)) / n_words

    base = wer()
    hmm.noise_adapt = True
    adapted = wer()
    assert base > 0.5                   # the documented collapse
    assert adapted <= 0.1               # automatic recovery, no retraining
    assert adapted < base / 4
