"""LPC/LPCC tests: Levinson-Durbin vs direct Toeplitz solve, jax vs golden,
end-to-end LPCC recognition."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import FrontendConfig, PipelineConfig
from dsp_asr.golden import lpc as glpc
from dsp_asr.io.dataset import synth_word
from dsp_asr.ops import lpc as jlpc

CFG = FrontendConfig(feature_type="lpcc")


def test_levinson_matches_toeplitz_solve():
    """Golden Levinson-Durbin == direct linear solve of the normal eqs."""
    rng = np.random.default_rng(0)
    # smooth (AR-like) frames so the Toeplitz system is well conditioned
    t, length, p = 5, 400, 12
    frames = np.cumsum(rng.standard_normal((t, length)), axis=1)
    frames -= frames.mean(axis=1, keepdims=True)
    r = glpc.autocorrelation(frames, p)
    a, e = glpc.levinson_durbin(r, p)
    for i in range(t):
        toep = np.array([[r[i, abs(m - n)] for n in range(p)] for m in range(p)])
        want = np.linalg.solve(toep, r[i, 1 : p + 1])
        np.testing.assert_allclose(a[i], want, rtol=1e-6, atol=1e-8)
        # gain identity: E = r0 - sum a_k r_k
        np.testing.assert_allclose(e[i], r[i, 0] - a[i] @ r[i, 1 : p + 1],
                                   rtol=1e-6)


def test_jax_lpc_matches_golden():
    rng = np.random.default_rng(1)
    frames = np.cumsum(rng.standard_normal((7, 400)), axis=1).astype(np.float32)
    frames -= frames.mean(axis=1, keepdims=True)
    r_g = glpc.autocorrelation(frames.astype(np.float64), 12)
    r_j = np.asarray(jlpc.autocorrelation(jnp.asarray(frames), 12))
    np.testing.assert_allclose(r_j, r_g, rtol=1e-4)
    a_g, e_g = glpc.levinson_durbin(r_g, 12)
    a_j, e_j = jlpc.levinson_durbin(jnp.asarray(r_j), 12)
    np.testing.assert_allclose(np.asarray(a_j), a_g, rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(e_j), e_g, rtol=5e-3)


def test_jax_lpcc_matches_golden_end_to_end():
    x = synth_word("four", 2, max_samples=8000)
    want = glpc.lpcc(x, CFG)
    got = np.asarray(jlpc.lpcc(jnp.asarray(x), CFG))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_lpcc_recognizer_end_to_end():
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    cfg = PipelineConfig(frontend=FrontendConfig(feature_type="lpcc"))
    rec = KnnDtwRecognizer(cfg)
    labels = ["zero", "one", "two"]
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    test = {lab: [synth_word(lab, 70 + i) for i in range(2)] for lab in labels}
    assert rec.evaluate(test)["accuracy"] >= 5 / 6
