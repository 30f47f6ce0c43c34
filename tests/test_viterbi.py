"""Batched log-space Viterbi/forward scans vs golden loop DP."""

import numpy as np
import jax.numpy as jnp

from dsp_asr import golden
from dsp_asr.ops import viterbi as jvit


def _random_hmm(rng, s):
    log_pi = np.log(rng.dirichlet(np.ones(s)))
    log_a = np.log(rng.dirichlet(np.ones(s), size=s))
    return log_pi.astype(np.float32), log_a.astype(np.float32)


def test_viterbi_score_parity():
    rng = np.random.default_rng(0)
    s, t = 5, 23
    log_pi, log_a = _random_hmm(rng, s)
    log_b = rng.standard_normal((t, s)).astype(np.float32)
    want, _ = golden.viterbi_log(log_pi, log_a, log_b)
    got = float(jvit.viterbi_score(jnp.asarray(log_pi), jnp.asarray(log_a),
                                   jnp.asarray(log_b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_viterbi_decode_path_parity():
    rng = np.random.default_rng(1)
    s, t = 4, 17
    log_pi, log_a = _random_hmm(rng, s)
    log_b = rng.standard_normal((t, s)).astype(np.float32)
    want_ll, want_path = golden.viterbi_log(log_pi, log_a, log_b)
    got_ll, got_path = jvit.viterbi_decode(
        jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b))
    np.testing.assert_allclose(float(got_ll), want_ll, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_path), want_path)


def test_forward_score_parity():
    rng = np.random.default_rng(2)
    s, t = 6, 31
    log_pi, log_a = _random_hmm(rng, s)
    log_b = rng.standard_normal((t, s)).astype(np.float32)
    want = golden.forward_log(log_pi, log_a, log_b)
    got = float(jvit.forward_score(jnp.asarray(log_pi), jnp.asarray(log_a),
                                   jnp.asarray(log_b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batched_words_and_lengths():
    """[B utterances, W word models] batched in the vector dims of one scan."""
    rng = np.random.default_rng(3)
    s, t, b, w = 3, 20, 4, 5
    pis, As = [], []
    for _ in range(w):
        p, a = _random_hmm(rng, s)
        pis.append(p)
        As.append(a)
    log_pi = np.stack(pis)                       # [W, S]
    log_a = np.stack(As)                         # [W, S, S]
    log_b = rng.standard_normal((t, b, w, s)).astype(np.float32)
    lengths = rng.integers(3, t + 1, size=b)

    got = np.asarray(jvit.viterbi_score(
        jnp.asarray(log_pi)[None, :, :],
        jnp.asarray(log_a)[None, :, :, :],
        jnp.asarray(log_b),
        jnp.asarray(lengths)[:, None]))
    assert got.shape == (b, w)
    for i in range(b):
        for j in range(w):
            want, _ = golden.viterbi_log(log_pi[j], log_a[j],
                                         log_b[: lengths[i], i, j])
            np.testing.assert_allclose(got[i, j], want, rtol=1e-4)

    got_f = np.asarray(jvit.forward_score(
        jnp.asarray(log_pi)[None, :, :],
        jnp.asarray(log_a)[None, :, :, :],
        jnp.asarray(log_b),
        jnp.asarray(lengths)[:, None]))
    for i in range(b):
        for j in range(w):
            want = golden.forward_log(log_pi[j], log_a[j], log_b[: lengths[i], i, j])
            np.testing.assert_allclose(got_f[i, j], want, rtol=1e-4)
