"""Min-plus-scan DTW vs golden DP loop: exact and float-tolerance parity."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import DtwConfig
from dsp_asr import golden
from dsp_asr.ops import dtw as jdtw


def test_dtw_exact_small_integer_costs():
    """On tiny integer-valued sequences with squared cost, the scan DTW is
    bit-exact vs the loop DP (all arithmetic is exact in f32)."""
    rng = np.random.default_rng(0)
    cfg = DtwConfig(squared=True)
    for _ in range(8):
        ta, tb = rng.integers(1, 9, size=2)
        a = rng.integers(-3, 4, size=(ta, 2)).astype(np.float32)
        b = rng.integers(-3, 4, size=(tb, 2)).astype(np.float32)
        want = golden.dtw_distance(a, b, cfg)
        got = float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(b), cfg=cfg))
        assert got == pytest.approx(want, rel=1e-6), (ta, tb)


def test_dtw_float_parity_random():
    rng = np.random.default_rng(1)
    for _ in range(5):
        a = rng.standard_normal((37, 13)).astype(np.float32)
        b = rng.standard_normal((52, 13)).astype(np.float32)
        want = golden.dtw_distance(a, b)
        got = float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dtw_masked_equals_sliced():
    """Padded inputs with true lengths give exactly the unpadded answer."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((40, 13)).astype(np.float32)
    b = rng.standard_normal((40, 13)).astype(np.float32)
    for la, lb in [(40, 40), (17, 29), (5, 7), (1, 1), (40, 3)]:
        want = golden.dtw_distance(a[:la], b[:lb])
        got = float(jdtw.dtw_distance(
            jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(la), jnp.asarray(lb)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{la},{lb}")


def test_dtw_band_parity():
    rng = np.random.default_rng(3)
    cfg = DtwConfig(band_frac=0.2)
    a = rng.standard_normal((30, 8)).astype(np.float32)
    b = rng.standard_normal((45, 8)).astype(np.float32)
    want = golden.dtw_distance(a, b, cfg)
    got = float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(b), cfg=cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dtw_batch_matches_pairwise():
    rng = np.random.default_rng(4)
    B, K, T, U, F = 3, 4, 25, 31, 13
    q = rng.standard_normal((B, T, F)).astype(np.float32)
    bank = rng.standard_normal((K, U, F)).astype(np.float32)
    ql = rng.integers(5, T + 1, size=B)
    bl = rng.integers(5, U + 1, size=K)
    got = np.asarray(jdtw.dtw_batch(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl)))
    assert got.shape == (B, K)
    for i in range(B):
        for j in range(K):
            want = golden.dtw_distance(q[i, :ql[i]], bank[j, :bl[j]])
            np.testing.assert_allclose(got[i, j], want, rtol=1e-5)


def test_dtw_identity_zero_and_symmetry():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((20, 13)).astype(np.float32)
    b = rng.standard_normal((28, 13)).astype(np.float32)
    # self-distance is not exactly 0: the matmul-expanded cost
    # |a|^2+|b|^2-2ab cancels to ~1e-5 in f32 and sqrt amplifies that;
    # inter-class costs are O(1-10) so 1e-3 noise is irrelevant.
    noband = DtwConfig(band_frac=None)
    assert float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(a),
                                   cfg=noband)) < 2e-3
    np.testing.assert_allclose(
        float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(b), cfg=noband)),
        float(jdtw.dtw_distance(jnp.asarray(b), jnp.asarray(a), cfg=noband)),
        rtol=1e-6)


def test_dtw_bidi_exhaustive_tiny():
    """Bidirectional (Hirschberg-split) DTW == golden on all tiny shapes."""
    rng = np.random.default_rng(7)
    for ta in range(1, 9):
        for tb in range(1, 9):
            a = rng.standard_normal((8, 3)).astype(np.float32)
            b = rng.standard_normal((8, 3)).astype(np.float32)
            noband = DtwConfig(band_frac=None)
            want = golden.dtw_distance(a[:ta], b[:tb], noband)
            got = float(jdtw.dtw_distance_bidi(
                jnp.asarray(a), jnp.asarray(b),
                jnp.asarray(ta), jnp.asarray(tb), noband))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{ta},{tb}")


def test_dtw_bidi_banded_asymmetric_matches_scan():
    """Regression: with the default windowed band and padded T != U, the
    bidi split must use the FULL problem's window schedule — computing
    it from the halved row count narrowed the window, BIG-masked in-band
    cells, and could return an exact 0.0 'perfect match'."""
    rng = np.random.default_rng(11)
    cfg = DtwConfig()          # band 0.17 + max_warp_scale 2.0 (windowed)
    for t, u, la, lb in [(256, 128, 240, 125), (128, 256, 100, 256),
                         (96, 40, 96, 40), (64, 64, 50, 37)]:
        a = jnp.asarray(rng.standard_normal((t, 6)).astype(np.float32))
        b = jnp.asarray(rng.standard_normal((u, 6)).astype(np.float32))
        want = float(jdtw.dtw_distance(a, b, jnp.asarray(la),
                                       jnp.asarray(lb), cfg))
        got = float(jdtw.dtw_distance_bidi(a, b, jnp.asarray(la),
                                           jnp.asarray(lb), cfg))
        if want > 1e19:
            assert got > 1e19, (t, u, la, lb, got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       err_msg=f"{t},{u},{la},{lb}")


def test_dtw_bidi_batch_matches_scan():
    rng = np.random.default_rng(8)
    B, K, T, U, F = 3, 4, 25, 31, 13
    q = rng.standard_normal((B, T, F)).astype(np.float32)
    bank = rng.standard_normal((K, U, F)).astype(np.float32)
    ql = rng.integers(1, T + 1, size=B).astype(np.int32)
    bl = rng.integers(1, U + 1, size=K).astype(np.int32)
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl)))
    got = np.asarray(jdtw.dtw_batch_bidi(jnp.asarray(q), jnp.asarray(ql),
                                         jnp.asarray(bank), jnp.asarray(bl)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
