"""Parity tests for the fused banded DTW kernel (GPU, in interpret mode).

Oracle chain (SURVEY.md §4.3): golden windowed-mask numpy DP (exact
semantics by construction) -> XLA banded scan (equal under coverage) ->
Pallas kernel in interpret mode.  All use the shared integer band rule
(ops/dtw.py:band_r2 == golden/dtw.py:band_r2_int).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.config import DtwConfig
from dsp_asr.golden import dtw as gdtw
from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded
from dsp_asr.ops import dtw as jdtw
from dsp_asr.window_plan import LANE, plan_window, round_up as _round_up

RNG = np.random.default_rng(7)


def _oracle(q, ql, bk, bl, cfg):
    b, k = len(ql), len(bl)
    t, u = q.shape[1], bk.shape[1]
    w, s_max, _, rb, _ = plan_window(cfg.band_frac, t, u, cfg.max_warp_scale)
    ref = np.zeros((b, k))
    for i in range(b):
        for j in range(k):
            if cfg.band_frac is None:
                ref[i, j] = gdtw.dtw_distance(q[i, :ql[i]], bk[j, :bl[j]], cfg)
            else:
                mask = gdtw.windowed_band_mask(
                    int(ql[i]), int(bl[j]), cfg.band_frac,
                    window=w, row_block=rb, s_max=s_max)
                ref[i, j] = gdtw.dtw_distance_masked(
                    q[i, :ql[i]], bk[j, :bl[j]], mask, squared=cfg.squared)
    return ref


def _run(q, ql, bk, bl, cfg):
    return np.asarray(dtw_batch_fused_banded(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bk), jnp.asarray(bl),
        cfg, interpret=True))


def _assert_close(d, ref, rtol=2e-5):
    fin = (ref < 1e20) & (d < 1e20)
    assert ((ref >= 1e20) == (d >= 1e20)).all(), "BIG/finite mismatch"
    if fin.any():
        np.testing.assert_allclose(d[fin], ref[fin], rtol=rtol)


@pytest.mark.parametrize("squared", [False, True])
def test_banded_matches_windowed_oracle(squared):
    cfg = DtwConfig(band_frac=0.2, squared=squared)
    q = RNG.normal(size=(3, 37, 5)).astype(np.float32)
    bk = RNG.normal(size=(4, 41, 5)).astype(np.float32)
    ql = np.array([37, 20, 9], np.int32)
    bl = np.array([41, 33, 15, 7], np.int32)
    _assert_close(_run(q, ql, bk, bl, cfg), _oracle(q, ql, bk, bl, cfg))


@pytest.mark.parametrize("squared", [False, True])
def test_windowed_offsets_advance(squared):
    """U >> W so the window actually slides (including an extreme-warp
    pair whose answer cell leaves the window -> BIG on both sides)."""
    cfg = DtwConfig(band_frac=0.1, squared=squared)
    q = RNG.normal(size=(2, 120, 5)).astype(np.float32)
    bk = RNG.normal(size=(3, 300, 5)).astype(np.float32)
    ql = np.array([120, 77], np.int32)
    bl = np.array([300, 150, 222], np.int32)
    w, _, _, _, _ = plan_window(cfg.band_frac, 120, 300, cfg.max_warp_scale)
    assert w < _round_up(300, LANE), "test must exercise a sliding window"
    _assert_close(_run(q, ql, bk, bl, cfg), _oracle(q, ql, bk, bl, cfg))


def test_exact_on_integer_features():
    """Squared cost on small integer features is exactly representable;
    the kernel must match the float64 oracle bit-for-bit (after f32)."""
    cfg = DtwConfig(band_frac=0.25, squared=True)
    q = RNG.integers(-3, 4, size=(2, 33, 4)).astype(np.float32)
    bk = RNG.integers(-3, 4, size=(3, 47, 4)).astype(np.float32)
    ql = np.array([33, 21], np.int32)
    bl = np.array([47, 30, 12], np.int32)
    d = _run(q, ql, bk, bl, cfg)
    ref = _oracle(q, ql, bk, bl, cfg)
    fin = ref < 1e20
    np.testing.assert_array_equal(d[fin], ref[fin].astype(np.float32))


def test_unbanded_matches_golden():
    """Unbanded DTW is the scan's (the kernel holds only a band in
    registers): the routing sends it there on every platform, and the
    routed distances match the golden DP."""
    from dsp_asr import pipeline as pl

    cfg = DtwConfig(band_frac=None)
    q = RNG.normal(size=(2, 50, 5)).astype(np.float32)
    bk = RNG.normal(size=(3, 60, 5)).astype(np.float32)
    ql = np.array([50, 31], np.int32)
    bl = np.array([60, 44, 17], np.int32)
    for platform in ("cpu", "gpu"):
        assert pl.dtw_impl(cfg, 2, 3, 50, 60, platform=platform) == "scan"
    d = np.asarray(pl.dtw_pairs(jnp.asarray(q), jnp.asarray(ql),
                                jnp.asarray(bk), jnp.asarray(bl), cfg))
    _assert_close(d, _oracle(q, ql, bk, bl, cfg))


def test_equals_scan_banded_under_coverage():
    """When plan_window reports the band covered, the kernel's windowed
    semantics coincide with the pure banded scan (same integer rule)."""
    cfg = DtwConfig(band_frac=0.15)
    t, u = 64, 72
    assert plan_window(cfg.band_frac, t, u)[4]
    q = RNG.normal(size=(3, t, 6)).astype(np.float32)
    bk = RNG.normal(size=(4, u, 6)).astype(np.float32)
    ql = np.array([64, 50, 40], np.int32)
    bl = np.array([72, 60, 48, 33], np.int32)
    d = _run(q, ql, bk, bl, cfg)
    ref = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                    jnp.asarray(bk), jnp.asarray(bl), cfg))
    _assert_close(d, ref)
    assert (d.argmin(1) == ref.argmin(1)).all()


def test_small_batch_adaptive_tile():
    cfg = DtwConfig(band_frac=0.2, squared=True)
    q = RNG.normal(size=(2, 24, 3)).astype(np.float32)
    bk = RNG.normal(size=(2, 30, 3)).astype(np.float32)
    ql = np.array([24, 11], np.int32)
    bl = np.array([30, 18], np.int32)
    _assert_close(_run(q, ql, bk, bl, cfg), _oracle(q, ql, bk, bl, cfg))


def test_plan_window_properties():
    # full-band fallback when the band cannot be windowed
    w, s_max, span, rb, cov = plan_window(0.9, 256, 256)
    assert w == 256 and s_max == 0 and cov
    # classical setup: half-width window, covered
    w, s_max, span, rb, cov = plan_window(0.1, 198, 198)
    assert w == 128 and cov and span <= w and s_max % 8 == 0
    # unbanded
    w, s_max, span, rb, cov = plan_window(None, 198, 198)
    assert w == 256 and s_max == 0 and cov


def test_integer_band_rule_consistency():
    """ops/dtw.py band_r2 and golden band_r2_int agree cell-for-cell."""
    for ta, tb, bf in [(37, 41, 0.2), (9, 41, 0.2), (120, 300, 0.1),
                       (2, 5, 0.5), (198, 198, 0.1)]:
        lam1, lbm1, r2 = gdtw.band_r2_int(ta, tb, bf)
        r2_jax = int(jdtw.band_r2(jnp.asarray(ta), jnp.asarray(tb), bf))
        assert r2 == r2_jax, (ta, tb, bf)


def test_staged_extraction_bit_identical():
    """Between rows the kernel moves its band-coordinate DP row left by
    a per-lane shift, as log2 static select stages (_shift).  Every shift
    must equal the direct gather bit for bit, and a pair's distance must
    not depend on the lane or program it lands in."""
    from dsp_asr.kernels import dtw_fused_banded as fb
    from dsp_asr.ops.dtw import BIG

    lanes, n, nbits = 8, 6, 3
    vals = RNG.standard_normal((n, lanes)).astype(np.float32)
    s = np.arange(lanes, dtype=np.int32)            # shifts 0..7
    for lead in (0, 1, 2):
        got = np.stack([np.asarray(v) for v in fb._shift(
            tuple(jnp.asarray(v) for v in vals), jnp.asarray(s), lead,
            nbits)])
        ext = np.concatenate([np.full((lead, lanes), BIG, np.float32), vals])
        want = np.full(ext.shape, BIG, np.float32)
        for m in range(ext.shape[0]):
            for ln in range(lanes):
                if m + s[ln] < ext.shape[0]:
                    want[m, ln] = ext[m + s[ln], ln]
        np.testing.assert_array_equal(got, want)

    b, k, t, u, f = 5, 3, 50, 46, 8
    q = RNG.standard_normal((b, t, f)).astype(np.float32)
    bk = RNG.standard_normal((k, u, f)).astype(np.float32)
    ql = RNG.integers(12, t + 1, size=b).astype(np.int32)
    bl = RNG.integers(12, u + 1, size=k).astype(np.int32)
    perm = RNG.permutation(b)
    # 40 queries: the permuted copies land in other lanes of a 2nd program
    qq = np.concatenate([q, q[perm], q[:30]])
    qql = np.concatenate([ql, ql[perm], ql[:30]])
    for cfg in (DtwConfig(band_frac=0.15, squared=True),
                DtwConfig(band_frac=0.15, squared=False),
                DtwConfig(band_frac=0.2, slope="itakura")):
        want = _run(q, ql, bk, bl, cfg)
        got = _run(qq, qql, bk, bl, cfg)
        np.testing.assert_array_equal(got[:b], want)
        np.testing.assert_array_equal(got[b:2 * b], want[perm])
