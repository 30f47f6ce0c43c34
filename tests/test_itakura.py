"""Itakura slope-constrained DTW (DtwConfig.slope="itakura").

Validates the two-state recurrence bottom-up: exhaustive path
enumeration -> golden loop -> XLA scan -> fused banded Pallas kernel
(interpret mode), plus the unreachability semantics (length ratio > 2)
and the unsupported-impl guards.  Reference: Itakura 1975 / Rabiner &
Juang §4.7 local path constraints (reconstruction — reference mount
empty, SURVEY.md §0).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.config import DtwConfig
from dsp_asr.golden import dtw as gd
from dsp_asr.ops import dtw as jdtw
from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded

UNREACH = 1e20


def brute_itakura(cost: np.ndarray) -> float:
    """Min path cost by exhaustive enumeration of the Itakura step set."""
    ta, tb = cost.shape
    best = [np.inf]

    def rec(i, j, acc, lastv):
        if acc >= best[0]:
            return
        if i == ta - 1:
            if j == tb - 1:
                best[0] = acc
            return
        for dj in (1, 2, 0):
            if dj == 0 and lastv:
                continue
            nj = j + dj
            if nj >= tb:
                continue
            rec(i + 1, nj, acc + cost[i + 1, nj], dj == 0)

    rec(0, 0, cost[0, 0], False)
    return best[0]


def test_golden_matches_brute_force():
    rng = np.random.default_rng(1)
    checked_unreachable = False
    for _ in range(40):
        ta, tb = rng.integers(2, 9, 2)
        cost = rng.random((ta, tb))
        dp = gd._dp_itakura(cost)
        got = dp[ta - 1, tb - 1]
        want = brute_itakura(cost)
        if want == np.inf:
            checked_unreachable = True
            assert got >= UNREACH
        else:
            assert abs(got - want) < 1e-9
    assert checked_unreachable  # ratios > 2 appeared in the draw


def test_equal_length_no_warp_needed_agrees():
    """With zero-cost diagonal and equal lengths both step sets pick the
    pure diagonal, so the optima coincide.  (In general they are
    incomparable: (1,2) SKIPS a template frame the unconstrained path
    must pay for, while horizontal runs are cheaper unconstrained.)"""
    rng = np.random.default_rng(2)
    for _ in range(5):
        t = int(rng.integers(4, 10))
        cost = rng.random((t, t)) + 1.0
        np.fill_diagonal(cost, 0.0)
        d_it = gd._dp_itakura(cost)[t - 1, t - 1]
        d_un = gd._dp_unconstrained(cost)[t - 1, t - 1]
        assert d_it == d_un == 0.0


@pytest.mark.parametrize("band,squared", [(None, False), (0.3, False),
                                          (0.3, True)])
def test_scan_matches_golden(band, squared):
    rng = np.random.default_rng(3)
    T, U, F, B, K = 40, 45, 7, 4, 5
    cfg = DtwConfig(band_frac=band, max_warp_scale=2.0 if band else None,
                    slope="itakura", squared=squared)
    q = rng.standard_normal((B, T, F)).astype(np.float32)
    bank = rng.standard_normal((K, U, F)).astype(np.float32)
    # include ratio->unreachable pairs: shortest query 12 vs longest
    # template 45 exceeds slope 2
    ql = np.array([12, 25, 33, 40], np.int32)
    bl = np.array([5, 25, 30, 38, 45], np.int32)
    scan = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl), cfg))
    gold = np.zeros((B, K))
    for i in range(B):
        for j in range(K):
            gold[i, j] = gd.dtw_distance(q[i][:ql[i]], bank[j][:bl[j]], cfg,
                                         plan_shape=(T, U))
    fin = gold < UNREACH
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(scan[fin], gold[fin], rtol=3e-5, atol=3e-5)
    assert np.all((scan >= UNREACH) == ~fin)


@pytest.mark.parametrize("squared", [False, True])
def test_fused_kernel_matches_scan(squared):
    rng = np.random.default_rng(4)
    T, U, F, B, K = 40, 45, 7, 4, 5
    cfg = DtwConfig(band_frac=0.3, max_warp_scale=2.0, slope="itakura",
                    squared=squared)
    q = rng.standard_normal((B, T, F)).astype(np.float32)
    bank = rng.standard_normal((K, U, F)).astype(np.float32)
    ql = np.array([12, 25, 33, 40], np.int32)
    bl = np.array([5, 25, 30, 38, 45], np.int32)
    scan = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl), cfg))
    kern = np.asarray(dtw_batch_fused_banded(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl),
        cfg, interpret=True))
    fin = scan < UNREACH
    np.testing.assert_allclose(kern[fin], scan[fin], rtol=2e-5, atol=2e-5)
    assert np.all((kern >= UNREACH) == ~fin)


def test_fused_kernel_long_sequences_realign():
    """T~bench scale: exercises the multi-block window realign of BOTH
    Itakura carries (dp and ndp) across s_max advances."""
    rng = np.random.default_rng(5)
    T, U, F, B, K = 198, 198, 13, 4, 3
    cfg = DtwConfig(band_frac=0.15, max_warp_scale=2.0, slope="itakura")
    q = rng.standard_normal((B, T, F)).astype(np.float32)
    bank = rng.standard_normal((K, U, F)).astype(np.float32)
    ql = np.array([150, 198, 170, 185], np.int32)
    bl = np.array([198, 160, 180], np.int32)
    scan = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl), cfg))
    kern = np.asarray(dtw_batch_fused_banded(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl),
        cfg, interpret=True))
    fin = scan < UNREACH
    assert fin.all()
    np.testing.assert_allclose(kern, scan, rtol=2e-5, atol=2e-4)


def test_identity_is_zero_and_classify_prefers_self():
    rng = np.random.default_rng(6)
    T, F = 60, 13
    cfg = DtwConfig(band_frac=0.2, max_warp_scale=2.0, slope="itakura")
    a = rng.standard_normal((T, F)).astype(np.float32)
    d = float(jdtw.dtw_distance(jnp.asarray(a), jnp.asarray(a),
                                jnp.asarray(T), jnp.asarray(T), cfg))
    # not exactly 0: the |a|^2+|b|^2-2ab matmul identity leaves ~1e-6
    # f32 residuals that the sqrt amplifies
    assert d < 1e-3
    # a mildly time-warped copy scores closer than an unrelated signal
    warped = a[np.clip((np.arange(T) * 1.1).astype(int), 0, T - 1)]
    other = rng.standard_normal((T, F)).astype(np.float32)
    dw = float(jdtw.dtw_distance(jnp.asarray(warped), jnp.asarray(a),
                                 jnp.asarray(T), jnp.asarray(T), cfg))
    do = float(jdtw.dtw_distance(jnp.asarray(other), jnp.asarray(a),
                                 jnp.asarray(T), jnp.asarray(T), cfg))
    assert dw < do


def test_unsupported_impls_raise():
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.standard_normal((2, 16, 4)), jnp.float32)
    bank = jnp.asarray(rng.standard_normal((2, 16, 4)), jnp.float32)
    ql = jnp.full(2, 16, jnp.int32)
    bl = jnp.full(2, 16, jnp.int32)
    with pytest.raises(ValueError, match="slope"):
        jdtw.dtw_batch_bidi(q, ql, bank, bl,
                            DtwConfig(band_frac=None, slope="itakura"))
    # the kernel leaves the unbanded itakura DP to the scan, and an
    # explicit request for the kernel there fails instead of falling back
    with pytest.raises(ValueError, match="does not implement"):
        dtw_batch_fused_banded(q, ql, bank, bl,
                               DtwConfig(band_frac=None, slope="itakura"),
                               interpret=True)
    from dsp_asr.pipeline import dtw_impl
    with pytest.raises(ValueError, match="does not implement"):
        dtw_impl(DtwConfig(band_frac=None, slope="itakura",
                           impl="fused_banded"), 1, 1, 16, 16, platform="gpu")
    with pytest.raises(ValueError, match="slope"):
        dtw_batch_fused_banded(q, ql, bank, bl,
                               DtwConfig(slope="bogus"), interpret=True)


def test_recognizer_with_slope_end_to_end():
    """slope='itakura' flows through the full recognizer and still
    classifies the synthetic corpus correctly."""
    import dataclasses

    from dsp_asr import KnnDtwRecognizer, PipelineConfig
    from dsp_asr.io.dataset import synth_word

    base = PipelineConfig()
    cfg = dataclasses.replace(
        base, dtw=dataclasses.replace(base.dtw, slope="itakura"))
    labels = ["zero", "one", "two", "three", "four"]
    rec = KnnDtwRecognizer(cfg)
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    queries = [synth_word(lab, 99) for lab in labels]
    got, dists = rec.classify_batch(queries, return_distances=True)
    assert list(got) == labels
    # the matched template is reachable (finite) for every query
    assert (np.asarray(dists).min(axis=1) < UNREACH).all()


def _check_itakura_path(path, ta, tb):
    assert path[0] == (0, 0) and path[-1] == (ta - 1, tb - 1)
    lastv = False
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        di, dj = i1 - i0, j1 - j0
        assert di == 1 and dj in (0, 1, 2)
        if dj == 0:
            assert not lastv, "two consecutive vertical steps"
        lastv = dj == 0
    return True


def test_golden_backtrace_path_is_valid_and_optimal():
    rng = np.random.default_rng(8)
    for _ in range(20):
        ta = int(rng.integers(3, 12))
        tb = int(rng.integers(max(2, (ta + 2) // 2), 2 * ta - 1))
        cost = rng.random((ta, tb))
        dp = gd._dp_itakura(cost)
        if dp[ta - 1, tb - 1] >= UNREACH:
            continue
        path = gd._backtrace_itakura(cost, *gd._dp_itakura_tables(cost))[::-1]
        _check_itakura_path(path, ta, tb)
        path_cost = sum(cost[i, j] for i, j in path)
        assert abs(path_cost - dp[ta - 1, tb - 1]) < 1e-9


def test_jax_alignment_matches_golden_path():
    from dsp_asr.ops.align import dtw_alignment

    rng = np.random.default_rng(9)
    T, U, F = 24, 30, 5
    cfg = DtwConfig(band_frac=None, slope="itakura")
    for la, lb in ((24, 30), (20, 25), (16, 30)):
        a = rng.standard_normal((T, F)).astype(np.float32)
        b = rng.standard_normal((U, F)).astype(np.float32)
        dist, pi, pj, ns = dtw_alignment(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
            cfg)
        if float(dist) >= UNREACH / (la + lb):
            continue
        ns = int(ns)
        got = list(zip(np.asarray(pi)[:ns].tolist(),
                       np.asarray(pj)[:ns].tolist()))[::-1]
        gdist, gpath = gd.dtw_distance(a[:la], b[:lb], cfg, return_path=True)
        assert got == gpath
        assert abs(float(dist) - gdist) < 1e-4
        _check_itakura_path(got, la, lb)


def test_condense_dba_under_slope():
    import dataclasses

    from dsp_asr import KnnDtwRecognizer, PipelineConfig
    from dsp_asr.io.dataset import synth_word

    base = PipelineConfig()
    cfg = dataclasses.replace(
        base, dtw=dataclasses.replace(base.dtw, slope="itakura"))
    labels = ["zero", "one", "two"]
    rec = KnnDtwRecognizer(cfg)
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    rec.condense("dba", n_iter=2)
    assert rec.n_templates == len(labels)
    got = rec.classify_batch([synth_word(lab, 50) for lab in labels])
    assert list(got) == labels
