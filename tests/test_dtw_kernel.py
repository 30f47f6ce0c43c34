"""The GPU DTW kernel in interpret mode, its static band bound, and the
routing that chooses between it and the XLA row scan.

Every parity case checks the kernel against both the golden float64 DP
(golden/dtw.py, planned on the padded shape like the device paths) and
the scan (ops/dtw.py), dead pairs included.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr import pipeline as pl
from dsp_asr.config import DtwConfig
from dsp_asr.golden import dtw as gdtw
from dsp_asr.kernels import dtw_fused_banded as fb
from dsp_asr.ops import dtw as jdtw

DEAD = 1e20

# name -> (cfg, B, K, T, U)
CASES = {
    "shipped": (DtwConfig(), 3, 4, 60, 60),
    "squared": (DtwConfig(squared=True), 3, 4, 60, 60),
    "itakura": (DtwConfig(slope="itakura"), 3, 4, 60, 60),
    "itakura-squared": (DtwConfig(slope="itakura", squared=True), 3, 4, 60, 60),
    "pure-band": (DtwConfig(max_warp_scale=None), 3, 4, 50, 56),
    "pure-band-itakura": (DtwConfig(max_warp_scale=None, slope="itakura"),
                          3, 4, 50, 56),
    "narrow-band": (DtwConfig(band_frac=0.05), 3, 3, 64, 64),
    "wide-band": (DtwConfig(band_frac=0.3), 3, 3, 40, 48),
    "sliding-window": (DtwConfig(band_frac=0.1), 2, 3, 60, 300),
    "sliding-window-itakura": (DtwConfig(band_frac=0.1, slope="itakura"),
                               2, 3, 150, 300),
    "query-longer": (DtwConfig(), 3, 3, 90, 40),
    "b1": (DtwConfig(), 1, 3, 48, 48),
    "k1": (DtwConfig(), 4, 1, 48, 48),
    "b33-two-programs": (DtwConfig(band_frac=0.2), 33, 2, 24, 24),
    "k-odd": (DtwConfig(), 2, 7, 30, 30),
}


def _problem(b, k, t, u, seed, f=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = rng.integers(1, t + 1, size=b).astype(np.int32)
    bl = rng.integers(1, u + 1, size=k).astype(np.int32)
    ql[0], bl[0] = t, u                       # full lengths always present
    if b > 1:
        ql[-1] = 1                            # single-frame query
    return q, ql, bank, bl


def _golden(q, ql, bank, bl, cfg):
    t, u = q.shape[1], bank.shape[1]
    return np.array([[gdtw.dtw_distance(q[i, :ql[i]], bank[j, :bl[j]], cfg,
                                        plan_shape=(t, u))
                      for j in range(len(bl))] for i in range(len(ql))])


def _kernel(q, ql, bank, bl, cfg):
    return np.asarray(fb.dtw_batch_fused_banded(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl),
        cfg, interpret=True))


def _assert_same(d, ref):
    fin = ref < DEAD
    np.testing.assert_array_equal(d < DEAD, fin)
    if fin.any():
        np.testing.assert_allclose(d[fin], ref[fin], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_golden_and_scan(name):
    cfg, b, k, t, u = CASES[name]
    assert fb.supports(cfg, t, u)
    q, ql, bank, bl = _problem(b, k, t, u, seed=len(name))
    d = _kernel(q, ql, bank, bl, cfg)
    assert d.shape == (b, k)
    _assert_same(d, _golden(q, ql, bank, bl, cfg))
    scan = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl), cfg))
    _assert_same(d, scan)


def test_all_dead_rows_stay_dead():
    """Itakura admits no path past a 2:1 length ratio: a short query
    against long templates is dead everywhere, exactly as in the scan,
    and the classifier returns the no-match sentinel for it."""
    cfg = DtwConfig(slope="itakura")
    q, ql, bank, bl = _problem(2, 3, 40, 40, seed=11)
    ql[:] = [40, 8]
    bl[:] = [40, 30, 25]
    d = _kernel(q, ql, bank, bl, cfg)
    assert (d[1] >= DEAD).all() and (d[0] < DEAD).any()
    scan = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl), cfg))
    _assert_same(d, scan)
    ids, _ = pl.classify_features(
        pl.Features(jnp.asarray(q), jnp.asarray(ql)),
        pl.Features(jnp.asarray(bank), jnp.asarray(bl)),
        jnp.arange(3, dtype=jnp.int32),
        cfg=pl.PipelineConfig(dtw=cfg))
    assert int(ids[1]) == -1


def test_identity_pair_is_zero():
    cfg = DtwConfig(squared=True)
    q, ql, _, _ = _problem(2, 1, 32, 32, seed=5)
    d = _kernel(q, ql, q, ql, cfg)
    np.testing.assert_array_equal(np.diag(d), 0.0)


@pytest.mark.parametrize("t,u,band_frac", [(198, 198, 0.17), (60, 300, 0.1),
                                           (90, 40, 0.17), (2, 5, 0.5),
                                           (198, 198, 0.3)])
def test_band_cells_bounds_every_row(t, u, band_frac):
    """The static register budget P covers the widest band row of every
    length pair the shape admits."""
    p = fb.band_cells(band_frac, t, u)
    for la in sorted({1, 2, t // 3, t // 2, t - 1, t} - {0}):
        for lb in sorted({1, 2, u // 3, u // 2, u - 1, u} - {0}):
            lam1, lbm1, r2 = gdtw.band_r2_int(la, lb, band_frac)
            j = np.arange(lb)
            widest = max(int(np.sum(np.abs(j * lam1 - i * lbm1) <= r2))
                         for i in range(la))
            assert widest <= p, (la, lb, widest, p)


def test_supports():
    assert fb.supports(DtwConfig(), 198, 198)
    assert fb.supports(DtwConfig(slope="itakura", squared=True), 198, 198)
    assert not fb.supports(DtwConfig(band_frac=None), 198, 198)
    assert not fb.supports(DtwConfig(slope="bogus"), 198, 198)
    # a band wider than the registers hold is the scan's
    assert fb.band_cells(0.9, 198, 198) > fb.MAX_BAND
    assert not fb.supports(DtwConfig(band_frac=0.9), 198, 198)


def test_unsupported_config_raises():
    q, ql, bank, bl = _problem(1, 1, 16, 16, seed=1)
    with pytest.raises(ValueError, match="does not implement"):
        _kernel(q, ql, bank, bl, DtwConfig(band_frac=None))


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("cfg,platform,b,k,want", [
    (DtwConfig(), "cpu", 256, 100, "scan"),
    (DtwConfig(), "cpu", 1, 10, "scan"),
    (DtwConfig(), "gpu", 256, 100, "fused_banded"),
    (DtwConfig(), "gpu", 1, 10, "fused_banded"),
    (DtwConfig(slope="itakura", squared=True), "gpu", 256, 100,
     "fused_banded"),
    (DtwConfig(impl="scan"), "gpu", 256, 100, "scan"),
    (DtwConfig(band_frac=None), "gpu", 256, 100, "scan"),
    (DtwConfig(band_frac=0.9), "gpu", 256, 100, "scan"),
    (DtwConfig(impl="fused_banded"), "gpu", 1, 10, "fused_banded"),
    (DtwConfig(impl="fused_banded", slope="itakura"), "gpu", 1, 10,
     "fused_banded"),
])
def test_dtw_impl_routing(cfg, platform, b, k, want):
    assert pl.dtw_impl(cfg, b, k, 198, 198, platform=platform) == want


@pytest.mark.parametrize("slope", [None, "itakura"])
def test_auto_routes_by_measured_crossover(slope):
    """"auto" takes the kernel exactly where faster_than_scan says, and
    that predicate is monotone in the batch beyond one program's lanes."""
    cfg = DtwConfig(slope=slope)
    for b in (1, 2, fb.LANES, fb.LANES + 1, 64, 256, 1024):
        for k in (1, 10, 100, 1000):
            want = "fused_banded" if fb.faster_than_scan(cfg, b, k) else "scan"
            assert pl.dtw_impl(cfg, b, k, 198, 198, platform="gpu") == want
    big = [fb.faster_than_scan(cfg, b, 100) for b in (64, 128, 256, 1024)]
    assert big == sorted(big)              # once faster, faster for more
    assert fb.faster_than_scan(cfg, 1024, 1000)


def test_itakura_small_batch_is_the_scans():
    """With the slope the scan's cheap elementwise row wins at config-0
    size (B=1, K=10), so "auto" keeps it there."""
    assert pl.dtw_impl(DtwConfig(slope="itakura"), 1, 10, 198, 198,
                       platform="gpu") == "scan"


def test_dtw_impl_defaults_to_this_backend():
    assert pl.dtw_impl(DtwConfig(), 256, 100, 198, 198) == "scan"   # CPU


@pytest.mark.parametrize("cfg,platform,match", [
    (DtwConfig(impl="fused_banded"), "cpu", "needs a GPU"),
    (DtwConfig(impl="fused_banded", band_frac=None), "gpu",
     "does not implement"),
    (DtwConfig(impl="pallas"), "gpu", "unknown"),
])
def test_dtw_impl_refuses_instead_of_falling_back(cfg, platform, match):
    with pytest.raises(ValueError, match=match):
        pl.dtw_impl(cfg, 256, 100, 198, 198, platform=platform)


def test_kernel_restores_query_order():
    """Queries are sorted by length inside the wrapper; the distances come
    back in the caller's order (lengths given in descending order)."""
    cfg = DtwConfig()
    q, _, bank, bl = _problem(5, 3, 40, 40, seed=9)
    ql = np.array([40, 33, 21, 12, 5], np.int32)
    d = _kernel(q, ql, bank, bl, cfg)
    for i in range(len(ql)):
        one = _kernel(q[i:i + 1], ql[i:i + 1], bank, bl, cfg)
        np.testing.assert_allclose(d[i], one[0], rtol=1e-6)


def test_dtw_pairs_never_asks_for_interpret(monkeypatch):
    """On a GPU, dtw_pairs calls the compiled kernel: no interpret flag."""
    calls = []

    def fake(q, ql, bank, bl, cfg, **kw):
        calls.append(kw)
        return jnp.zeros((q.shape[0], bank.shape[0]))

    monkeypatch.setattr(pl.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(fb, "dtw_batch_fused_banded", fake)
    q, ql, bank, bl = _problem(2, 3, 20, 20, seed=2)
    pl.dtw_pairs(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
                 jnp.asarray(bl), DtwConfig())
    assert calls == [{}]


def test_dtw_pairs_on_cpu_is_the_scan():
    q, ql, bank, bl = _problem(2, 3, 30, 30, seed=3)
    args = (jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
            jnp.asarray(bl))
    np.testing.assert_array_equal(
        np.asarray(pl.dtw_pairs(*args, DtwConfig())),
        np.asarray(jdtw.dtw_batch(*args, DtwConfig())))
