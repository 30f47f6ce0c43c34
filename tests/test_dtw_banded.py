"""Windowed banded DTW: exact parity with the masked band implementation
and the golden banded oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import DtwConfig
from dsp_asr import golden
from dsp_asr.ops import dtw as jdtw
from dsp_asr.ops import dtw_banded as jband

CFG = DtwConfig(band_frac=0.2)


def test_window_for_band_covers():
    w = jband.window_for_band(0.2, 198, 198)
    assert w >= 2 * (0.2 * 198) + 4
    assert w % 128 == 0


def test_windowed_matches_golden_banded():
    rng = np.random.default_rng(0)
    for ta, tb in [(30, 30), (25, 40), (40, 25), (10, 10)]:
        a = rng.standard_normal((40, 6)).astype(np.float32)
        b = rng.standard_normal((40, 6)).astype(np.float32)
        want = golden.dtw_distance(a[:ta], b[:tb], CFG)
        w = jband.window_for_band(0.2, 40, 40, lane=8)
        got = float(jband.dtw_distance_windowed(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ta), jnp.asarray(tb),
            w, CFG))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"{ta},{tb}")


def test_windowed_matches_masked_batch():
    rng = np.random.default_rng(1)
    B, K, T, U, F = 3, 4, 36, 36, 8
    q = rng.standard_normal((B, T, F)).astype(np.float32)
    bank = rng.standard_normal((K, U, F)).astype(np.float32)
    ql = rng.integers(10, T + 1, size=B).astype(np.int32)
    bl = rng.integers(10, U + 1, size=K).astype(np.int32)
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl), CFG))
    w = jband.window_for_band(0.2, T, U, lane=8)
    got = np.asarray(jband.dtw_batch_windowed(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl),
        w, CFG))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_windowed_equal_length_diag():
    """Identical sequences: banded self-distance ~ 0 (band includes diag)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((32, 5)).astype(np.float32)
    got = float(jband.dtw_distance_windowed(
        jnp.asarray(a), jnp.asarray(a), jnp.asarray(32), jnp.asarray(32),
        16, CFG))
    assert got < 2e-3


def test_slow_impl_warns_once():
    """Off-path reference implementations must log a warning (once).

    The dsp_asr logger doesn't propagate to root (own stderr handler),
    so the check goes through the warn_once registry, with the actual
    emission asserted on a handler attached to the dsp_asr logger.
    """
    import logging

    from dsp_asr.utils import logging as ulog

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = ulog.get_logger()
    h = Capture()
    logger.addHandler(h)
    try:
        ulog._WARNED.discard("dtw-banded-windowed")
        rng = np.random.default_rng(3)
        a = rng.standard_normal((1, 16, 4)).astype(np.float32)
        jband.dtw_batch_windowed(jnp.asarray(a), jnp.asarray([16]),
                                 jnp.asarray(a), jnp.asarray([16]), 16, CFG)
        assert any("reference implementation" in m for m in records)
        assert "dtw-banded-windowed" in ulog._WARNED
        # second call: silent
        records.clear()
        jband.dtw_batch_windowed(jnp.asarray(a), jnp.asarray([16]),
                                 jnp.asarray(a), jnp.asarray([16]), 16, CFG)
        assert not any("reference implementation" in m for m in records)
    finally:
        logger.removeHandler(h)


def test_warn_once_dedupes():
    from dsp_asr.utils.logging import _WARNED, warn_once

    _WARNED.discard("test-key-xyz")
    assert warn_once("test-key-xyz", "msg") is True
    assert warn_once("test-key-xyz", "msg") is False
