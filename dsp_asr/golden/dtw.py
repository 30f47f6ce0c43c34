"""Golden numpy DTW and nearest-template classification.

Classical dynamic time warping (SURVEY.md L3; Muda et al. 1003.4083 §C):

    D[i, j] = d(a_i, b_j) + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

with Euclidean local cost, full boundary conditions, and the final
distance normalised by (T_a + T_b).  Optional Sakoe-Chiba band expressed
as a fraction of max(T_a, T_b).

This loop implementation is the exact-parity oracle for the JAX
min-plus-scan DTW (dsp_asr/ops/dtw.py) and the Pallas wavefront kernel
(dsp_asr/kernels/dtw_pallas.py).
"""

from __future__ import annotations

import numpy as np

from dsp_asr.config import DtwConfig

BIG = 1e30


def band_r2_int(ta: int, tb: int, band_frac: float):
    """(lam1, lbm1, r2) for the integer band rule |j*lam1 - i*lbm1| <= r2.

    Mirrors ops/dtw.py:band_r2 operation-for-operation in float32 so the
    boundary cells are bit-identical everywhere.
    """
    lam1 = max(ta - 1, 1)
    lbm1 = tb - 1
    radius = np.maximum(np.float32(1.0),
                        np.float32(band_frac) * np.float32(max(ta, tb)))
    r2 = int(np.floor(radius * np.float32(lam1)))
    return lam1, lbm1, r2


def windowed_band_mask(ta: int, tb: int, band_frac: float, *,
                       window: int, row_block: int, s_max: int) -> np.ndarray:
    """Valid-cell mask of the windowed-band semantics (DtwConfig docs).

    Each row i is restricted to a ``window``-wide lane window whose start
    is quantised to multiples of 8 (with a -8 slack), constant over
    ``row_block`` consecutive rows, right-clipped to tb, and advancing at
    most ``s_max`` lanes per block.  A cell is valid iff it is inside
    both the integer Sakoe-Chiba band and that window.  When the window
    covers the whole band (plan_window 'covered') this equals the pure
    band.  Mirrors ops/dtw.py:window_offsets and the Pallas kernel
    operation-for-operation.
    """
    lam1, lbm1, r2 = band_r2_int(ta, tb, band_frac)
    offs = []
    off_prev = 0
    for b in range((ta + row_block - 1) // row_block):
        i0 = b * row_block
        jlo = (max(i0 * lbm1 - r2, 0) + lam1 - 1) // lam1
        # -8 slack: lane 0 stays out-of-band whenever off > 0 (see kernel)
        off = max((jlo // 8) * 8 - 8, 0)
        off = min(off, (max(tb - window, 0) + 7) // 8 * 8)
        off = min(off, off_prev + s_max)
        offs.append(off)
        off_prev = off
    valid = np.zeros((ta, tb), dtype=bool)
    for i in range(ta):
        off = offs[i // row_block]
        for j in range(max(off, 0), min(off + window, tb)):
            if abs(j * lam1 - i * lbm1) <= r2:
                valid[i, j] = True
    return valid


def _dp_unconstrained(cost: np.ndarray) -> np.ndarray:
    """Classical DP table: steps {(1,0),(0,1),(1,1)}, start (0,0)."""
    ta, tb = cost.shape
    dp = np.full((ta, tb), BIG, dtype=np.float64)
    dp[0, 0] = cost[0, 0]
    for j in range(1, tb):
        dp[0, j] = dp[0, j - 1] + cost[0, j]
    for i in range(1, ta):
        dp[i, 0] = dp[i - 1, 0] + cost[i, 0]
        for j in range(1, tb):
            dp[i, j] = cost[i, j] + min(dp[i - 1, j], dp[i, j - 1],
                                        dp[i - 1, j - 1])
    return dp


def _dp_itakura_tables(cost: np.ndarray):
    """Itakura slope-constrained DP tables (DtwConfig.slope="itakura").

    Steps {(1,0),(1,1),(1,2)} with no two consecutive (1,0):

        N[i,j] = c[i,j] + min(D[i-1,j-1], D[i-1,j-2])   (diagonal arrival)
        D[i,j] = min(N[i,j], c[i,j] + N[i-1,j])         (or one vertical)

    Cells unreachable under the slope limit stay ~BIG (finite; BIG
    accumulates additively, never overflows f32).  Returns (D, N).
    """
    ta, tb = cost.shape
    dp = np.full((ta, tb), BIG, dtype=np.float64)   # D: best any-arrival
    nd = np.full((ta, tb), BIG, dtype=np.float64)   # N: non-vertical arrival
    dp[0, 0] = nd[0, 0] = cost[0, 0]
    for i in range(1, ta):
        for j in range(tb):
            best_n = dp[i - 1, j - 1] if j >= 1 else BIG
            if j >= 2:
                best_n = min(best_n, dp[i - 1, j - 2])
            n = cost[i, j] + best_n
            nd[i, j] = n
            dp[i, j] = min(n, cost[i, j] + nd[i - 1, j])
    return dp, nd


def _dp_itakura(cost: np.ndarray) -> np.ndarray:
    return _dp_itakura_tables(cost)[0]


def _backtrace_itakura(cost: np.ndarray, dp: np.ndarray, nd: np.ndarray):
    """Optimal Itakura path, end-first, from the (D, N) value tables.

    State D may take a vertical step (to state N at the row above,
    since two verticals never chain); state N must arrive diagonally.
    Ties prefer the non-vertical branch, then the (1,1) step — the jax
    backtrace (ops/align.py) uses the identical rules so paths match
    exactly.
    """
    ta, tb = cost.shape
    i, j, vert_ok = ta - 1, tb - 1, True
    path = [(i, j)]
    while i > 0:
        if vert_ok and cost[i, j] + nd[i - 1, j] < nd[i, j]:
            i, vert_ok = i - 1, False
        else:
            d1 = dp[i - 1, j - 1] if j >= 1 else BIG
            d2 = dp[i - 1, j - 2] if j >= 2 else BIG
            dj = 1 if d1 <= d2 else 2
            # j<0 can only happen tracing an UNREACHABLE (all-BIG) end
            # cell; clamp so the degenerate walk still terminates cleanly
            i, j, vert_ok = i - 1, max(j - dj, 0), True
        path.append((i, j))
    return path


def dtw_distance_masked(a: np.ndarray, b: np.ndarray, valid: np.ndarray,
                        squared: bool = False, slope: str | None = None) -> float:
    """DTW over an explicit valid-cell mask (BIG elsewhere), normalised.

    Oracle for windowed/banded kernels: identical recurrence to
    ``dtw_distance`` with the mask supplied by the caller.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ta, tb = a.shape[0], b.shape[0]
    diff = a[:, None, :] - b[None, :, :]
    cost = np.sum(diff * diff, axis=-1)
    if not squared:
        cost = np.sqrt(np.maximum(cost, 0.0))
    cost = np.where(valid, cost, BIG)
    dp = _dp_itakura(cost) if slope == "itakura" else _dp_unconstrained(cost)
    return dp[ta - 1, tb - 1] / float(ta + tb)


def dtw_distance(
    a: np.ndarray,
    b: np.ndarray,
    cfg: DtwConfig = DtwConfig(),
    return_path: bool = False,
    plan_shape: tuple[int, int] | None = None,
):
    """DTW distance between feature sequences a [Ta, F] and b [Tb, F].

    ``plan_shape`` pins the (t, u) problem shape the banded window
    schedule is planned for; the padded implementations plan on their
    static array shapes, so pass those here when checking parity against
    them (defaults to the actual (ta, tb)).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ta, tb = a.shape[0], b.shape[0]
    assert ta > 0 and tb > 0

    diff = a[:, None, :] - b[None, :, :]
    cost = np.sum(diff * diff, axis=-1)
    if not cfg.squared:
        cost = np.sqrt(np.maximum(cost, 0.0))

    if cfg.band_frac is not None:
        # band around the stretched diagonal j ~ i * (tb-1)/(ta-1),
        # evaluated in the integer domain (see ops/dtw.py band_r2) so the
        # boundary is bit-identical across numpy / XLA / Pallas, and
        # intersected with the windowed-band schedule when
        # max_warp_scale is set (the framework-wide banded semantics)
        if cfg.max_warp_scale is not None:
            from dsp_asr.window_plan import plan_window

            pt, pu = plan_shape if plan_shape is not None else (ta, tb)
            w, s_max, _, rb, _ = plan_window(cfg.band_frac, pt, pu,
                                             cfg.max_warp_scale)
            valid = windowed_band_mask(ta, tb, cfg.band_frac,
                                       window=w, row_block=rb, s_max=s_max)
            cost = np.where(valid, cost, BIG)
        else:
            lam1, lbm1, r2 = band_r2_int(ta, tb, cfg.band_frac)
            for i in range(ta):
                for j in range(tb):
                    if abs(j * lam1 - i * lbm1) > r2:
                        cost[i, j] = BIG

    if cfg.slope == "itakura":
        dp, nd = _dp_itakura_tables(cost)
        dist = dp[ta - 1, tb - 1] / float(ta + tb)
        if not return_path:
            return dist
        return dist, _backtrace_itakura(cost, dp, nd)[::-1]
    dp = _dp_unconstrained(cost)

    dist = dp[ta - 1, tb - 1] / float(ta + tb)
    if not return_path:
        return dist

    # backtrace
    path = [(ta - 1, tb - 1)]
    i, j = ta - 1, tb - 1
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            choices = [(dp[i - 1, j - 1], i - 1, j - 1),
                       (dp[i - 1, j], i - 1, j),
                       (dp[i, j - 1], i, j - 1)]
            _, i, j = min(choices, key=lambda c: c[0])
        path.append((i, j))
    return dist, path[::-1]


def classify(feats: np.ndarray, bank, cfg: DtwConfig = DtwConfig(),
             plan_shape: tuple[int, int] | None = None):
    """Nearest-template classification.

    ``bank`` is a list of (label, template_feats).  Returns
    (best_label, distances list).  ``plan_shape`` pins the banded window
    plan to a padded problem shape (see dtw_distance).
    """
    dists = [dtw_distance(feats, tmpl, cfg, plan_shape=plan_shape)
             for _, tmpl in bank]
    best = int(np.argmin(dists))
    return bank[best][0], dists
