"""Fused banded DTW kernel for the GPU (Pallas, Triton route).

All-pairs windowed-band DTW, ``[B,T,F] x [K,U,F] -> [B,K]``, without the
``[B,K,T,U]`` cost tensor that the XLA row scan (ops/dtw.py) writes to
and reads back from device memory.  Each program owns ``LANES`` queries
against one template, one pair per lane; every lane runs its whole DP:

* **Band coordinates.**  Row ``i`` of a pair only ever holds valid
  cells in ``j = b_i + p``, ``p < P``, where ``b_i`` is the first column
  of the integer Sakoe-Chiba band (ops/dtw.py:band_r2) and ``P`` bounds
  the band width.  The DP row is ``P`` registers per lane (a Python
  tuple of ``[LANES]`` vectors, indexed statically), not a ``U``-wide
  row in memory.  Between rows the state moves left by the band advance
  ``b_i - b_{i-1}`` (per lane), applied as log2 static select stages.
* **Cost on the CUDA cores.**  The local cost of the ``P`` cells of a
  row is accumulated over the feature axis in a loop: one contiguous
  load of the queries' frame ``i`` and one gather of template frames
  ``b + p`` per feature, in f32, as ``sum((a - b)^2)``.
* **Masks as in the scan.**  A cell is valid iff ``j < lb``, inside the
  band, and inside the quantised window of ``window_plan.plan_window``
  (golden/dtw.py:windowed_band_mask is the oracle); invalid cells hold
  BIG, so live distances equal the scan's and dead pairs stay >= 1e20.

Supported: ``band_frac`` set (windowed or pure band), ``slope`` None or
"itakura", ``squared`` either way, band width ``P <= MAX_BAND``.
Queries are sorted by length before the lanes are filled, so that most
programs stop their row loop early.  Everything else is the scan's (routing: ``supports``, ``faster_than_scan``,
pipeline.dtw_impl).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from dsp_asr.config import DtwConfig
from dsp_asr.ops.dtw import BIG
from dsp_asr.window_plan import LANE, plan_window, round_up as _round_up

LANES = 32          # pairs per program: one warp, one pair per thread
MAX_BAND = 128      # band cells held in registers per lane (x2 for itakura)
MIN_PAIRS = 4096            # crossovers measured on an H100 (faster_than_scan)
MIN_PAIRS_ITAKURA = 12800


def band_cells(band_frac: float, t: int, u: int) -> int:
    """Static bound ``P`` on the band width of any row, for lengths <= (t, u).

    The band |j*lam1 - i*lbm1| <= r2 holds at most floor(2*r2/lam1)+1 <=
    2*radius+1 columns, radius = max(1, band_frac*max(la, lb)) in f32
    (ops/dtw.py:band_r2); one more column absorbs f32 rounding.
    """
    radius = max(np.float32(1.0),
                 np.float32(band_frac) * np.float32(max(t, u)))
    return int(2 * float(radius)) + 2


def supports(cfg: DtwConfig, t: int, u: int) -> bool:
    """Whether the kernel implements ``cfg`` at problem shape [t, u]."""
    return (cfg.band_frac is not None
            and cfg.slope in (None, "itakura")
            and band_cells(cfg.band_frac, t, u) <= MAX_BAND)


def faster_than_scan(cfg: DtwConfig, b: int, k: int) -> bool:
    """Whether the kernel beat the XLA scan on an H100 at B queries x K
    templates (scripts/dtw_crossover.py; PERF.md, Findings).

    A program's time follows the rows it walks (its longest query, at
    about 38 us a row, latency-bound), while the scan pays its T
    sequential rows whatever the lengths, and more with more pairs.
    Without a slope the kernel won within one program's lanes and again
    from MIN_PAIRS pairs up.  With the Itakura slope the scan's row is
    elementwise and cheap; the kernel won only on large batches.
    """
    if cfg.slope == "itakura":
        return b * k >= MIN_PAIRS_ITAKURA
    return b <= LANES or b * k >= MIN_PAIRS


def _shift(vals, s, lead: int, nbits: int):
    """out[m] = vals[m + s - lead] (BIG outside), s >= 0 per lane."""
    big = jnp.full_like(vals[0], BIG)
    cur = (big,) * lead + tuple(vals)
    n = len(cur)
    for k in range(nbits):
        take = (s & (1 << k)) != 0
        cur = tuple(jnp.where(take, cur[m + (1 << k)] if m + (1 << k) < n
                              else big, cur[m]) for m in range(n))
    return cur


def _kernel(la_ref, lb_ref, q_ref, t_ref, out_ref, *, n_feat: int,
            n_band: int, band_frac: float, windowed: bool, w: int,
            s_max: int, rb: int, squared: bool, itakura: bool, u: int):
    f32, i32 = jnp.float32, jnp.int32
    qi = pl.program_id(0)
    k = pl.program_id(1)
    lanes = pl.ds(qi * LANES, LANES)
    la = la_ref[lanes]                                   # [LANES] i32 >= 1
    lb = lb_ref[k]                                       # scalar i32 >= 1
    lbm1 = lb - 1
    lam1 = jnp.maximum(la - 1, 1)
    radius = jnp.maximum(f32(1.0),
                         f32(band_frac) * jnp.maximum(la, lb).astype(f32))
    r2 = jnp.floor(radius * lam1.astype(f32)).astype(i32)
    clip8 = ((jnp.maximum(lb - w, 0) + 7) >> 3) << 3
    nbits = max(1, (n_band + 2).bit_length())
    smax_shift = (1 << nbits) - 1
    big = jnp.full((LANES,), BIG, f32)

    def row(i, carry):
        d_prev, n_prev, b_prev, off, kept = carry
        num = jnp.maximum(i * lbm1 - r2, 0)
        b = jax.lax.div(num + lam1 - 1, lam1)            # band start b_i
        if windowed:   # ops/dtw.py:window_offsets, one step per row block
            raw = jnp.minimum(jnp.maximum(((b >> 3) << 3) - 8, 0), clip8)
            off = jnp.where(jax.lax.rem(i, rb) == 0,
                            jnp.minimum(raw, off + s_max), off)
        s = jnp.minimum(b - b_prev, smax_shift)

        def feat(f, acc):
            qf = q_ref[i, f, lanes]
            out = []
            for p in range(n_band):
                tf = t_ref[k, f, jnp.minimum(b + p, u - 1)]
                dlt = qf - tf
                out.append(acc[p] + dlt * dlt)
            return tuple(out)

        cost = jax.lax.fori_loop(0, n_feat, feat,
                                 tuple(jnp.zeros((LANES,), f32)
                                       for _ in range(n_band)))
        if not squared:
            cost = tuple(jnp.sqrt(c) for c in cost)
        ilbm1 = i * lbm1
        valid = []
        for p in range(n_band):
            j = b + p
            v = (j <= lbm1) & (jnp.abs(j * lam1 - ilbm1) <= r2)
            if windowed:
                v = v & (j >= off) & (j < off + w)
            valid.append(v)
        first = i == 0                        # D[-1,-1] = 0 starts the path

        if itakura:
            # N[i,j] = c + min(D[i-1,j-1], D[i-1,j-2]); D = min(N, c + N[i-1,j])
            dd = _shift(d_prev, s, 2, nbits)             # dd[m] ~ j = b+m-2
            nn = _shift(n_prev, s, 0, nbits)             # nn[m] ~ j = b+m
            d_new, n_new = [], []
            for p in range(n_band):
                diag1 = jnp.where(first, 0.0, dd[1]) if p == 0 else dd[p + 1]
                nv = jnp.where(valid[p], cost[p] + jnp.minimum(diag1, dd[p]),
                               big)
                n_new.append(nv)
                d_new.append(jnp.where(valid[p],
                                       jnp.minimum(nv, cost[p] + nn[p]), big))
            n_new = tuple(n_new)
        else:
            ext = _shift(d_prev, s, 1, nbits)            # ext[m] ~ j = b+m-1
            d_new, left = [], big
            for p in range(n_band):
                diag = jnp.where(first, 0.0, ext[0]) if p == 0 else ext[p]
                m = jnp.minimum(jnp.minimum(ext[p + 1], diag), left)
                left = jnp.where(valid[p], cost[p] + m, big)
                d_new.append(left)
            n_new = n_prev
        pe = lbm1 - b                                    # answer column
        hit = big
        for p in range(n_band):
            hit = jnp.where(pe == p, d_new[p], hit)
        kept = jnp.where(i == la - 1, hit, kept)
        return tuple(d_new), n_new, b, off, kept

    init_d = (big,) * n_band
    init = (init_d, init_d if itakura else (), jnp.zeros((LANES,), i32),
            jnp.zeros((LANES,), i32), big)
    kept = jax.lax.fori_loop(0, jnp.max(la), row, init)[4]
    out_ref[k, lanes] = kept


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def dtw_batch_fused_banded(queries: jax.Array, q_lens: jax.Array,
                           bank: jax.Array, bank_lens: jax.Array,
                           cfg: DtwConfig = DtwConfig(),
                           interpret: bool = False) -> jax.Array:
    """All-pairs windowed-band DTW: [B,T,F] x [K,U,F] -> [B,K] distances.

    Same distances as ops/dtw.py:dtw_batch (to f32 rounding of the local
    cost) for every config ``supports`` accepts; ``interpret`` runs the
    kernel on the CPU (tests only).
    """
    bsz, t, n_feat = queries.shape
    k, u, _ = bank.shape
    if not supports(cfg, t, u):
        raise ValueError(f"the banded DTW kernel does not implement {cfg} "
                         f"at T={t}, U={u}; use impl='scan'")
    w, s_max, _, rb, _ = plan_window(cfg.band_frac, t, u, cfg.max_warp_scale)
    windowed = cfg.max_warp_scale is not None and w < _round_up(u, LANE)
    b_pad = _round_up(bsz, LANES)
    # lanes of one program take queries of similar length, so the row
    # loop of most programs stops well before T
    order = jnp.argsort(q_lens)
    # query frames lane-contiguous [T, F, B], template frames [K, F, U]
    q = jnp.pad(queries[order].astype(jnp.float32),
                ((0, b_pad - bsz), (0, 0), (0, 0))).transpose(1, 2, 0)
    tb = bank.astype(jnp.float32).transpose(0, 2, 1)
    la = jnp.pad(jnp.clip(q_lens[order].astype(jnp.int32), 1, t),
                 (0, b_pad - bsz), constant_values=1)
    lb = jnp.clip(bank_lens.astype(jnp.int32), 1, u)
    kernel = functools.partial(
        _kernel, n_feat=n_feat, n_band=band_cells(cfg.band_frac, t, u),
        band_frac=cfg.band_frac, windowed=windowed, w=w, s_max=s_max, rb=rb,
        squared=cfg.squared, itakura=cfg.slope == "itakura", u=u)
    raw = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((k, b_pad), jnp.float32),
        grid=(b_pad // LANES, k),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="dtw_fused_banded",
    )(la, lb, q, tb)
    raw = raw.T[:bsz][jnp.argsort(order)]
    return raw / (q_lens[:, None] + bank_lens[None, :]).astype(jnp.float32)
