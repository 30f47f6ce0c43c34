"""Golden numpy subsequence DTW — keyword spotting oracle.

Open-begin / open-end DTW (classical unconstrained-endpoint matching;
the online form is the SPRING algorithm, Sakurai et al. 2007): a short
keyword template a [Ta, F] is matched against ANY contiguous span of a
long stream b [Tb, F].  Two boundary changes vs classical DTW
(golden/dtw.py):

* **open begin** — the path may start at (0, j) for any stream column
  j: the virtual row above the table is 0 everywhere instead of BIG, so
  D[0, j] = c[0, j] exactly (costs are >= 0, accumulating a horizontal
  prefix can never beat a fresh start).
* **open end** — every last-row cell D[Ta-1, j] is a candidate match
  ending at stream frame j; there is no single (Ta-1, Tb-1) readout.

Each end column j carries a START WITNESS s[j]: the stream column where
the best path into (i, j) began.  Matches are normalised by their own
path-span analog of the repo's (Ta + Tb) convention:

    norm[j] = D[Ta-1, j] / (Ta + (j - s[j] + 1))

so scores are comparable across templates of different lengths and to
the classifier's normalised distances.

Event extraction (``spot_events``) walks the fused per-column best
score, takes local minima under a threshold, and suppresses overlaps
greedily best-first — the oracle for the vectorised version in
dsp_asr/ops/spot.py.

Reference parity: the reference (SURVEY.md §2a) has no keyword spotter —
its endpoint detector + whole-word DTW requires silence-delimited
utterances.  This module extends the same template machinery to
unsegmented audio, which the SURVEY §3.3 live-demo stack implies
(continuous mic capture).
"""

from __future__ import annotations

import numpy as np

BIG = 1e30


def subseq_tables(cost: np.ndarray):
    """DP + start-witness tables for subsequence DTW.

    cost [Ta, Tb] (BIG at masked cells).  Steps {(1,0),(0,1),(1,1)}.
    Returns (dp [Ta, Tb], start [Ta, Tb] int).  Ties prefer, in order:
    diagonal, vertical, horizontal — fixed so witnesses are deterministic.
    """
    ta, tb = cost.shape
    dp = np.full((ta, tb), BIG, dtype=np.float64)
    st = np.zeros((ta, tb), dtype=np.int64)
    for j in range(tb):
        dp[0, j] = cost[0, j]
        st[0, j] = j
        # horizontal continuation along row 0 can never beat the fresh
        # start (costs >= 0) — matches the vector init d_prev = 0
        if j > 0 and dp[0, j - 1] + cost[0, j] < dp[0, j]:
            dp[0, j] = dp[0, j - 1] + cost[0, j]
            st[0, j] = st[0, j - 1]
    for i in range(1, ta):
        dp[i, 0] = dp[i - 1, 0] + cost[i, 0]
        st[i, 0] = st[i - 1, 0]
        for j in range(1, tb):
            cands = ((dp[i - 1, j - 1], st[i - 1, j - 1]),
                     (dp[i - 1, j], st[i - 1, j]),
                     (dp[i, j - 1], st[i, j - 1]))
            best = min(range(3), key=lambda k: cands[k][0])
            dp[i, j] = cost[i, j] + cands[best][0]
            st[i, j] = cands[best][1]
    return dp, st


def subseq_dtw(a: np.ndarray, b: np.ndarray, squared: bool = False):
    """Keyword template a [Ta,F] vs stream b [Tb,F].

    Returns (norm [Tb], start [Tb]): per-end-column normalised match
    cost and the start column of that match.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    diff = a[:, None, :] - b[None, :, :]
    cost = np.sum(diff * diff, axis=-1)
    if not squared:
        cost = np.sqrt(np.maximum(cost, 0.0))
    dp, st = subseq_tables(cost)
    ta = a.shape[0]
    span = np.arange(b.shape[0]) - st[ta - 1] + 1
    return dp[ta - 1] / (ta + span), st[ta - 1]


def spot_events(norm: np.ndarray, start: np.ndarray, threshold: float,
                labels: np.ndarray | None = None, min_gap: int = 0):
    """Greedy best-first event extraction over per-column match scores.

    norm [K, Tb] (or [Tb]), start likewise.  Picks the globally best
    column under ``threshold``, emits (label_row, start, end, score),
    suppresses every column whose match span overlaps the emitted one
    (across ALL templates), repeats.  Deterministic: ties broken by
    (score, row, column) lexicographic order.
    """
    norm = np.atleast_2d(np.asarray(norm, dtype=np.float64)).copy()
    start = np.atleast_2d(np.asarray(start, dtype=np.int64))
    k, tb = norm.shape
    events = []
    while True:
        flat = np.argmin(norm)
        r, j = divmod(int(flat), tb)
        score = norm[r, j]
        if not score < threshold:
            break
        s, e = int(start[r, j]), int(j)
        lbl = int(labels[r]) if labels is not None else r
        events.append((lbl, s, e, float(score)))
        # suppress every candidate whose span [start, end] overlaps
        # [s - min_gap, e + min_gap]
        cols = np.arange(tb)[None, :]
        overlap = (start <= e + min_gap) & (cols >= s - min_gap)
        norm[overlap] = BIG
    events.sort(key=lambda ev: ev[1])
    return events
