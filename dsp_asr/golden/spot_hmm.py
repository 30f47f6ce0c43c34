"""Golden numpy HMM keyword spotting — open-endpoint Viterbi oracle.

The classical keyword/filler design (Rose & Paul 1990; Rohlicek et al.
1989): a left-right word HMM may ENTER (state 0) at any stream frame
and EXIT (last state) at any later frame; spans score by the per-frame
log-likelihood RATIO against a filler — here the universal background
GMM (models/gmm_hmm.py:fit_ubm), the framework's existing UBM:

    llr[j] = ( V[j, S-1] - (P[j] - P[s_j - 1]) ) / (j - s_j + 1)

with V the open-begin Viterbi table, s_j the entry-frame witness and
P the cumulative UBM log-likelihood.  A keyword hit makes the word HMM
explain the span better than the background model (llr > 0-ish); the
normalisation makes thresholds transfer across spans and words.

Tie-breaks: fresh start > stay > advance (deterministic; exact float
ties are measure-zero on continuous features).  Oracle for
dsp_asr/ops/spot_hmm.py.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -1e30


def spot_viterbi_tables(log_a: np.ndarray, log_b: np.ndarray):
    """Open-begin Viterbi for ONE word HMM over a stream.

    log_a [S, S] left-right transitions, log_b [U, S] emission log-liks
    of each stream frame under each state.  Entry at state 0 carries
    log-prob 0 at ANY frame (the open begin); no exit cost (the last
    state absorbs).  Returns (V [U, S], start [U, S]) — best path
    log-lik into (frame j, state k) and its entry-frame witness.
    """
    u, s = log_b.shape
    v = np.full((u, s), NEG_INF, dtype=np.float64)
    st = np.zeros((u, s), dtype=np.int64)
    for j in range(u):
        for k in range(s):
            cands = [(NEG_INF, 0)]                           # unreachable
            if k == 0:
                cands.append((0.0, j))                       # fresh start
            if j > 0:
                cands.append((v[j - 1, k] + log_a[k, k], st[j - 1, k]))
                if k > 0:
                    cands.append((v[j - 1, k - 1] + log_a[k - 1, k],
                                  st[j - 1, k - 1]))
            best = max(range(len(cands)), key=lambda i: cands[i][0])
            v[j, k] = log_b[j, k] + cands[best][0]
            st[j, k] = cands[best][1]
    return v, st


def spot_llr(v: np.ndarray, st: np.ndarray, ubm_ll: np.ndarray):
    """Per-end-frame normalised log-likelihood ratio vs the filler.

    v/st from spot_viterbi_tables, ubm_ll [U] per-frame UBM log-lik.
    Returns (llr [U], start [U]) reading the LAST state per column.
    """
    u = v.shape[0]
    p = np.concatenate([[0.0], np.cumsum(ubm_ll)])          # P[j] = sum <= j
    end_v = v[:, -1]
    start = st[:, -1]
    j = np.arange(u)
    span = j - start + 1
    ubm_span = p[j + 1] - p[start]
    return (end_v - ubm_span) / span, start
