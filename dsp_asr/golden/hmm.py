"""Golden numpy log-space HMM algorithms (Viterbi + forward).

The reference's optional GMM-HMM decode path (SURVEY.md L3'; BASELINE.json
config 3) reduces to these two dynamic programs.  Emission log-likelihoods
logB[t, s] are computed by the model layer (dsp_asr/models/gmm_hmm.py);
the oracle here only runs the lattice recursions, loop-by-loop, as the
parity target for the batched lax.scan versions in dsp_asr/ops/viterbi.py.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -1e30


def viterbi_log(log_pi: np.ndarray, log_a: np.ndarray, log_b: np.ndarray):
    """Max-product decode.

    Args:
      log_pi: [S] initial state log-probs.
      log_a:  [S, S] transition log-probs (row = from, col = to).
      log_b:  [T, S] emission log-likelihoods.

    Returns (best_loglik, state_path [T]).
    """
    t_len, s = log_b.shape
    delta = log_pi + log_b[0]
    psi = np.zeros((t_len, s), dtype=np.int64)
    for t in range(1, t_len):
        scores = delta[:, None] + log_a          # [from, to]
        psi[t] = np.argmax(scores, axis=0)
        delta = scores[psi[t], np.arange(s)] + log_b[t]
    best_last = int(np.argmax(delta))
    path = np.zeros(t_len, dtype=np.int64)
    path[-1] = best_last
    for t in range(t_len - 1, 0, -1):
        path[t - 1] = psi[t, path[t]]
    return float(delta[best_last]), path


def forward_log(log_pi: np.ndarray, log_a: np.ndarray, log_b: np.ndarray) -> float:
    """Sum-product total log-likelihood via the forward algorithm."""
    t_len, s = log_b.shape
    alpha = log_pi + log_b[0]
    for t in range(1, t_len):
        alpha = _logsumexp(alpha[:, None] + log_a, axis=0) + log_b[t]
    return float(_logsumexp(alpha, axis=0))


def _logsumexp(x: np.ndarray, axis: int):
    m = np.max(x, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = np.log(np.sum(np.exp(x - m), axis=axis)) + np.squeeze(m, axis=axis)
    return out
