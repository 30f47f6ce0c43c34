"""Data-parallel distributed GMM-HMM training step.

The distributed-training analog in this framework: each 'data' shard
Viterbi-aligns its slice of the utterance batch and computes *additive*
sufficient statistics (SuffStats); one `psum` over the data axis reduces
them across the mesh; the closed-form M-step then produces
identical new parameters on every device.  This is exactly the
reduce-gradients/apply-update shape of DP neural-net training, with
sufficient statistics in place of gradients.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from dsp_asr.config import HmmConfig
from dsp_asr.models.gmm_hmm import (
    HmmParams,
    SuffStats,
    _params_from_stats,
    em_suff_stats,
)
from dsp_asr.parallel.mesh import DATA_AXIS


def em_step_sharded(mesh: Mesh, feats: jax.Array, lengths: jax.Array,
                    params: HmmParams, cfg: HmmConfig):
    """One distributed segmental-EM step.

    Args:
      feats:   [N, T, F] sharded P('data', None, None); N divisible by
               the data axis size.
      lengths: [N] sharded P('data').
      params:  replicated HmmParams for ONE word model.

    Returns (new replicated HmmParams, total loglik scalar).
    """

    def local(fts, lens, prm):
        stats = em_suff_stats(fts, lens, prm, cfg)
        stats = SuffStats(*(jax.lax.psum(s, DATA_AXIS) for s in stats))
        return _params_from_stats(stats, prm, cfg), stats.loglik

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return mapped(feats, lengths, params)
