"""GMM-HMM isolated-word recognizer (the reference's statistical path).

Capability parity with the reference's optional GMM-HMM + Viterbi decode
(SURVEY.md L3', BASELINE.json config 3), built for the accelerator:

* **Emission scoring is a GEMM.**  The diagonal-Gaussian log-likelihood
  expands as ``-0.5 (x^2 . v^-1  -  2 x . (mu v^-1)  +  c)`` so scoring a
  feature batch against *every* (word, state, mixture) at once is one
  ``[B*T, F] @ [F, W*S*M]`` matmul — no [., ., F] broadcast
  tensor is ever materialised.

* **Decode is one batched scan.**  Log-space Viterbi over [B, W, S]
  log-deltas (dsp_asr/ops/viterbi.py): a single `lax.scan` scores a
  whole utterance batch against the whole vocabulary.

* **Training is segmental (Viterbi) EM**: uniform-segmentation init,
  then iterate {GMM M-step from state-aligned frames, Viterbi re-align}.
  Each iteration is a jitted program; the outer loop is a fixed host
  loop over `cfg.n_iter`.

Left-to-right topology: start in state 0, transitions {stay, advance}.
"""

from __future__ import annotations

import functools
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr import pipeline as pl
from dsp_asr.config import HmmConfig, PipelineConfig
from dsp_asr.ops import frontend as fe
from dsp_asr.ops.viterbi import viterbi_decode, viterbi_score

NEG_INF = -1e30
LOG_2PI = float(np.log(2.0 * np.pi))


class HmmParams(NamedTuple):
    """Left-to-right GMM-HMM parameters; leading dims may batch words."""

    log_pi: jax.Array    # [..., S]
    log_a: jax.Array     # [..., S, S]
    means: jax.Array     # [..., S, M, F]
    log_var: jax.Array   # [..., S, M, F]
    log_mix: jax.Array   # [..., S, M]


# --------------------------------------------------------------- emissions
def gmm_loglik_flat(x: jax.Array, means: jax.Array, log_var: jax.Array) -> jax.Array:
    """Diagonal-Gaussian log-lik via GEMM: x [..., F], params [K, F] -> [..., K].

    The three terms of the expansion are individually large and cancel, so
    the matmuls MUST run at f32 precision — with reduced-precision
    multiplies (bf16, or TF32 on a GPU's tensor cores) the per-word score
    differences drown in rounding (observed: chance-level decoding).
    """
    f = x.shape[-1]
    hi = jax.lax.Precision.HIGHEST
    inv_var = jnp.exp(-log_var)                                   # [K, F]
    a = jnp.matmul(x * x, inv_var.T, precision=hi)                # [..., K]
    b = jnp.matmul(x, (means * inv_var).T, precision=hi)          # [..., K]
    c = jnp.sum(means * means * inv_var + log_var, axis=-1)       # [K]
    return -0.5 * (a - 2.0 * b + c + f * LOG_2PI)


def emission_logb(x: jax.Array, params: HmmParams) -> jax.Array:
    """x [..., F] + params [*lead, S, M, F] -> logB [..., *lead, S]."""
    lead = params.means.shape[:-1]                                # (*, S, M)
    f = params.means.shape[-1]
    flat_means = params.means.reshape(-1, f)
    flat_lv = params.log_var.reshape(-1, f)
    ll = gmm_loglik_flat(x, flat_means, flat_lv)                  # [..., K]
    ll = ll.reshape(*x.shape[:-1], *lead)                         # [..., *, S, M]
    return jax.nn.logsumexp(ll + params.log_mix, axis=-1)         # [..., *, S]


# ------------------------------------------------------------------ decode
@functools.partial(jax.jit, static_argnames=())
def score_words(feats: jax.Array, lengths: jax.Array, params: HmmParams) -> jax.Array:
    """feats [B, T, F] x stacked word params [W, ...] -> loglik [B, W]."""
    logb = emission_logb(feats, params)                 # [B, T, W, S]
    logb = jnp.moveaxis(logb, 1, 0)                     # [T, B, W, S]
    return viterbi_score(params.log_pi[None], params.log_a[None],
                         logb, lengths[:, None])


@jax.jit
def score_ubm(feats: jax.Array, lengths: jax.Array, ubm) -> jax.Array:
    """feats [B, T, F] x UBM (means/log_var/log_mix [M, ...]) -> total
    log-lik [B] over the valid frames — the filler/background score the
    utterance-verification LLR normalizes against (same role the UBM
    plays per-frame in HMM keyword spotting, ops/spot_hmm.py)."""
    means, log_var, log_mix = ubm
    ll = gmm_loglik_flat(feats, means, log_var) + log_mix   # [B, T, M]
    fr = jax.nn.logsumexp(ll, axis=-1)                      # [B, T]
    mask = jnp.arange(feats.shape[1])[None, :] < lengths[:, None]
    return jnp.sum(jnp.where(mask, fr, 0.0), axis=1)


# ---------------------------------------------------------------- training
def _uniform_alignment(t_max: int, length: jax.Array, n_states: int) -> jax.Array:
    """Initial state of frame t: floor(t * S / length), clipped; [T] int32."""
    t_idx = jnp.arange(t_max)
    st = (t_idx * n_states) // jnp.maximum(length, 1)
    return jnp.clip(st, 0, n_states - 1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _extract_and_score(xs, ns, params, mats, cfg):
    """Module-level jitted extract+score so repeated sharded decode calls
    reuse one compiled program (ADVICE round 2: an @jax.jit defined inside
    the method retraced per call)."""
    feats = pl.extract_features(xs, ns, mats, cfg)
    return score_words(feats.feats, feats.length, params)


def _lr_log_a(stay_prob: jax.Array, n_states: int) -> jax.Array:
    """Left-to-right transition matrix from per-state stay probabilities."""
    s = n_states
    stay = jnp.clip(stay_prob, 1e-4, 1.0 - 1e-4)
    log_a = jnp.full((s, s), NEG_INF)
    di = jnp.arange(s)
    log_a = log_a.at[di, di].set(jnp.log(stay))
    log_a = log_a.at[di[:-1], di[:-1] + 1].set(jnp.log1p(-stay[:-1]))
    # final state absorbs
    log_a = log_a.at[s - 1, s - 1].set(0.0)
    return log_a


@functools.partial(jax.jit, static_argnames=("cfg",))
def init_params(feats: jax.Array, lengths: jax.Array, cfg: HmmConfig,
                key: jax.Array) -> HmmParams:
    """Uniform-segmentation init for one word: feats [N, T, F]."""
    s, m = cfg.n_states, cfg.n_mix
    n, t, f = feats.shape
    valid = jnp.arange(t)[None, :] < lengths[:, None]             # [N, T]
    align = jax.vmap(lambda L: _uniform_alignment(t, L, s))(lengths)
    gamma = jax.nn.one_hot(align, s) * valid[..., None]           # [N, T, S]

    w = gamma.reshape(-1, s).T                                    # [S, NT]
    x = feats.reshape(-1, f)
    tot = jnp.maximum(w.sum(-1, keepdims=True), 1e-6)             # [S, 1]
    # moment accumulations share gmm_loglik_flat's precision rule: the
    # E[x^2] - mean^2 variance form cancels catastrophically under
    # reduced-precision multiplies (observed: fit-time model corruption
    # — word LLRs off by tens of nats — where the CPU fit was fine)
    hi = jax.lax.Precision.HIGHEST
    mean_s = jnp.matmul(w, x, precision=hi) / tot                 # [S, F]
    var_s = jnp.matmul(w, x * x, precision=hi) / tot - mean_s**2
    var_s = jnp.maximum(var_s, cfg.var_floor)

    # spread M components around the state mean along the state stddev
    offs = jnp.linspace(-1.0, 1.0, m)[None, :, None]              # [1, M, 1]
    jitter = 0.05 * jax.random.normal(key, (s, m, f))
    means = mean_s[:, None, :] + (offs + jitter) * jnp.sqrt(var_s)[:, None, :]
    log_var = jnp.log(var_s)[:, None, :].repeat(m, axis=1)
    log_mix = jnp.full((s, m), -np.log(m))
    log_pi = jnp.full((s,), NEG_INF).at[0].set(0.0)
    log_a = _lr_log_a(jnp.full((s,), 0.6), s)
    return HmmParams(log_pi, log_a, means, log_var, log_mix)


class SuffStats(NamedTuple):
    """Additive sufficient statistics of one segmental-EM iteration.

    Additivity over the utterance axis is what makes the distributed EM
    step a plain `psum` over the 'data' mesh axis (dsp_asr/parallel/em.py).
    """

    tot: jax.Array        # [S, M]    sum of responsibilities
    sx: jax.Array         # [S, M, F] weighted sum of x
    sxx: jax.Array        # [S, M, F] weighted sum of x^2
    stay_cnt: jax.Array   # [S]       self-transition counts
    trans_cnt: jax.Array  # [S]       total transition counts
    loglik: jax.Array     # []        summed Viterbi log-likelihood


def _gmm_stats(feats: jax.Array, valid: jax.Array, gamma: jax.Array,
               params: HmmParams, cfg: HmmConfig):
    """Responsibility-weighted GMM moments: feats [N,T,F], gamma [N,T,S]."""
    s, m = cfg.n_states, cfg.n_mix
    n, t, f = feats.shape
    x = feats.reshape(-1, f)                                      # [NT, F]
    ll = gmm_loglik_flat(x, params.means.reshape(-1, f),
                         params.log_var.reshape(-1, f))
    ll = ll.reshape(n * t, s, m) + params.log_mix                 # [NT, S, M]
    resp = jax.nn.softmax(ll, axis=-1)                            # within-state
    w = (gamma * valid[..., None]).reshape(n * t, s)              # [NT, S]
    r = resp * w[..., None]                                       # [NT, S, M]
    tot = r.sum(0)                                                # [S, M]
    # f32 matmul precision: these sums feed the E[x^2] - mean^2 M-step
    # (see init_params — bf16 accumulation corrupts the fitted model)
    hi = jax.lax.Precision.HIGHEST
    sx = jnp.einsum("nsm,nf->smf", r, x, precision=hi)
    sxx = jnp.einsum("nsm,nf->smf", r, x * x, precision=hi)
    return tot, sx, sxx


def _params_from_stats(stats: SuffStats, params: HmmParams,
                       cfg: HmmConfig, prior: HmmParams | None = None
                       ) -> HmmParams:
    """Closed-form M-step from (possibly psum-reduced) sufficient stats.

    With ``prior`` (and cfg.map_tau > 0) the update is the classical
    relevance-MAP adaptation (Reynolds et al. speaker-adaptation rule):

        mean = (sx + tau * m0) / (tot + tau)
        var  = (sxx + tau * (v0 + m0^2)) / (tot + tau) - mean^2

    which interpolates towards the UBM when a component sees few frames
    — the few-shot regulariser the plain ML update lacks.
    """
    tot, sx, sxx = stats.tot, stats.sx, stats.sxx
    if prior is not None and cfg.map_tau > 0:
        tau = cfg.map_tau
        m0 = prior.means
        v0 = jnp.exp(prior.log_var)
        denom = (tot + tau)[..., None]
        mean_new = (sx + tau * m0) / denom
        var_new = (sxx + tau * (v0 + m0 * m0)) / denom - mean_new**2
        var_new = jnp.maximum(var_new, cfg.var_floor)
        mix_new = ((tot + tau * jnp.exp(prior.log_mix))
                   / jnp.maximum((tot + tau * jnp.exp(prior.log_mix))
                                 .sum(-1, keepdims=True), 1e-6))
        means, log_var = mean_new, jnp.log(var_new)
    else:
        tot_safe = jnp.maximum(tot, 1e-6)[..., None]
        mean_new = sx / tot_safe
        var_new = jnp.maximum(sxx / tot_safe - mean_new**2, cfg.var_floor)
        mix_new = tot / jnp.maximum(tot.sum(-1, keepdims=True), 1e-6)
        # keep old params for starved components
        alive = (tot > 1e-4)[..., None]
        means = jnp.where(alive, mean_new, params.means)
        log_var = jnp.where(alive, jnp.log(var_new), params.log_var)
    mix_new = jnp.maximum(mix_new, 1e-6)
    mix_new = mix_new / mix_new.sum(-1, keepdims=True)
    stay = jnp.where(stats.trans_cnt > 0,
                     stats.stay_cnt / jnp.maximum(stats.trans_cnt, 1.0), 0.6)
    return params._replace(means=means, log_var=log_var,
                           log_mix=jnp.log(mix_new),
                           log_a=_lr_log_a(stay, cfg.n_states))


def em_suff_stats(feats: jax.Array, lengths: jax.Array, params: HmmParams,
                  cfg: HmmConfig) -> SuffStats:
    """E-step: Viterbi-align a shard of utterances, return additive stats."""
    n, t, f = feats.shape
    valid = jnp.arange(t)[None, :] < lengths[:, None]
    logb = emission_logb(feats, params)                           # [N, T, S]
    _, paths = jax.vmap(lambda lb, L: viterbi_decode(
        params.log_pi, params.log_a, lb, L))(logb, lengths)      # [N, T]
    gamma = jax.nn.one_hot(paths, cfg.n_states) * valid[..., None]
    tot, sx, sxx = _gmm_stats(feats, valid, gamma, params, cfg)

    cur, nxt = paths[:, :-1], paths[:, 1:]
    pair_valid = (valid[:, :-1] & valid[:, 1:]).astype(jnp.float32)
    onehot = jax.nn.one_hot(cur, cfg.n_states) * pair_valid[..., None]
    stay = (cur == nxt).astype(jnp.float32) * pair_valid
    stay_cnt = (onehot * stay[..., None]).sum((0, 1))
    trans_cnt = onehot.sum((0, 1))
    loglik = jnp.sum(viterbi_score(params.log_pi, params.log_a,
                                   jnp.moveaxis(logb, 1, 0), lengths))
    return SuffStats(tot, sx, sxx, stay_cnt, trans_cnt, loglik)


def _forward_backward(log_pi, log_a, log_b, length):
    """Log-space alphas/betas for one sequence (log_b [T, S], masked).

    alpha[t] is carried through unchanged for t >= length; beta is 0 at
    t == length-1 and NEG_INF beyond, so gamma is valid on [0, length).
    Returns (alpha [T,S], beta [T,S], loglik).
    """
    t_len, s = log_b.shape
    ts = jnp.arange(t_len)

    def fwd(alpha, inp):
        emit, ti = inp
        new = jax.nn.logsumexp(alpha[:, None] + log_a, axis=0) + emit
        new = jnp.where(ti < length, new, alpha)
        return new, new

    alpha0 = log_pi + log_b[0]
    _, alphas = jax.lax.scan(fwd, alpha0, (log_b[1:], ts[1:]))
    alphas = jnp.concatenate([alpha0[None], alphas])
    # loglik read at the true last frame
    loglik = jax.nn.logsumexp(alphas[jnp.clip(length - 1, 0, t_len - 1)])

    def bwd(beta_next, inp):
        emit_next, ti = inp           # emission at ti+1, computing beta[ti]
        cand = jax.nn.logsumexp(log_a + (emit_next + beta_next)[None, :],
                                axis=1)
        beta = jnp.where(ti == length - 1, 0.0,
                         jnp.where(ti < length - 1, cand, NEG_INF))
        return beta, beta

    beta_last = jnp.where(t_len - 1 == length - 1, 0.0, NEG_INF) * jnp.ones(s)
    _, betas_rev = jax.lax.scan(bwd, beta_last, (log_b[1:], ts[:-1]),
                                reverse=True)
    betas = jnp.concatenate([betas_rev, beta_last[None]])
    return alphas, betas, loglik


def em_suff_stats_soft(feats: jax.Array, lengths: jax.Array, params: HmmParams,
                       cfg: HmmConfig) -> SuffStats:
    """Baum-Welch E-step: forward-backward occupancies instead of a hard
    Viterbi alignment; same additive SuffStats (so the distributed psum
    path and the closed-form M-step are shared with segmental training)."""
    n, t, f = feats.shape
    s = cfg.n_states
    valid = jnp.arange(t)[None, :] < lengths[:, None]
    logb = emission_logb(feats, params)                           # [N, T, S]

    alphas, betas, logliks = jax.vmap(
        lambda lb, L: _forward_backward(params.log_pi, params.log_a, lb, L)
    )(logb, lengths)                                              # [N,T,S] x2, [N]

    log_gamma = alphas + betas - logliks[:, None, None]
    gamma = jnp.exp(jnp.minimum(log_gamma, 0.0)) * valid[..., None]  # [N,T,S]
    tot, sx, sxx = _gmm_stats(feats, valid, gamma, params, cfg)

    # transition occupancies (left-to-right: stay vs advance)
    pair_valid = (valid[:, :-1] & valid[:, 1:]).astype(jnp.float32)

    def xi_counts(which):
        # which = 0: stay (s->s); 1: advance (s->s+1)
        if which == 0:
            a_diag = jnp.diagonal(params.log_a)                   # [S]
            src = alphas[:, :-1]                                  # [N,T-1,S]
            dst = (logb[:, 1:] + betas[:, 1:])                    # [N,T-1,S]
            lx = src + a_diag + dst - logliks[:, None, None]
        else:
            a_up = jnp.diagonal(params.log_a, offset=1)           # [S-1]
            src = alphas[:, :-1, :-1]
            dst = (logb[:, 1:, 1:] + betas[:, 1:, 1:])
            lx = src + a_up + dst - logliks[:, None, None]
            lx = jnp.pad(lx, ((0, 0), (0, 0), (0, 1)),
                         constant_values=NEG_INF)
        x = jnp.exp(jnp.minimum(lx, 0.0)) * pair_valid[..., None]
        return x.sum((0, 1))                                      # [S]

    stay_cnt = xi_counts(0)
    adv_cnt = xi_counts(1)
    return SuffStats(tot, sx, sxx, stay_cnt, stay_cnt + adv_cnt,
                     jnp.sum(logliks))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _em_iteration(feats: jax.Array, lengths: jax.Array, params: HmmParams,
                  cfg: HmmConfig):
    """One EM iteration for one word's utterances [N, T, F]; the E-step is
    segmental (Viterbi) or Baum-Welch per cfg.train_mode."""
    if cfg.train_mode == "baum_welch":
        stats = em_suff_stats_soft(feats, lengths, params, cfg)
    else:
        stats = em_suff_stats(feats, lengths, params, cfg)
    return _params_from_stats(stats, params, cfg), stats.loglik


def fit_word(feats: jax.Array, lengths: jax.Array,
             cfg: HmmConfig = HmmConfig(), seed: int | None = None,
             mesh=None) -> HmmParams:
    """Train one word model on its utterances (host loop, jitted steps).

    With ``mesh`` the E-step shards utterances over the 'data' axis and
    psum-reduces sufficient statistics (dsp_asr/parallel/em.py); the
    utterance count is padded to the axis size with zero-weight (length
    1, all-zero) utterances whose statistics vanish.
    """
    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)
    params = init_params(feats, lengths, cfg, key)
    if mesh is None:
        for _ in range(cfg.n_iter):
            params, _ = _em_iteration(feats, lengths, params, cfg)
        return params

    from dsp_asr import parallel as par

    nd = mesh.shape[par.DATA_AXIS]
    f_np, _ = par.pad_axis_to_multiple(np.asarray(feats), nd)
    l_np, n_orig = par.pad_axis_to_multiple(np.asarray(lengths), nd)
    # padding utterances: zero features, length 0 -> masked out of stats
    fd, ld = par.shard_queries(mesh, f_np, l_np)
    pd = jax.tree.map(lambda a: par.replicate(mesh, np.asarray(a)), params)
    for _ in range(cfg.n_iter):
        pd, _ = par.em_step_sharded(mesh, fd, ld, pd, cfg)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), pd)


def stack_params(params_list) -> HmmParams:
    return HmmParams(*(jnp.stack([getattr(p, f) for p in params_list])
                       for f in HmmParams._fields))


@functools.partial(jax.jit, static_argnames=("cfg",))
def fit_ubm(feats: jax.Array, lengths: jax.Array, cfg: HmmConfig,
            key: jax.Array):
    """Universal background GMM over ALL frames: (means, log_var, log_mix)
    each [M, F].  Diagonal-covariance EM, emission scoring as one matmul
    via gmm_loglik_flat — the UBM for MAP adaptation."""
    n, t, f = feats.shape
    m = cfg.n_mix
    x = feats.reshape(-1, f)                                  # [NT, F]
    wts = (jnp.arange(t)[None, :] < lengths[:, None]).reshape(-1)
    wts = wts.astype(jnp.float32)                             # [NT]
    total = jnp.maximum(wts.sum(), 1.0)
    hi = jax.lax.Precision.HIGHEST    # bf16 breaks E[x^2]-mean^2 (above)
    gmean = jnp.matmul(wts, x, precision=hi) / total
    gvar = jnp.maximum(jnp.matmul(wts, x * x, precision=hi) / total
                       - gmean**2, cfg.var_floor)
    # init: global mean/var with jittered means
    jitter = jax.random.normal(key, (m, f))
    means = gmean[None] + 0.3 * jitter * jnp.sqrt(gvar)[None]
    log_var = jnp.broadcast_to(jnp.log(gvar)[None], (m, f))
    log_mix = jnp.full((m,), -np.log(m))

    def em(carry, _):
        means, log_var, log_mix = carry
        ll = gmm_loglik_flat(x, means, log_var) + log_mix      # [NT, M]
        resp = jax.nn.softmax(ll, axis=-1) * wts[:, None]
        tot = jnp.maximum(resp.sum(0), 1e-6)                   # [M]
        mu = jnp.matmul(resp.T, x, precision=hi) / tot[:, None]
        var = jnp.maximum(jnp.matmul(resp.T, x * x, precision=hi)
                          / tot[:, None] - mu**2, cfg.var_floor)
        mix = jnp.maximum(tot / tot.sum(), 1e-6)
        return (mu, jnp.log(var), jnp.log(mix / mix.sum())), None

    (means, log_var, log_mix), _ = jax.lax.scan(
        em, (means, log_var, log_mix), None, length=cfg.ubm_iters)
    return means, log_var, log_mix


def ubm_prior(ubm, cfg: HmmConfig) -> HmmParams:
    """Tile the UBM across HMM states as the MAP prior (every state's
    mixtures start at, and shrink towards, the universal model)."""
    means, log_var, log_mix = ubm
    s = cfg.n_states
    return HmmParams(
        log_pi=jnp.full((s,), NEG_INF).at[0].set(0.0),
        log_a=_lr_log_a(jnp.full((s,), 0.6), s),
        means=jnp.broadcast_to(means[None], (s, *means.shape)),
        log_var=jnp.broadcast_to(log_var[None], (s, *log_var.shape)),
        log_mix=jnp.broadcast_to(log_mix[None], (s, *log_mix.shape)),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def fit_words_batched(feats_w: jax.Array, lengths_w: jax.Array,
                      seeds: jax.Array, cfg: HmmConfig,
                      prior: HmmParams | None = None) -> HmmParams:
    """EM for ALL word models in ONE jitted program.

    feats_w [W, N, T, F] / lengths_w [W, N]: per-word utterances padded to
    a common N with zero-length entries (their statistics vanish through
    the validity masks).  The per-word EM vmaps over the leading word
    axis and the fixed iteration count runs as a `lax.fori_loop`, so the
    whole vocabulary trains with one compile + one dispatch instead of
    W x n_iter launches (the round-1 fit() host loop).

    With ``prior`` (a UBM tiled over states, see ubm_prior) and
    cfg.map_tau > 0 every word initialises AT the prior and the M-step
    MAP-shrinks towards it — the few-shot recipe.

    Under a ('data','bank') mesh, shard feats_w P('bank','data') and the
    jit partitioner runs words across the bank axis and psum-reduces the
    utterance-sharded sufficient statistics — same layout as
    parallel/em.py's single-word step.
    """
    if prior is not None and cfg.map_tau > 0:
        w = feats_w.shape[0]
        params = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (w, *a.shape)), prior)
    else:
        keys = jax.vmap(jax.random.PRNGKey)(seeds)
        params = jax.vmap(lambda f, l, k: init_params(f, l, cfg, k))(
            feats_w, lengths_w, keys)

    def one_word(f, l, p):
        if cfg.train_mode == "baum_welch":
            stats = em_suff_stats_soft(f, l, p, cfg)
        else:
            stats = em_suff_stats(f, l, p, cfg)
        return _params_from_stats(stats, p, cfg, prior)

    def body(_, p):
        return jax.vmap(one_word)(feats_w, lengths_w, p)

    return jax.lax.fori_loop(0, cfg.n_iter, body, params)


# --------------------------------------------------------------- recognizer
class GmmHmmRecognizer:
    """Word-per-HMM recognizer mirroring the KnnDtwRecognizer surface."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 hmm: HmmConfig = HmmConfig(), mesh=None,
                 noise_adapt: bool = False):
        self.cfg = cfg
        self.hmm = hmm
        self.mesh = mesh                       # data-parallel decode mesh
        self.mats = fe.make_matrices(cfg.frontend)
        self.labels: list[str] = []
        self.params: HmmParams | None = None   # stacked [W, ...]
        self.ubm = None   # (means [M,F], log_var, log_mix) — universal
        #   background GMM over all training frames; the MAP prior when
        #   train_mode uses one, and the FILLER model for HMM keyword
        #   spotting (models/spotter.py:HmmSpotter)
        # automatic noise-mismatch compensation (ops/noise_adapt.py):
        # estimate the test batch's noise floor from VAD-rejected frames
        # and log-add-PMC the Gaussian means before scoring — the
        # automatic form of the manual --train-noise refit remedy
        # (docs/RESULTS.md connected-WER matrix; VERDICT r3 #5)
        self.noise_adapt = noise_adapt
        self.reject_threshold: float | None = None  # calibrated OOV
        #   verification threshold on the per-frame (best word − UBM)
        #   LLR (calibrate_rejection); persisted in the checkpoint

    def _pad_signals(self, signals):
        return pl.pad_signals(signals, self.cfg.max_samples)

    def extract(self, signals) -> pl.Features:
        return pl.extract_signals(signals, self.mats, self.cfg)

    def fit(self, corpus: dict, mesh=None, batched: bool = True) -> None:
        """corpus: {label: [signals]} -> per-word EM training.

        ``batched`` (default) trains ALL word models in one jitted
        program (fit_words_batched: one compile, one dispatch); the
        legacy per-word host loop remains for debugging.
        ``mesh``: optional ('data','bank') mesh — batched mode shards
        words on 'bank' and utterances on 'data'; loop mode shards
        utterances only, with psum-reduced statistics per iteration."""
        self.labels = sorted(corpus.keys())
        if not batched:
            trained = []
            for w, lab in enumerate(self.labels):
                feats = self.extract(corpus[lab])
                trained.append(fit_word(feats.feats, feats.length, self.hmm,
                                        seed=self.hmm.seed + w, mesh=mesh))
            self.params = stack_params(trained)
            return

        per_word = [self.extract(corpus[lab]) for lab in self.labels]
        n_max = max(f.feats.shape[0] for f in per_word)
        w = len(per_word)
        t, f_dim = per_word[0].feats.shape[1:]
        feats_w = np.zeros((w, n_max, t, f_dim), np.float32)
        lens_w = np.zeros((w, n_max), np.int32)     # zero-length = no weight
        for i, fw in enumerate(per_word):
            n = fw.feats.shape[0]
            feats_w[i, :n] = np.asarray(fw.feats)
            lens_w[i, :n] = np.asarray(fw.length)
        seeds = np.asarray([self.hmm.seed + i for i in range(w)], np.int32)
        fj, lj, sj = jnp.asarray(feats_w), jnp.asarray(lens_w), jnp.asarray(seeds)
        # universal background GMM over every word's frames: the MAP
        # prior (when map_tau > 0) and the spotting filler model either
        # way — one extra jitted EM, always stored
        self.ubm = fit_ubm(fj.reshape(w * n_max, t, f_dim),
                           lj.reshape(w * n_max), self.hmm,
                           jax.random.PRNGKey(self.hmm.seed))
        prior = ubm_prior(self.ubm, self.hmm) if self.hmm.map_tau > 0 \
            else None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from dsp_asr.parallel.mesh import BANK_AXIS, DATA_AXIS

            nb = mesh.shape[BANK_AXIS]
            nd = mesh.shape[DATA_AXIS]
            if w % nb == 0 and n_max % nd == 0:
                fj = jax.device_put(
                    fj, NamedSharding(mesh, P(BANK_AXIS, DATA_AXIS, None, None)))
                lj = jax.device_put(lj, NamedSharding(mesh, P(BANK_AXIS, DATA_AXIS)))
                sj = jax.device_put(sj, NamedSharding(mesh, P(BANK_AXIS)))
        self.params = fit_words_batched(fj, lj, sj, self.hmm, prior)

    def _params_for(self, signals) -> HmmParams:
        """The scoring params: stored, or PMC-adapted to ``signals``'s
        estimated noise floor when ``noise_adapt`` is on."""
        return self._scoring_models(signals)[0]

    def _scoring_models(self, signals):
        """(word params, ubm) for scoring ``signals`` — PMC-adapted
        TOGETHER when ``noise_adapt`` is on: the rejection LLR compares
        word scores against the UBM, so both sides must see the same
        compensated feature space."""
        if not self.noise_adapt:
            return self.params, self.ubm
        from dsp_asr.ops.noise_adapt import (estimate_noise_cepstrum,
                                             pmc_adapt_means, pmc_supported)

        reason = pmc_supported(self.cfg.frontend)
        if reason:
            raise ValueError(f"noise_adapt unavailable: {reason}")
        if self.mesh is not None:
            raise ValueError("noise_adapt with a mesh is not supported "
                             "yet — clear the mesh or adapt offline")
        quantum = self.cfg.max_samples
        n_len = max(1, max(len(np.asarray(s)) for s in signals))
        x, n = pl.pad_signals(signals, quantum * -(-n_len // quantum))
        noise_c, _ = estimate_noise_cepstrum(
            x, n, self.mats, self.cfg.frontend, self.cfg.vad)
        means = pmc_adapt_means(self.params.means, noise_c, self.mats,
                                self.cfg.frontend)
        ubm = self.ubm
        if ubm is not None:
            ubm = (pmc_adapt_means(ubm[0], noise_c, self.mats,
                                   self.cfg.frontend), ubm[1], ubm[2])
        return self.params._replace(means=means), ubm

    def classify_batch(self, signals, return_scores: bool = False,
                       reject=None):
        """``reject``: utterance verification on the per-frame
        (best-word Viterbi − UBM) log-likelihood ratio — the
        keyword/filler LLR (ops/spot_hmm.py) applied to whole
        utterances.  ``True`` = the calibrated stored threshold
        (:meth:`calibrate_rejection`), a number = explicit; failing
        utterances return ``REJECT``.  Composes with ``noise_adapt``
        (the UBM is PMC-adapted alongside the word models)."""
        if self.params is None:
            raise ValueError("model not fitted")
        thr = self._resolve_reject(reject)
        feats = None
        if self.mesh is not None:
            scores = self._score_sharded(signals)              # [B, W] np
        else:
            params, ubm = self._scoring_models(signals)
            feats = self.extract(signals)
            scores = np.asarray(
                score_words(feats.feats, feats.length, params))
        ids = scores.argmax(axis=-1)
        labels = [self.labels[int(i)] for i in ids]
        if thr is not None:
            if feats is None:                  # mesh path: extract here
                ubm = self.ubm
                feats = self.extract(signals)
            llr = self._utterance_llr(feats, scores, ubm)
            from dsp_asr.models.knn_dtw import REJECT
            labels = [REJECT if not (s >= thr) else lab
                      for lab, s in zip(labels, llr)]
        if return_scores:
            return labels, scores
        return labels

    def _utterance_llr(self, feats: pl.Features, scores: np.ndarray,
                       ubm) -> np.ndarray:
        """[B] per-frame LLR: (max-word loglik − UBM loglik) / frames."""
        if ubm is None:
            raise ValueError(
                "rejection needs the UBM this model's fit() stores — "
                "older checkpoint? refit (train-hmm) to enable --reject")
        ubm_s = np.asarray(score_ubm(feats.feats, feats.length, ubm))
        nfr = np.maximum(np.asarray(feats.length), 1)
        return (scores.max(axis=-1) - ubm_s) / nfr

    def _resolve_reject(self, reject) -> float | None:
        """None/False = off; True = the calibrated stored threshold;
        a number = explicit LLR threshold (accept iff llr >= thr)."""
        if reject is None or reject is False:
            return None
        if reject is True:
            if self.reject_threshold is None:
                raise ValueError(
                    "reject=True but no rejection threshold is stored — "
                    "calibrate_rejection(corpus) first (train-hmm does "
                    "this by default) or pass an explicit number")
            return float(self.reject_threshold)
        return float(reject)

    def calibrate_rejection(self, corpus: dict, genuine_q: float = 0.1,
                            impostor_q: float = 0.98) -> float:
        """OOV-rejection LLR threshold from a labeled corpus (typically
        the training corpus, which train-hmm already holds).

        Mirrors KnnDtwRecognizer.calibrate_rejection with the sign
        flipped (higher LLR = better): GENUINE = each utterance's
        test-time statistic, (best-word score − UBM)/frames; IMPOSTOR =
        the same with the utterance's OWN word masked out — what it
        would score if its word were missing from the vocabulary (the
        OOV mechanism).  Threshold = midpoint(genuine q0.1, impostor
        q0.98); accept iff llr >= threshold.  Stored on
        ``self.reject_threshold`` (persisted by save/load)."""
        if self.params is None:
            raise ValueError("model not fitted")
        if len(self.labels) < 2:
            raise ValueError("calibrate_rejection needs >= 2 words "
                             "(no impostor scores with one word)")
        sigs, want = [], []
        for lab, xs in corpus.items():
            if lab not in self.labels:
                raise ValueError(f"corpus label {lab!r} is not in the "
                                 "model vocabulary")
            sigs.extend(xs)
            want.extend([self.labels.index(lab)] * len(xs))
        params, ubm = self._scoring_models(sigs)
        feats = self.extract(sigs)
        scores = np.asarray(score_words(feats.feats, feats.length, params))
        llr_all = self._utterance_llr(feats, scores, ubm)
        masked = scores.copy()
        masked[np.arange(len(want)), np.asarray(want)] = -np.inf
        llr_imp = self._utterance_llr(feats, masked, ubm)
        self.reject_threshold = float(
            (np.quantile(llr_all, genuine_q)
             + np.quantile(llr_imp, impostor_q)) / 2.0)
        return self.reject_threshold

    def classify_nbest(self, signals, n: int = 3):
        """Top-n label hypotheses per utterance: ``[[(label, log_lik,
        weight)]]`` sorted best-first (pipeline.nbest_from_scores over
        the per-word Viterbi log-liks; composes with ``noise_adapt``
        and the mesh like ``classify_batch``)."""
        if not len(signals):
            return []
        _, scores = self.classify_batch(signals, return_scores=True)
        return pl.nbest_from_scores(scores, self.labels, n,
                                    higher_better=True)

    def resolve_grammar(self, grammar):
        """Normalise a grammar argument -> word-level masks.

        Same contract as KnnDtwRecognizer.resolve_grammar, but the HMM
        family has exactly one model per label, so unit = word and the
        label-level masks apply directly (reordered to ``self.labels``).
        """
        from dsp_asr.ops.grammar import Grammar

        if isinstance(grammar, str):
            grammar = Grammar.load(grammar, self.labels)
        elif isinstance(grammar, dict):
            grammar = Grammar.from_spec(grammar, self.labels)
        gidx = {w: i for i, w in enumerate(grammar.labels)}
        missing = [w for w in self.labels if w not in gidx]
        if missing:
            raise ValueError("grammar does not cover trained labels: "
                             + ", ".join(missing))
        ids = np.asarray([gidx[w] for w in self.labels])
        return grammar.unit_masks(ids)

    def classify_connected(self, signals, max_segments: int = 8,
                           method: str = "vad",
                           word_penalty: float = 0.0,
                           grammar=None):
        """Recordings of SEVERAL words -> one label list per recording.

        ``method="vad"`` (default): the shared multi-segment VAD split
        (pipeline.decode_connected) feeds every segment through the same
        batched Viterbi scorer as ``classify_batch`` — needs silence
        gaps between words.

        ``method="level"``: level-synchronous connected Viterbi
        (ops/connected_viterbi.py) — word boundaries come out of the
        joint DP through the word-HMM network, so GAPLESS recordings
        decode correctly; ``max_segments`` caps the word count and
        ``word_penalty`` (>= 0, subtracted per word) biases it.

        ``grammar`` (method="level" only): a finite-state word syntax
        (ops/grammar.py: Grammar | spec dict | JSON path) constraining
        start/adjacent/end words inside the joint DP
        (connected_viterbi_grammar); returns ``[]`` for a recording the
        grammar cannot explain.

        All compose with ``noise_adapt`` (PMC-adapted params estimated
        from the recordings themselves).
        """
        if self.params is None:
            raise ValueError("model not fitted")
        if grammar is not None and method != "level":
            raise ValueError(
                "grammar constraints require method='level' (the VAD "
                "splitter classifies segments independently — there is "
                "no joint sequence to constrain)")
        params = self._params_for(signals) if len(signals) else self.params
        if method == "level":
            from dsp_asr.ops.connected_viterbi import (
                connected_viterbi, connected_viterbi_grammar)
            from dsp_asr.ops.level_building import backtrack_grammar

            if grammar is not None:
                start_m, pair_m, end_m = self.resolve_grammar(grammar)

                def dp_fn(feats):
                    scores, starts = connected_viterbi_grammar(
                        feats.feats, feats.length, params,
                        jnp.asarray(start_m), jnp.asarray(pair_m),
                        max_levels=max_segments,
                        word_penalty=word_penalty)
                    # MIN-convention bridge: NEG_INF -> BIG (docstring)
                    return -scores, starts

                def backtrack_fn(costs, starts, t_valid):
                    return backtrack_grammar(costs, starts, pair_m,
                                             end_m, t_valid)
            else:
                backtrack_fn = None

                def dp_fn(feats):
                    scores, words, starts = connected_viterbi(
                        feats.feats, feats.length, params,
                        max_levels=max_segments, word_penalty=word_penalty)
                    return -scores, words, starts

            id_lists, _ = pl.decode_level_generic(
                signals, self.mats, self.cfg, dp_fn,
                np.arange(len(self.labels), dtype=np.int32),
                backtrack_fn=backtrack_fn)
            return [[self.labels[int(i)] for i in ids] for ids in id_lists]
        if method != "vad":
            raise ValueError(f"unknown connected method {method!r} "
                             "(vad | level)")
        score = lambda flat: np.asarray(
            score_words(flat.feats, flat.length, params)).argmax(-1)
        return pl.decode_connected(
            signals, self.mats, self.cfg, max_segments, score,
            lambda ids: [self.labels[int(i)] for i in ids])[0]

    def _score_sharded(self, signals) -> np.ndarray:
        """Data-parallel Viterbi decode: the utterance batch shards over
        the mesh data axis, word params replicate; XLA propagates the
        shardings through the jitted extract+score program (the decode
        is embarrassingly parallel — zero collectives)."""
        from dsp_asr import parallel as par

        x, n = self._pad_signals(signals)
        nd = self.mesh.shape[par.DATA_AXIS] * self.mesh.shape[par.BANK_AXIS]
        x, b_orig = par.pad_axis_to_multiple(np.asarray(x), nd)
        n, _ = par.pad_axis_to_multiple(np.asarray(n), nd)
        n = np.maximum(n, 1)          # clamp AFTER padding: pad rows get n=1
        flat = self.mesh.devices.reshape(-1)
        import jax.sharding as shd
        mesh1 = shd.Mesh(flat, ("decode",))
        xs = jax.device_put(x, shd.NamedSharding(mesh1, shd.PartitionSpec("decode")))
        ns = jax.device_put(n, shd.NamedSharding(mesh1, shd.PartitionSpec("decode")))
        params = jax.tree.map(
            lambda a: jax.device_put(a, shd.NamedSharding(mesh1, shd.PartitionSpec())),
            self.params)
        return np.asarray(
            _extract_and_score(xs, ns, params, self.mats, self.cfg))[:b_orig]

    def recognize(self, signal, reject=None) -> str:
        return self.classify_batch([signal], reject=reject)[0]

    def evaluate(self, corpus: dict, reject=None) -> dict:
        """With ``reject``: same OOV protocol as KnnDtwRecognizer —
        corpus labels not in the vocabulary count correct iff
        rejected."""
        thr = self._resolve_reject(reject)
        if thr is None:
            return pl.evaluate_corpus(self.classify_batch, corpus)
        from dsp_asr.models.knn_dtw import REJECT
        mapped: dict = {}
        for lab, xs in corpus.items():
            key = lab if lab in self.labels else REJECT
            mapped.setdefault(key, []).extend(xs)
        return pl.evaluate_corpus(
            lambda s: self.classify_batch(s, reject=thr), mapped)

    def save(self, path: str) -> None:
        if self.params is None:
            raise ValueError("model not fitted")
        from dsp_asr.models.knn_dtw import frontend_signature
        extra = {}
        if self.ubm is not None:
            extra = {f"ubm_{n}": np.asarray(a) for n, a in
                     zip(("means", "log_var", "log_mix"), self.ubm)}
        np.savez(path, labels=json.dumps(self.labels),
                 frontend=json.dumps(frontend_signature(self.cfg)),
                 reject_threshold=(np.nan if self.reject_threshold is None
                                   else float(self.reject_threshold)),
                 **{f: np.asarray(getattr(self.params, f))
                    for f in HmmParams._fields}, **extra)

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig = PipelineConfig(),
             hmm: HmmConfig = HmmConfig()):
        from dsp_asr.models.knn_dtw import check_frontend_signature
        data = np.load(path, allow_pickle=False)
        check_frontend_signature(data, cfg, path)
        rec = cls(cfg, hmm)
        rec.labels = json.loads(str(data["labels"]))
        rec.params = HmmParams(*(jnp.asarray(data[f]) for f in HmmParams._fields))
        if "ubm_means" in data:
            rec.ubm = tuple(jnp.asarray(data[f"ubm_{n}"])
                            for n in ("means", "log_var", "log_mix"))
        if "reject_threshold" in data.files:
            rt = float(data["reject_threshold"])
            rec.reject_threshold = rt if np.isfinite(rt) else None
        return rec
