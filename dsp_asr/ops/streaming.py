"""Streaming chunked front-end (BASELINE.json config 2).

The reference's live demo records from a mic and endpoint-detects online
(SURVEY.md §3.3).  Here the streaming unit is one jitted ``process_chunk``
per fixed-size audio chunk:

* **Chunked MFCC with exact offline parity.**  The carry holds the raw
  sample residual (the tail that hasn't filled a frame yet) plus the one
  sample before it (pre-emphasis continuity), so concatenating the valid
  frames of every chunk reproduces the offline framing grid bit-for-bit
  (tested in tests/test_streaming.py).  Chunk length must be a multiple
  of the hop.

* **Causal streaming VAD.**  A 3-state (silence / candidate / speech)
  double-threshold machine runs as a `lax.scan` over the chunk's frames,
  its scalar state carried across chunks.  It is causal, so it cannot
  bit-match the offline two-sided detector (which extends boundaries
  backwards); the backward extension is approximated by the running
  count of consecutive "audible" frames at trigger time.

Static shapes: every chunk yields exactly chunk_len/hop frame slots with
validity flags; utterance-end events are per-frame flags + start/end
indices, so the host never sees a dynamic shape.

**Denoise operating envelope (non-stationary noise — VERDICT r3 #9).**
The causal noise-PSD carry freezes after the first ``n_init`` frames;
the offline estimator picks the k lowest-energy frames anywhere.  Under
NON-stationary noise both therefore under-subtract late/loud noise —
they fail together, not apart.  Measured (48k samples, 16 kHz sine
"speech" in frames 100-200; mean |MFCC - clean-signal MFCC| over
interior speech frames; tests/test_streaming.py::
test_streaming_denoise_envelope_nonstationary):

    noise profile               undenoised   offline   streaming
    stationary  (amp 0.02)           12.30     11.90       11.34
    ramp        (0.02 -> 0.08)       17.91     16.05       16.38
    burst       (10x for 0.5 s)      19.86     19.36       19.11

Streaming stays within ~3% of the offline estimator's distance-to-clean
on every profile (sometimes closer — the causal first-n_init average is
unbiased while the low-energy pick is selection-biased low), so there is
no streaming-SPECIFIC regression to guard against; the envelope limit is
the spectral-subtraction model itself (stationary-noise assumption, both
estimators).  For genuinely non-stationary noise, re-trigger a fresh
stream (resetting the carry re-estimates the floor).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsp_asr.config import FrontendConfig, VadConfig
from dsp_asr.golden.vad import ZCR_ABS_FLOOR
from dsp_asr.ops import frontend as fe
from dsp_asr.ops import vad as jvad

# The causal detector is a TWO-state machine (SIL / SPEECH); the classic
# "candidate" middle state is subsumed by the run counters (run_high
# must reach min_speech_frames before SIL -> SPEECH triggers), so no
# third state value exists.
SIL, SPEECH = 0, 2


class StreamState(NamedTuple):
    """Carry between chunks (all statically shaped)."""

    prev_sample: jax.Array     # [] sample before the residual (pre-emphasis)
    residual: jax.Array        # [R] raw samples not yet framed
    n_samples: jax.Array       # [] total raw samples consumed so far
    frame_idx: jax.Array       # [] global index of the next emitted frame
    # --- VAD state ---
    vad_state: jax.Array       # [] {0 silence, 1 candidate, 2 speech}
    noise_e: jax.Array         # [] running noise energy sum
    noise_z: jax.Array         # [] running noise ZCR sum
    n_noise: jax.Array         # [] frames accumulated into noise stats
    run_high: jax.Array        # [] consecutive high-energy frames
    run_low: jax.Array         # [] consecutive low-energy frames
    run_audible: jax.Array     # [] consecutive audible frames
    utt_start: jax.Array       # [] start frame of current utterance
    # --- denoise state (all-zero when FrontendConfig.denoise is None) ---
    noise_psd: jax.Array       # [K] running noise power-spectrum sum over
    #                               the same first-n_init valid frames the
    #                               VAD noise stats use (count = n_noise)


class ChunkOutput(NamedTuple):
    mfcc: jax.Array            # [Tc, n_mfcc]
    energy: jax.Array          # [Tc]
    zcr: jax.Array             # [Tc]
    frame_valid: jax.Array     # [Tc] bool — frame exists on the offline grid
    in_speech: jax.Array       # [Tc] bool
    utt_end: jax.Array         # [Tc] bool — an utterance ended at this frame
    utt_start_idx: jax.Array   # [Tc] global start frame of the ended utterance
    utt_end_idx: jax.Array     # [Tc] global end frame (exclusive)


def residual_len(cfg: FrontendConfig, chunk_len: int) -> int:
    """Static residual size so chunk framing lands on the offline grid."""
    if chunk_len % cfg.hop_len != 0:
        raise ValueError("chunk_len must be a multiple of hop_len")
    if chunk_len < cfg.frame_len:
        raise ValueError("chunk_len must be >= frame_len")
    return ((chunk_len - cfg.frame_len) % cfg.hop_len
            + cfg.frame_len - cfg.hop_len)


def init_state(cfg: FrontendConfig, chunk_len: int) -> StreamState:
    r = residual_len(cfg, chunk_len)
    z = jnp.zeros((), jnp.float32)
    zi = jnp.zeros((), jnp.int32)
    return StreamState(
        prev_sample=z, residual=jnp.zeros((r,), jnp.float32),
        n_samples=zi, frame_idx=zi,
        vad_state=zi, noise_e=z, noise_z=z, n_noise=z,
        run_high=zi, run_low=zi, run_audible=zi, utt_start=zi,
        noise_psd=jnp.zeros((cfg.n_fft // 2 + 1,), jnp.float32),
    )


def _vad_step(vcfg: VadConfig, n_init: int):
    """Per-frame VAD transition for lax.scan; state is the tail of StreamState.

    Always the causal noise_mult rule: ``two_pass`` thresholds need the
    WHOLE utterance's energy distribution (config.py:VadConfig), which a
    causal detector cannot see — warned once, then ignored here."""
    if vcfg.threshold_mode == "two_pass":
        from dsp_asr.utils.logging import warn_once
        warn_once("stream-two-pass",
                  "two_pass VAD thresholds are offline-only; the "
                  "streaming detector keeps the causal noise_mult rule")

    def step(carry, inp):
        (state, ne, nz, nn, rh, rl, ra, us) = carry
        e, z, fidx, valid = inp

        collect = (nn < n_init) & valid
        ne = ne + jnp.where(collect, e, 0.0)
        nz = nz + jnp.where(collect, z, 0.0)
        nn = nn + jnp.where(collect, 1.0, 0.0)

        e_noise = ne / jnp.maximum(nn, 1.0) + vcfg.e_abs_floor
        th = e_noise * vcfg.e_high_mult
        tl = e_noise * vcfg.e_low_mult
        zt = (nz / jnp.maximum(nn, 1.0)) * vcfg.zcr_mult + ZCR_ABS_FLOOR

        high = (e > th) & valid
        audible = ((e > tl) | (z > zt)) & valid

        rh = jnp.where(high, rh + 1, 0)
        ra = jnp.where(audible, ra + 1, 0)
        rl = jnp.where(audible, 0, rl + 1)

        trigger = (state != SPEECH) & (rh >= vcfg.min_speech_frames)
        # backward extension approximation: audible run ending here
        new_start = fidx - jnp.maximum(ra, vcfg.min_speech_frames) + 1
        us = jnp.where(trigger, jnp.maximum(new_start, 0), us)

        ending = (state == SPEECH) & (rl >= vcfg.max_silence_frames)
        end_idx = fidx - vcfg.max_silence_frames + 1 + vcfg.hangover_frames
        end_idx = jnp.maximum(end_idx, us + 1)

        state = jnp.where(trigger, SPEECH,
                          jnp.where(ending, SIL, state))
        in_speech = state == SPEECH

        out = (in_speech, ending, us, end_idx)
        return (state, ne, nz, nn, rh, rl, ra, us), out

    return step


@functools.partial(jax.jit, static_argnames=("fcfg", "vcfg", "chunk_len"))
def process_chunk(state: StreamState, chunk: jax.Array,
                  mats: fe.FrontendMatrices,
                  fcfg: FrontendConfig = FrontendConfig(),
                  vcfg: VadConfig = VadConfig(),
                  chunk_len: int = 1600):
    """One audio chunk [chunk_len] -> (new_state, ChunkOutput)."""
    r = residual_len(fcfg, chunk_len)
    tc = chunk_len // fcfg.hop_len

    buf = jnp.concatenate([state.residual, chunk.astype(jnp.float32)])
    frames_raw = fe.frame(buf, fcfg.frame_len, fcfg.hop_len)[:tc]

    # pre-emphasis with cross-chunk continuity
    prev = jnp.concatenate([state.prev_sample[None], buf[:-1]])
    y = buf - fcfg.preemphasis * prev
    frames_y = fe.frame(y, fcfg.frame_len, fcfg.hop_len)[:tc]

    # frame f in this chunk starts at global sample (n_samples - R) + f*hop
    starts = state.n_samples - r + jnp.arange(tc) * fcfg.hop_len
    frame_valid = starts >= 0
    fidx = state.frame_idx + jnp.cumsum(frame_valid.astype(jnp.int32)) - 1

    noise_psd = state.noise_psd
    if fcfg.denoise == "spectral_subtraction":
        # Causal cross-chunk spectral subtraction.  The offline front-end
        # (ops/frontend.py:spectral_subtract) estimates the noise PSD as
        # the mean over the k lowest-energy frames of the WHOLE recording
        # — non-causal, so a per-chunk mirror would estimate from ~tc
        # frames and silently shift the feature space vs the offline-
        # denoised bank.  Instead the carry accumulates the PSD of the
        # same first ``vcfg.n_init`` valid frames the VAD noise stats use
        # (count shared via state.n_noise); for stationary noise leading
        # the speech both estimators converge on the true noise PSD
        # (tested: tests/test_streaming.py::test_streaming_denoise*).
        pspec = fe.power_spectrum_dft(frames_y * mats.window, mats, fcfg.n_fft)
        vf = frame_valid.astype(jnp.float32)
        n_before = state.n_noise + jnp.cumsum(vf) - vf        # exclusive
        collect = vf * (n_before < vcfg.n_init).astype(jnp.float32)
        noise_psd = state.noise_psd + jnp.sum(pspec * collect[:, None], 0)
        cnt = jnp.maximum(state.n_noise + jnp.sum(collect), 1.0)
        sub = pspec - fcfg.ss_alpha * (noise_psd / cnt)[None, :]
        pspec = jnp.maximum(sub, fcfg.ss_beta * pspec)
        mfcc = fe.mfcc_from_pspec(pspec, frames_y, mats, fcfg)
    elif fcfg.denoise is not None:
        raise ValueError(f"unknown FrontendConfig.denoise {fcfg.denoise!r}")
    else:
        mfcc = fe.mfcc_from_frames(frames_y, mats, fcfg)
    e = jvad.short_time_energy(frames_raw)
    z = jvad.zero_crossing_rate(frames_raw)

    vad_carry = (state.vad_state, state.noise_e, state.noise_z, state.n_noise,
                 state.run_high, state.run_low, state.run_audible,
                 state.utt_start)
    vad_carry, (in_speech, utt_end, utt_start_idx, utt_end_idx) = jax.lax.scan(
        _vad_step(vcfg, vcfg.n_init), vad_carry, (e, z, fidx, frame_valid))

    new_state = StreamState(
        prev_sample=buf[-r - 1],
        # NOT buf[-r:]: when r == 0 (frame_len == hop_len) that slice is
        # the WHOLE buffer, so the carried residual would grow by
        # chunk_len every chunk and re-emit stale frames forever
        residual=buf[buf.shape[0] - r:],
        n_samples=state.n_samples + chunk_len,
        frame_idx=state.frame_idx + jnp.sum(frame_valid.astype(jnp.int32)),
        vad_state=vad_carry[0], noise_e=vad_carry[1], noise_z=vad_carry[2],
        n_noise=vad_carry[3], run_high=vad_carry[4], run_low=vad_carry[5],
        run_audible=vad_carry[6], utt_start=vad_carry[7],
        noise_psd=noise_psd,
    )
    out = ChunkOutput(mfcc, e, z, frame_valid, in_speech,
                      utt_end, utt_start_idx, utt_end_idx)
    return new_state, out


def init_state_batch(n_streams: int, cfg: FrontendConfig,
                     chunk_len: int) -> StreamState:
    """Stacked carry for ``n_streams`` concurrent streams."""
    one = init_state(cfg, chunk_len)
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a, (n_streams, *a.shape)).copy(), one)


@functools.partial(jax.jit, static_argnames=("fcfg", "vcfg", "chunk_len"))
def process_chunk_batch(state: StreamState, chunks: jax.Array,
                        mats: fe.FrontendMatrices,
                        fcfg: FrontendConfig = FrontendConfig(),
                        vcfg: VadConfig = VadConfig(),
                        chunk_len: int = 1600):
    """Serving-density variant: S concurrent streams in ONE device program.

    ``state`` is a stacked StreamState (init_state_batch) and ``chunks``
    is [S, chunk_len]; every stream advances one chunk per call (vmapped
    front-end + VAD state machines).  Streams are independent — a server
    multiplexes many live sessions through one jit dispatch instead of S.
    """
    def one(st, ck):
        return process_chunk(st, ck, mats, fcfg, vcfg, chunk_len)

    return jax.vmap(one)(state, chunks)


def shard_streams(mesh, state: StreamState, chunks):
    """Place S concurrent streams on the mesh data axis (S % data == 0).

    Streams are embarrassingly data-parallel: after placement the same
    ``process_chunk_batch`` program runs with every per-stream state leaf
    sharded on its leading axis — XLA partitions the vmapped front-end +
    VAD with zero collectives.
    """
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dsp_asr.parallel.mesh import DATA_AXIS

    def put(a):
        a = np.asarray(a)
        spec = P(DATA_AXIS, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return jax.tree.map(put, state), put(chunks)
