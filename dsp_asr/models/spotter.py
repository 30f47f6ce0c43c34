"""Keyword spotting over the enrolled template bank.

The reference framework (SURVEY.md §2a, §3.3) recognises words only
after its endpoint detector has cut them out of silence-delimited
audio.  The spotter removes that requirement: it matches every
enrolled template against ANY contiguous span of a long, unsegmented
recording via subsequence DTW (ops/spot.py) and reports
``(label, start_frame, end_frame, score)`` events — keyword search in
continuous audio, the natural extension of the reference's live-demo
stack (SURVEY §3.3: continuous mic capture).

Two surfaces:

* :class:`KeywordSpotter` — offline batch: whole recordings in, event
  lists out.  The per-(recording x template) cost GEMMs batch on the
  matmul; recordings are grouped by quantised padded length (compile-shape
  discipline shared with pipeline.decode_level_generic via
  pipeline.group_by_padded_len) and sub-batched
  so the [B, K, T, U] cost intermediate stays bounded.

* :class:`StreamingSpotter` — online: raw audio chunks in, events out
  as they are confirmed.  Couples the causal streaming front-end
  (ops/streaming.py — bit-exact offline framing grid) to the SPRING
  column update (ops/spot.py:spot_chunk).  A frame's [c, Δ, ΔΔ] row is
  final once ``2*delta_width`` more frames exist, so the DP runs that
  many frames (~40 ms) behind the microphone, exactly like
  StreamingConnectedRecognizer.  Events are emitted once no
  still-improvable match can overlap them (best-match hangover), which
  reproduces the offline extractor's output whenever keyword hits are
  separated by at least ``hangover`` frames.

Score envelope: scores are span-normalised DTW distances (same units
as the classifier's normalised distances), so ``threshold`` transfers
across template lengths.  VAD is bypassed entirely — spotting IS the
segmentation.  With ``cfg.frontend.cmn`` the offline stream is
normalised over the whole recording (an utterance-global statistic
does not exist here) while bank templates were normalised per
utterance; enroll a ``cmn=False`` bank for spotting (the default).
Streaming requires ``cmn=False`` and ``feature_type='mfcc'``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops import spot as sp
from dsp_asr.ops import streaming as st

# cap on the [B, K, T, U] f32 cost intermediate the XLA scan
# materialises per device program
_COST_BUDGET_ELEMS = 64 * 1024 * 1024


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p

# the 5-keyword-matrix threshold; decays at vocabulary scale
# (docs/RESULTS.md: 35 keywords F1 0.80 fixed vs 0.91 calibrated)
DEFAULT_SPOT_THRESHOLD = 40.0


def resolve_spot_threshold(recognizer, threshold: float | None):
    """(threshold, source) — explicit value > bank-stored calibration >
    fixed default.  Shared by the offline and streaming DTW spotters so
    an enrolled-with-calibration bank is vocabulary-robust by DEFAULT,
    with ``threshold=...`` as the escape hatch."""
    if threshold is not None:
        return float(threshold), "explicit"
    stored = getattr(recognizer, "spot_threshold", None)
    if stored is not None:
        return float(stored), "bank-calibrated"
    return DEFAULT_SPOT_THRESHOLD, "default"


class KeywordSpotter:
    """Offline keyword search: recordings in, spotting events out."""

    def __init__(self, recognizer: KnnDtwRecognizer,
                 threshold: float | None = None):
        self.rec = recognizer
        # threshold resolution: explicit flag > per-bank calibrated value
        # stored in the checkpoint (knn_dtw.spot_threshold, written at
        # enroll) > fixed default 40 (the 5-keyword-matrix value; decays
        # at vocabulary scale — docs/RESULTS.md)
        self.threshold, self.threshold_source = resolve_spot_threshold(
            recognizer, threshold)
        # spotting consumes the WHOLE recording: no VAD trim
        self.cfg: PipelineConfig = dataclasses.replace(
            recognizer.cfg, use_vad=False)
        self.mats = recognizer.mats

    # ---------------------------------------------------------------
    def frame_to_seconds(self, frame: int) -> float:
        f = self.cfg.frontend
        return frame * f.hop_len / f.sample_rate

    def calibrate_threshold(self, genuine_q: float = 0.9,
                            impostor_q: float = 0.02) -> float:
        """Per-bank spotting threshold from enrollment data alone.

        The fixed default 40 was calibrated on the 5-keyword matrix and
        DECAYS at vocabulary scale (35 keywords: F1 0.80 — fragments of
        a large confusable vocabulary slip under it).  This computes,
        entirely from the bank, the two score populations the threshold
        must separate: GENUINE = best subsequence match of a template
        inside another template of the SAME label, IMPOSTOR = best
        match of a WRONG-label template (the false-alarm mechanism),
        and returns the midpoint of genuine[q=0.9] and impostor[q=0.02].

        Measured (docs/RESULTS.md): at 5 keywords the midpoint lands on
        ~40 — reproducing the matrix-best default including its noise
        headroom — and at 35 keywords on ~34, lifting dense-corpus F1
        0.80 -> 0.91 (clean-optimal there is ~30 = genuine_q90, but the
        extra margin is what survives noise; the matrix shows the score
        floor rising with SNR).  Requires >= 2 templates for some label
        (else genuine pairs don't exist — raises ValueError).
        """
        bank, ids = self.rec.device_bank()
        ids = np.asarray(ids)
        norm, _ = sp.subseq_dtw_batch(bank.feats, bank.length,
                                      bank.feats, bank.length,
                                      squared=self.cfg.dtw.squared)
        best = np.min(np.asarray(norm), axis=2)       # [K_stream, K_bank]
        same = ids[:, None] == ids[None, :]
        eye = np.eye(len(ids), dtype=bool)
        genuine = best[same & ~eye]
        impostor = best[~same]
        if not len(genuine):
            raise ValueError("calibrate_threshold needs >= 2 templates "
                             "of some label (no genuine pairs in bank)")
        if not len(impostor):
            raise ValueError("calibrate_threshold needs >= 2 labels "
                             "(no impostor pairs in bank)")
        return float((np.quantile(genuine, genuine_q)
                      + np.quantile(impostor, impostor_q)) / 2.0)

    def scores(self, signals):
        """Per-recording score fields: list of (norm [K, T_i], start
        [K, T_i]) numpy arrays (T_i = recording's true frame count)."""
        if not len(signals):
            return []
        bank, _ = self.rec.device_bank()
        k, u_t = bank.feats.shape[0], bank.feats.shape[1]
        f = self.cfg.frontend
        groups = pl.group_by_padded_len(signals, self.cfg.max_samples)
        results: dict = {}
        mesh = self.rec.mesh
        for pad_len, idxs in groups.items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            sub = max(1, _COST_BUDGET_ELEMS // (k * u_t * t_max))
            for lo in range(0, len(idxs), sub):
                part = idxs[lo:lo + sub]
                x, n = pl.pad_signals([signals[i] for i in part], pad_len)
                b_orig = x.shape[0]
                if mesh is not None:
                    from dsp_asr import parallel as par
                    nd = mesh.shape[par.DATA_AXIS]
                    x, b_orig = par.pad_axis_to_multiple(np.asarray(x), nd)
                    n, _ = par.pad_axis_to_multiple(np.asarray(n), nd)
                    # clamp only the rows pad_axis_to_multiple appended
                    # (their zero length would make frame-count 0); real
                    # recordings keep their true lengths so --mesh scores
                    # match the single-device path bit-for-bit
                    n = np.concatenate(
                        [n[:b_orig], np.maximum(n[b_orig:], f.frame_len)])
                feats = pl.extract_recording_features(
                    jnp.asarray(x), jnp.asarray(n), self.mats, self.cfg,
                    t_max)
                if mesh is not None:
                    from dsp_asr import parallel as par
                    bf, bl, _, bv = self.rec.sharded_bank()
                    norm, start = par.spot_sharded(
                        mesh, feats.feats, feats.length, bf, bl, bv,
                        squared=self.cfg.dtw.squared)
                    norm = np.asarray(norm)[:b_orig, :k]
                    start = np.asarray(start)[:b_orig, :k]
                else:
                    norm, start = sp.subseq_dtw_batch(
                        feats.feats, feats.length, bank.feats, bank.length,
                        squared=self.cfg.dtw.squared)
                    norm, start = np.asarray(norm), np.asarray(start)
                lens = np.asarray(feats.length)
                for row, i in enumerate(part):
                    t_i = int(lens[row])
                    results[i] = (norm[row, :, :t_i], start[row, :, :t_i])
        return [results[i] for i in range(len(signals))]

    def spot(self, signals, threshold: float | None = None):
        """Recordings -> per-recording [(label, start_frame, end_frame,
        score)] event lists (label strings, frames on the offline
        grid, span-normalised scores)."""
        thr = self.threshold if threshold is None else threshold
        _, ids = self.rec.device_bank()
        ids = np.asarray(ids)
        out = []
        for norm, start in self.scores(signals):
            evs = sp.extract_events(norm, start, thr, labels=ids)
            out.append([(self.rec.labels[lbl], s, e, sc)
                        for lbl, s, e, sc in evs])
        return out


class _StreamingSpotterBase:
    """Shared online-spotting machinery: causal front-end ingestion,
    delta finalization (~40 ms lag), best-match hangover confirmation.

    ``feed(chunk)`` returns the events CONFIRMED by that chunk; an
    event is confirmed once ``hangover`` stream frames pass without an
    overlapping better match (or a new sub-threshold match begins after
    its end).  ``flush()`` closes the stream and emits any pending
    match.  Frame indices are global stream frames (offline grid).

    Subclasses provide the DP: `_dp_reset()`, `_dp_step(buf, n) ->
    (scores [K, n], starts [K, n])` (scores MINIMISED against
    `self.threshold` — negate a higher-is-better field), `_row_label`,
    and `_emit_score` (presentation transform on the emitted score).
    `min_gap` widens the post-emit re-open suppression, the streaming
    analog of extract_events' landmark margin.
    """

    min_gap = 0

    def __init__(self, recognizer, chunk_len: int, threshold: float,
                 hangover: int):
        self.rec = recognizer
        self.cfg = recognizer.cfg
        f = self.cfg.frontend
        if f.feature_type != "mfcc":
            raise NotImplementedError(
                f"{type(self).__name__} supports feature_type='mfcc' only")
        if f.cmn:
            raise NotImplementedError(
                "cmn is a whole-stream statistic; train/enroll a "
                "cmn=False model for streaming spotting")
        self.chunk_len = chunk_len
        self.threshold = threshold
        self.hangover = hangover
        self.mats = recognizer.mats
        self._w = f.delta_width if f.add_deltas else 0
        self._lag = 2 * self._w
        # fixed DP feed-buffer width: frames a chunk can yield, + slack
        self._buf = max(8, 2 + chunk_len // f.hop_len + self._lag)
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len)
        self._dp_reset()
        self._frames: list[np.ndarray] = []   # raw 13-dim MFCC history
        self._offset = 0                      # global index of _frames[0]
        self._fed = 0                         # global frames fed to DP
        self._pending = None                  # (row, s, e, score)
        self._last_improve = -1
        self._emitted_end = -1                # last confirmed event's end
        self._samples = 0                     # true stream samples fed

    # ------------------------------------------------------------ internals
    def _final_feats(self, upto: int, final: bool) -> np.ndarray:
        """[c, Δ, ΔΔ] rows for global frames [self._fed, upto); each row
        equals offline add_deltas over the whole stream (edge
        replication can only touch rows within 2w of the stream start,
        where the sliding window clamps identically)."""
        f = self.cfg.frontend
        if upto <= self._fed:
            return np.zeros((0, 0), np.float32)
        lo_ctx = max(0, self._fed - 2 * self._w)
        hi_ctx = upto + (0 if final else self._lag)
        ctx = np.stack(self._frames[lo_ctx - self._offset:
                                    hi_ctx - self._offset]).astype(np.float32)
        if not f.add_deltas:
            return ctx[self._fed - lo_ctx: upto - lo_ctx]
        from dsp_asr.models.streaming import _np_deltas
        d1 = _np_deltas(ctx, self._w)
        d2 = _np_deltas(d1, self._w)
        rows = np.concatenate([ctx, d1, d2], axis=1)
        return rows[self._fed - lo_ctx: upto - lo_ctx]

    def _feed_dp(self, rows: np.ndarray):
        """Feed final feature rows to the DP; update the pending match."""
        events = []
        for lo in range(0, len(rows), self._buf):
            part = rows[lo:lo + self._buf]
            buf = np.zeros((self._buf, rows.shape[1]), np.float32)
            buf[:len(part)] = part
            norm, start = self._dp_step(buf, len(part))
            events.extend(self._update_pending(norm[:, :len(part)],
                                               start[:, :len(part)]))
        return events

    def _update_pending(self, norm: np.ndarray, start: np.ndarray):
        """Advance the best-match hangover with a block of per-frame
        score columns beginning at global frame self._fed."""
        events = []
        k, c = norm.shape
        for col in range(c):
            j = self._fed + col
            r = int(np.argmin(norm[:, col]))
            sc = float(norm[r, col])
            if sc < self.threshold:
                s = int(start[r, col])
                if s <= self._emitted_end + self.min_gap:
                    # trailing columns of an ALREADY-emitted occurrence
                    # stay sub-threshold for a while — never re-open it
                    # (mirrors extract_events' overlap suppression,
                    # widened by min_gap for landmark scorers)
                    pass
                elif self._pending is None:
                    self._pending = (r, s, j, sc)
                    self._last_improve = j
                elif s > self._pending[2] + self.min_gap:
                    # new match starts after pending ends: confirm it
                    events.append(self._emit())
                    self._pending = (r, s, j, sc)
                    self._last_improve = j
                elif sc < self._pending[3]:
                    self._pending = (r, s, j, sc)
                    self._last_improve = j
            if (self._pending is not None
                    and j - self._last_improve >= self.hangover):
                events.append(self._emit())
        self._fed += c
        return events

    def _emit(self):
        r, s, e, sc = self._pending
        self._pending = None
        self._emitted_end = e
        return (self._row_label(r), s, e, self._emit_score(sc))

    @staticmethod
    def _emit_score(sc: float) -> float:
        return sc

    def _trim_history(self) -> None:
        # keep the delta context window behind the DP frontier
        keep_from = max(0, self._fed - 2 * self._w - self._offset)
        if keep_from > 2048:
            del self._frames[:keep_from]
            self._offset += keep_from

    def _ingest(self, chunk: np.ndarray):
        """Run the causal front-end on one FULL chunk; append only the
        frames whose analysis window lies entirely inside the true
        sample count (a no-op mid-stream — the front-end only emits
        complete frames — but on the zero-padded flush tail it drops
        exactly the frames the offline spotter never computes)."""
        f = self.cfg.frontend
        self.state, out = st.process_chunk(
            self.state, jnp.asarray(chunk, dtype=jnp.float32), self.mats,
            self.cfg.frontend, self.cfg.vad, self.chunk_len)
        mfcc = np.asarray(out.mfcc)[np.asarray(out.frame_valid)]
        base_k = self._offset + len(self._frames)
        keep = [i for i in range(len(mfcc))
                if (base_k + i) * f.hop_len + f.frame_len <= self._samples]
        self._frames.extend(mfcc[keep])

    # ------------------------------------------------------------ public
    def feed(self, chunk: np.ndarray):
        """One audio chunk -> list of confirmed spotting events."""
        assert len(chunk) == self.chunk_len
        self._samples += self.chunk_len
        self._ingest(chunk)
        n_total = self._offset + len(self._frames)
        rows = self._final_feats(max(self._fed, n_total - self._lag),
                                 final=False)
        events = self._feed_dp(rows) if len(rows) else []
        self._trim_history()
        return events

    def flush(self, tail: np.ndarray | None = None):
        """End of stream: process an optional final SHORT chunk
        (< chunk_len samples — padded internally; frames reaching into
        the padding are dropped, so spans/scores match the offline
        spotter on the unpadded signal), feed the lagged DP tail, emit
        any pending match."""
        if tail is not None and len(tail):
            assert len(tail) < self.chunk_len
            self._samples += len(tail)
            buf = np.zeros(self.chunk_len, np.float32)
            buf[: len(tail)] = tail
            self._ingest(buf)
        n_total = self._offset + len(self._frames)
        rows = self._final_feats(n_total, final=True)
        events = self._feed_dp(rows) if len(rows) else []
        if self._pending is not None:
            events.append(self._emit())
        return events


class StreamingSpotter(_StreamingSpotterBase):
    """Online keyword search over raw audio chunks (SPRING DP) against
    an enrolled template bank — see :class:`_StreamingSpotterBase` for
    the feed/flush/confirmation contract."""

    def __init__(self, recognizer: KnnDtwRecognizer, chunk_len: int = 1600,
                 threshold: float | None = None, hangover: int = 25):
        bank, ids = recognizer.device_bank()
        self._bank = bank
        self._ids = np.asarray(ids)
        # same resolution as the offline spotter: explicit > bank-stored
        # calibration > fixed default (streaming gets calibrated
        # thresholds for free once the bank was enrolled with one)
        thr, self.threshold_source = resolve_spot_threshold(
            recognizer, threshold)
        super().__init__(recognizer, chunk_len, thr, hangover)

    def _dp_reset(self) -> None:
        k, t = self._bank.feats.shape[0], self._bank.feats.shape[1]
        self.dp = sp.spot_init(k, t)

    def _dp_step(self, buf: np.ndarray, n_valid: int):
        self.dp, norm, start = sp.spot_chunk(
            self.dp, jnp.asarray(buf), jnp.asarray(n_valid, jnp.int32),
            self._bank.feats, self._bank.length,
            squared=self.cfg.dtw.squared)
        return np.asarray(norm), np.asarray(start)

    def _row_label(self, r: int) -> str:
        return self.rec.labels[int(self._ids[r])]


class StreamingHmmSpotter(_StreamingSpotterBase):
    """Online HMM keyword/filler spotting (ROADMAP #24 -> closed).

    The frame-synchronous column update of ops/spot_hmm.py streams
    exactly like SPRING: `spot_hmm_chunk` carries the [W, S] Viterbi
    front plus, per path, the UBM prefix AT ITS ENTRY FRAME (the
    streaming replacement for the offline readout's prefix-array
    lookup).  The DP is chunk-boundary-invariant; witnesses are
    integer-exact vs offline and LLRs match to ~4e-4 (emission-GEMM
    shape rounding — ops/spot_hmm.py:spot_hmm_chunk docstring).

    ``threshold`` is the per-frame LLR floor (> 0 beats the filler),
    same units as :class:`HmmSpotter`; internally the confirmation
    logic minimises -LLR.  ``min_gap`` widens post-emit suppression
    exactly like the offline landmark extractor's margin.  Requires a
    fitted recognizer with its UBM (fit always stores one).
    """

    def __init__(self, recognizer, chunk_len: int = 1600,
                 threshold: float = 0.0, hangover: int = 25,
                 min_gap: int = 45):
        if recognizer.params is None:
            raise ValueError("recognizer not fitted")
        if getattr(recognizer, "ubm", None) is None:
            raise ValueError("recognizer has no UBM filler model")
        self._params = recognizer.params
        self._ubm = recognizer.ubm
        self.min_gap = min_gap
        super().__init__(recognizer, chunk_len, -threshold, hangover)

    def _dp_reset(self) -> None:
        from dsp_asr.ops.spot_hmm import spot_hmm_init
        w, s = self._params.log_pi.shape
        self.dp = spot_hmm_init(w, s)

    def _dp_step(self, buf: np.ndarray, n_valid: int):
        from dsp_asr.ops.spot_hmm import spot_hmm_chunk
        self.dp, llr, start = spot_hmm_chunk(
            self.dp, jnp.asarray(buf), jnp.asarray(n_valid, jnp.int32),
            self._params, self._ubm)
        return -np.asarray(llr), np.asarray(start)

    def _row_label(self, r: int) -> str:
        return self.rec.labels[r]

    @staticmethod
    def _emit_score(sc: float) -> float:
        return -sc          # back to LLR units (higher = better)


class CascadeSpotter:
    """Two-stage keyword spotting: HMM landmark scan -> exact DTW rerank.

    Closes the HMM spotter's discrimination gap (clean F1 0.83 vs the
    DTW spotter's 1.00 — docs/RESULTS.md round-4 family matrix, driven
    by cross-keyword confusions at 4 states x 2 mix) without paying the
    DTW spotter's full-stream cost:

    * **Stage 1 — candidate generation** (:class:`HmmSpotter` at a
      permissive LLR floor): per-frame work is O(W·S) elementwise
      max-plus vs the full-bank subsequence DTW's O(K·U) cells —
      22,622 vs 955 audio-s/s/chip measured on-device (docs/PERF.md).
      End-to-end that margin does NOT survive on short streams (host
      orchestration + window reranks dominate; the one-pass DTW scan
      measured 3-5x faster wall clock — docs/RESULTS.md table), so the
      cascade's measured value is ACCURACY at vocabulary scale, not
      speed.  Labels from stage 1 are IGNORED — only the landmark
      spans matter, which is exactly why its cross-keyword confusions
      stop mattering.
    * **Stage 2 — exact rerank**: each candidate span, widened by
      ``margin`` frames, is cut from the stream's features and matched
      against the WHOLE template bank by the offline subsequence DTW
      (ops/spot.py:subseq_dtw_batch) — all windows in ONE batched
      cost GEMM (windows padded to a common 32-frame-quantised width, so
      the program re-compiles only when the bucket grows).  The best
      (template, end-column) relabels the candidate; ``threshold`` is
      the same span-normalised DTW floor :class:`KeywordSpotter` uses,
      so calibrations transfer.

    Duplicate landmarks inside one occurrence rescore to overlapping
    DTW spans and are greedily suppressed best-score-first, which lets
    stage 1 run at a SMALLER ``min_gap`` than the standalone HMM
    spotter's 45 (default 25 here) — recall candidates the standalone
    spotter's wider suppression would have eaten.

    Both recognizers must share a frame grid (sample rate / frame /
    hop); feature types may differ (each stage extracts its own).  A
    bank-recognizer ``mesh`` is ignored: stage 2's windows are few and
    short, one small batched GEMM — dispatch would dominate any bank
    sharding.  Enroll a ``cmn=False`` bank (same envelope as
    :class:`KeywordSpotter`).
    """

    def __init__(self, hmm_recognizer, bank_recognizer,
                 threshold: float | None = None,
                 hmm_threshold: float = -45.0,
                 margin: int = 12, cand_min_gap: int = 25):
        fh, fb = hmm_recognizer.cfg.frontend, bank_recognizer.cfg.frontend
        if (fh.sample_rate, fh.frame_len, fh.hop_len) != \
                (fb.sample_rate, fb.frame_len, fb.hop_len):
            raise ValueError(
                "cascade stages must share a frame grid: hmm "
                f"(sr={fh.sample_rate}, frame={fh.frame_len}, "
                f"hop={fh.hop_len}) vs bank (sr={fb.sample_rate}, "
                f"frame={fb.frame_len}, hop={fb.hop_len})")
        self.stage1 = HmmSpotter(hmm_recognizer, threshold=hmm_threshold,
                                 min_gap=cand_min_gap)
        self.rec = bank_recognizer
        # stage-2 scores are span-normalised DTW distances — the same
        # scale the bank-stored calibration targets
        self.threshold, self.threshold_source = resolve_spot_threshold(
            bank_recognizer, threshold)
        self.hmm_threshold = hmm_threshold
        self.margin = margin
        self.cfg = dataclasses.replace(bank_recognizer.cfg, use_vad=False)
        self.mats = bank_recognizer.mats

    def frame_to_seconds(self, frame: int) -> float:
        f = self.cfg.frontend
        return frame * f.hop_len / f.sample_rate

    def rescored(self, signals):
        """Stage-1 candidates rescored by the bank: per-stream lists of
        ``(label, start_frame, end_frame, dtw_score)`` — UNfiltered and
        UNsuppressed (every candidate window yields its best bank
        match), so an eval harness can sweep ``threshold`` without
        re-running either stage.

        Round-5 orchestration (VERDICT r4 #2 — the round-4 cascade lost
        its 23.7x stage-1 device margin to host round-trips): ONE
        front-end pass feeds BOTH stages when their frontend configs
        match (the default — stage 1 re-extracted identical features in
        round 4); the rerank runs through the fused subsequence kernel
        with the constrained argmin ON DEVICE
        (ops/spot.py:rerank_windows), fetching 4 scalars per window
        instead of the full [N, K, W] score fields; and rerank batches
        are padded to ONE quantised shape so a candidate flood cannot
        trigger per-count recompiles."""
        out = [[] for _ in signals]
        if not len(signals):
            return out
        from dsp_asr.ops.spot_hmm import spot_hmm_batch

        params, ubm = self.stage1._models_for(signals)
        same_fe = self.stage1.cfg.frontend == self.cfg.frontend
        f = self.cfg.frontend
        bank, ids = self.rec.device_bank()
        ids = np.asarray(ids)
        # a landmark is a few frames at a word's high-contrast CORE, so
        # the full occurrence can start up to ~one template length
        # before it and end as far after: extend by the bank's longest
        # template (+ margin slack) on each side
        ext = int(np.max(np.asarray(bank.length))) + self.margin

        wins = []                        # (stream idx, lo, mid, rows)
        groups = pl.group_by_padded_len(signals, self.cfg.max_samples)
        for pad_len, idxs in groups.items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            x, n = pl.pad_signals([signals[i] for i in idxs], pad_len)
            xd, nd = jnp.asarray(x), jnp.asarray(n)
            feats = pl.extract_recording_features(xd, nd, self.mats,
                                                  self.cfg, t_max)
            s1 = feats if same_fe else pl.extract_recording_features(
                xd, nd, self.stage1.mats, self.stage1.cfg, t_max)
            llr, start = spot_hmm_batch(s1.feats, s1.length, params, ubm)
            llr, start = np.asarray(llr), np.asarray(start)
            fh, lens = np.asarray(feats.feats), np.asarray(feats.length)
            for row, i in enumerate(idxs):
                t_i = int(lens[row])
                evs = sp.extract_events(-llr[row, :, :t_i],
                                        start[row, :, :t_i],
                                        -self.hmm_threshold,
                                        min_gap=self.stage1.min_gap)
                for _r, s, e, _neg in evs:
                    lo = max(0, s - ext)
                    hi = min(t_i, e + 1 + ext)
                    if hi - lo >= 2:
                        wins.append((i, lo, (s + e) / 2.0 - lo,
                                     fh[row, lo:hi]))
        if not wins:
            return out
        w_pad = -(-max(len(w) for _, _, _, w in wins) // 32) * 32
        k, u_t = bank.feats.shape[0], bank.feats.shape[1]
        # cap the [n, K, U_t, W] scan cost intermediate (observed: an
        # uncapped 24.9 GB device-memory compile on 35 keywords x 6 long
        # streams); 8x the stream budget — windows are short
        sub = max(1, 8 * _COST_BUDGET_ELEMS // (k * u_t * w_pad))
        # one padded row count per (w_pad, n_rows) — full parts share a
        # shape, the tail pads up, so window count never drives compiles
        n_rows = min(sub, _next_pow2(max(8, len(wins))))
        n_f = wins[0][3].shape[1]
        for base in range(0, len(wins), n_rows):
            part = wins[base:base + n_rows]
            x = np.zeros((n_rows, w_pad, n_f), np.float32)
            lens = np.ones((n_rows,), np.int32)
            mids = np.zeros((n_rows,), np.float32)
            for n, (_, _, mid, w) in enumerate(part):
                x[n, :len(w)] = w
                lens[n] = len(w)
                mids[n] = mid
            # the rescore must CONTAIN the landmark midpoint — the
            # window also covers neighboring words, and an
            # unconstrained argmin would elect a stronger neighbor,
            # collapsing two occurrences into one after suppression
            r, j, s, score = sp.rerank_windows(
                jnp.asarray(x), jnp.asarray(lens), jnp.asarray(mids),
                bank.feats, bank.length, squared=self.cfg.dtw.squared)
            r, j, s, score = (np.asarray(r), np.asarray(j),
                              np.asarray(s), np.asarray(score))
            for n, (i, lo, _mid, _) in enumerate(part):
                if score[n] < 0.5 * sp.BIG:
                    out[i].append((self.rec.labels[int(ids[r[n]])],
                                   lo + int(s[n]), lo + int(j[n]),
                                   float(score[n])))
        return out

    @staticmethod
    def suppress(events):
        """Greedy best-score-first overlap suppression (host-side; the
        rescored spans are full-word DTW spans, so plain overlap is the
        right criterion — no min_gap widening needed here)."""
        kept = []
        for lab, s, e, sc in sorted(events, key=lambda ev: ev[3]):
            if all(e < ks or s > ke for _, ks, ke, _ in kept):
                kept.append((lab, s, e, sc))
        kept.sort(key=lambda ev: ev[1])
        return kept

    def spot(self, signals, threshold: float | None = None):
        """Recordings -> [(label, start_frame, end_frame, score)] lists
        (DTW span-normalised scores; same units/threshold semantics as
        :class:`KeywordSpotter`)."""
        thr = self.threshold if threshold is None else threshold
        return [self.suppress([ev for ev in evs if ev[3] < thr])
                for evs in self.rescored(signals)]


class _CausalFeatureStream:
    """The front-end half of :class:`_StreamingSpotterBase` with no DP:
    a causal raw-cepstra history plus on-demand window finalization, so
    the streaming cascade can cut stage-2 rerank windows that equal the
    offline whole-recording features row-for-row.

    A [c, Δ, ΔΔ] row needs ±2·delta_width raw frames of context; rows
    of ``window(lo, hi)`` are offline-exact once ``hi + 2w`` raw frames
    exist (or the stream has ended, where edge replication at the true
    last frame matches offline masked_deltas)."""

    def __init__(self, cfg, mats, chunk_len: int):
        self.cfg, self.mats, self.chunk_len = cfg, mats, chunk_len
        f = cfg.frontend
        self._w = f.delta_width if f.add_deltas else 0
        self.lag = 2 * self._w
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len)
        self._frames: list[np.ndarray] = []
        self._samples = 0

    def ingest(self, chunk: np.ndarray, true_samples: int) -> None:
        """One FULL chunk (zero-padded on flush; ``true_samples`` is the
        un-padded sample count it advances the stream by)."""
        f = self.cfg.frontend
        self._samples += true_samples
        self.state, out = st.process_chunk(
            self.state, jnp.asarray(chunk, dtype=jnp.float32), self.mats,
            self.cfg.frontend, self.cfg.vad, self.chunk_len)
        mfcc = np.asarray(out.mfcc)[np.asarray(out.frame_valid)]
        base = len(self._frames)
        keep = [i for i in range(len(mfcc))
                if (base + i) * f.hop_len + f.frame_len <= self._samples]
        self._frames.extend(mfcc[keep])

    @property
    def n_frames(self) -> int:
        return len(self._frames)

    def ready(self, hi: int, final: bool) -> bool:
        """Are rows [.., hi) of ``window`` offline-exact yet?"""
        return (hi + self.lag <= len(self._frames)) or \
            (final and hi <= len(self._frames))

    def window(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of offline add_deltas over the whole stream."""
        c_lo = max(0, lo - self.lag)
        c_hi = min(hi + self.lag, len(self._frames))
        ctx = np.stack(self._frames[c_lo:c_hi]).astype(np.float32)
        if self._w == 0:
            return ctx[lo - c_lo: hi - c_lo]
        from dsp_asr.models.streaming import _np_deltas
        d1 = _np_deltas(ctx, self._w)
        d2 = _np_deltas(d1, self._w)
        rows = np.concatenate([ctx, d1, d2], axis=1)
        return rows[lo - c_lo: hi - c_lo]


class StreamingCascadeSpotter:
    """Online two-stage spotting (VERDICT r4 #8 — the one spotting
    family without a streaming form): :class:`StreamingHmmSpotter`
    landmarks confirm online; each confirmed candidate reranks against
    the template bank (the same constrained device argmin the offline
    :class:`CascadeSpotter` uses) as soon as its widened window's
    features are FINAL, so rescored full-word events emit with bounded
    lag:

        lag ≤ stage-1 hangover + (max template length + margin) + 2w
        frames  (~hangover + window extension + delta finalization).

    Offline==streaming parity on gap-separated keywords: stage 1's DP
    is chunk-boundary-invariant (ops/spot_hmm.py), the rerank windows
    are offline-exact rows (:class:`_CausalFeatureStream`), and the
    emission queue applies the same greedy best-score-first overlap
    suppression locally (a pending event emits once a later candidate
    starts after its end — retraction-free, the streaming analog of
    ``CascadeSpotter.suppress``).

    Same envelope as the offline cascade plus the streaming base's:
    shared frame grid, feature_type='mfcc', cmn=False bank.
    """

    def __init__(self, hmm_recognizer, bank_recognizer,
                 chunk_len: int = 1600, threshold: float | None = None,
                 hmm_threshold: float = -45.0, margin: int = 12,
                 cand_min_gap: int = 25, hangover: int = 25):
        fh = hmm_recognizer.cfg.frontend
        fb = bank_recognizer.cfg.frontend
        if (fh.sample_rate, fh.frame_len, fh.hop_len) != \
                (fb.sample_rate, fb.frame_len, fb.hop_len):
            raise ValueError(
                "cascade stages must share a frame grid: hmm "
                f"(sr={fh.sample_rate}, frame={fh.frame_len}, "
                f"hop={fh.hop_len}) vs bank (sr={fb.sample_rate}, "
                f"frame={fb.frame_len}, hop={fb.hop_len})")
        if fb.cmn:
            raise NotImplementedError(
                "cmn is a whole-stream statistic; enroll a cmn=False "
                "bank for streaming cascade spotting")
        self.rec = bank_recognizer
        self.cfg = dataclasses.replace(bank_recognizer.cfg, use_vad=False)
        self.threshold, self.threshold_source = resolve_spot_threshold(
            bank_recognizer, threshold)
        self.margin = margin
        self.chunk_len = chunk_len
        self.stage1 = StreamingHmmSpotter(
            hmm_recognizer, chunk_len, threshold=hmm_threshold,
            hangover=hangover, min_gap=cand_min_gap)
        bank, ids = bank_recognizer.device_bank()
        self._bank, self._ids = bank, np.asarray(ids)
        self._ext = int(np.max(np.asarray(bank.length))) + margin
        self._feats = _CausalFeatureStream(self.cfg, bank_recognizer.mats,
                                           chunk_len)
        self.reset()

    def reset(self) -> None:
        self.stage1.reset()
        self._feats.reset()
        self._cands: list[tuple[int, float, int]] = []   # (lo, mid, hi)
        self._pend_out = None          # rescored event awaiting suppression

    def frame_to_seconds(self, frame: int) -> float:
        f = self.cfg.frontend
        return frame * f.hop_len / f.sample_rate

    # ------------------------------------------------------------ internals
    def _rerank_ready(self, final: bool):
        """Rerank every queued candidate whose window rows are final;
        returns rescored (label, s, e, score) events, threshold-filtered."""
        ready = [c for c in self._cands
                 if self._feats.ready(min(c[2], self._feats.n_frames),
                                      final)]
        if not ready:
            return []
        self._cands = [c for c in self._cands if c not in ready]
        wins = []
        for lo, mid, hi in ready:
            hi = min(hi, self._feats.n_frames)
            if hi - lo >= 2:
                wins.append((lo, mid, self._feats.window(lo, hi)))
        if not wins:
            return []
        w_pad = -(-max(len(w) for _, _, w in wins) // 32) * 32
        n_rows = _next_pow2(max(8, len(wins)))
        x = np.zeros((n_rows, w_pad, wins[0][2].shape[1]), np.float32)
        lens = np.ones((n_rows,), np.int32)
        mids = np.zeros((n_rows,), np.float32)
        for n, (_, mid, w) in enumerate(wins):
            x[n, :len(w)] = w
            lens[n] = len(w)
            mids[n] = mid
        r, j, s, score = sp.rerank_windows(
            jnp.asarray(x), jnp.asarray(lens), jnp.asarray(mids),
            self._bank.feats, self._bank.length,
            squared=self.cfg.dtw.squared)
        r, j, s, score = (np.asarray(r), np.asarray(j), np.asarray(s),
                          np.asarray(score))
        out = []
        for n, (lo, _mid, _w) in enumerate(wins):
            if score[n] < min(self.threshold, 0.5 * sp.BIG):
                out.append((self.rec.labels[int(self._ids[r[n]])],
                            lo + int(s[n]), lo + int(j[n]),
                            float(score[n])))
        return out

    def _suppressed(self, rescored, final: bool):
        """Retraction-free greedy suppression: a pending event emits
        once a later candidate starts after its end; an overlapping
        better candidate replaces it (mirrors CascadeSpotter.suppress
        for the gap-separated case)."""
        events = []
        for ev in sorted(rescored, key=lambda e: e[1]):
            if self._pend_out is None:
                self._pend_out = ev
            elif ev[1] > self._pend_out[2]:
                events.append(self._pend_out)
                self._pend_out = ev
            elif ev[3] < self._pend_out[3]:
                self._pend_out = ev
        if final and self._pend_out is not None:
            events.append(self._pend_out)
            self._pend_out = None
        return events

    def _emit_horizon(self):
        """Bounded-lag release of the pending event: once the stage-1
        frontier is a full window-extension + suppression-gap past its
        end, no candidate queue entry remains, and stage 1 holds no
        pending match that could rerank back into it, a later
        overlapping rescore cannot arise in the gap-separated regime —
        emit now instead of waiting for the next keyword or flush."""
        if self._pend_out is None or self._cands:
            return []
        horizon = self._ext + self.stage1.min_gap + self.stage1.hangover
        s1p = self.stage1._pending
        if (self.stage1._fed - self._pend_out[2] > horizon
                and (s1p is None
                     or s1p[1] - self._ext > self._pend_out[2])):
            ev, self._pend_out = self._pend_out, None
            return [ev]
        return []

    def _advance(self, s1_events, final: bool):
        for _lab, s, e, _llr in s1_events:
            lo = max(0, s - self._ext)
            self._cands.append((lo, (s + e) / 2.0 - lo, e + 1 + self._ext))
        events = self._suppressed(self._rerank_ready(final), final)
        if not final:
            events.extend(self._emit_horizon())
        return events

    # ------------------------------------------------------------ public
    def feed(self, chunk: np.ndarray):
        """One audio chunk -> confirmed RESCORED events
        ``(label, start_frame, end_frame, dtw_score)``."""
        assert len(chunk) == self.chunk_len
        self._feats.ingest(chunk, len(chunk))
        return self._advance(self.stage1.feed(chunk), final=False)

    def flush(self, tail: np.ndarray | None = None):
        """End of stream (optional short final chunk): close stage 1,
        rerank every remaining candidate, emit everything pending."""
        if tail is not None and len(tail):
            assert len(tail) < self.chunk_len
            buf = np.zeros(self.chunk_len, np.float32)
            buf[: len(tail)] = tail
            self._feats.ingest(buf, len(tail))
        s1 = self.stage1.flush(tail)
        return self._advance(s1, final=True)


class HmmSpotter:
    """HMM keyword spotting: open-endpoint Viterbi vs the UBM filler.

    The GMM-HMM family's spotter (ops/spot_hmm.py — the classical
    keyword/filler network): each trained word HMM may enter at any
    stream frame and exit at any later frame; spans score by the
    per-frame Viterbi log-likelihood RATIO against the recognizer's
    universal background GMM, so a fitted `GmmHmmRecognizer` (which
    always stores its UBM) spots keywords with no extra training.

    ``threshold`` is the per-frame LLR floor: > 0 means the word HMM
    explains the span better than the background model.  Offline batch
    only (the DTW :class:`StreamingSpotter` is the online surface; the
    HMM column update is frame-synchronous so an online variant is
    mechanical if needed — ROADMAP #24).  A recognizer ``mesh`` is
    ignored here: spotting work is per-(stream, word) independent, and
    jit data-parallelism over streams needs no bank collective.
    """

    def __init__(self, recognizer, threshold: float = 0.0,
                 min_gap: int = 45):
        if recognizer.params is None:
            raise ValueError("recognizer not fitted")
        if getattr(recognizer, "ubm", None) is None:
            raise ValueError(
                "recognizer has no UBM filler model — fit() stores one "
                "(batched mode, the default); re-fit or load a "
                "checkpoint saved after round 4")
        self.rec = recognizer
        self.threshold = threshold
        self.min_gap = min_gap    # landmark suppression margin (frames);
        #   45 measured best-F1 on the spotting matrix (25: duplicate
        #   landmarks inside long words cost precision, F1 0.76; 60+:
        #   adjacent keywords merge, recall 0.97 -> 0.87 — RESULTS.md)
        self.cfg = dataclasses.replace(recognizer.cfg, use_vad=False)
        self.mats = recognizer.mats

    def _models_for(self, signals):
        """(params, ubm), PMC-adapted to the streams' estimated noise
        floor when the recognizer has ``noise_adapt`` on — the word
        HMMs AND the filler shift identically, keeping the LLR fair
        (the same automatic remedy the connected decoder uses)."""
        rec = self.rec
        if not getattr(rec, "noise_adapt", False):
            return rec.params, rec.ubm
        from dsp_asr.ops.noise_adapt import (estimate_noise_cepstrum,
                                             pmc_adapt_means,
                                             pmc_supported)
        reason = pmc_supported(self.cfg.frontend)
        if reason:
            raise ValueError(f"noise_adapt unavailable: {reason}")
        quantum = self.cfg.max_samples
        n_len = max(1, max(len(np.asarray(s)) for s in signals))
        x, n = pl.pad_signals(signals, quantum * -(-n_len // quantum))
        noise_c, _ = estimate_noise_cepstrum(
            x, n, self.mats, self.cfg.frontend, self.rec.cfg.vad)
        means = pmc_adapt_means(rec.params.means, noise_c, self.mats,
                                self.cfg.frontend)
        u_means, u_lv, u_lm = rec.ubm
        u_means = pmc_adapt_means(u_means, noise_c, self.mats,
                                  self.cfg.frontend)
        return (rec.params._replace(means=means), (u_means, u_lv, u_lm))

    def scores(self, signals):
        """Per-recording (llr [W, T_i], start [W, T_i]) numpy fields."""
        from dsp_asr.ops.spot_hmm import spot_hmm_batch

        if not len(signals):
            return []
        params, ubm = self._models_for(signals)
        f = self.cfg.frontend
        groups = pl.group_by_padded_len(signals, self.cfg.max_samples)
        results: dict = {}
        for pad_len, idxs in groups.items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            x, n = pl.pad_signals([signals[i] for i in idxs], pad_len)
            feats = pl.extract_recording_features(
                jnp.asarray(x), jnp.asarray(n), self.mats, self.cfg, t_max)
            llr, start = spot_hmm_batch(feats.feats, feats.length,
                                        params, ubm)
            llr, start = np.asarray(llr), np.asarray(start)
            lens = np.asarray(feats.length)
            for row, i in enumerate(idxs):
                t_i = int(lens[row])
                results[i] = (llr[row, :, :t_i], start[row, :, :t_i])
        return [results[i] for i in range(len(signals))]

    def spot(self, signals, threshold: float | None = None):
        """Recordings -> [(label, start_frame, end_frame, llr)] lists."""
        thr = self.threshold if threshold is None else threshold
        out = []
        for llr, start in self.scores(signals):
            # extract_events minimises; negate the LLR field.  min_gap
            # widens suppression: the LLR peaks on a word's CORE, so a
            # second landmark inside the same occurrence may not
            # literally overlap the first
            evs = sp.extract_events(-llr, start, -thr,
                                    min_gap=self.min_gap)
            out.append([(self.rec.labels[r], s, e, -neg)
                        for r, s, e, neg in evs])
        return out
