"""Online recognizer: streaming front-end + template matching.

The reference's live-demo loop (SURVEY.md §3.3: record -> streaming
endpoint detection -> on utterance end: MFCC -> classify).  The host side
here only moves chunks and collects events; all signal processing runs in
the jitted ``process_chunk``, and each finished utterance is classified
with the same device pipeline as the offline recognizer.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops import frontend as fe
from dsp_asr.ops import streaming as st


class StreamingRecognizer:
    """Feed audio chunks, get (label, start_frame, end_frame) events."""

    def __init__(self, recognizer: KnnDtwRecognizer, chunk_len: int = 1600,
                 history_frames: int | None = None):
        self.rec = recognizer
        self.cfg: PipelineConfig = recognizer.cfg
        if self.cfg.frontend.feature_type != "mfcc":
            # the streaming front-end computes MFCC only; matching LPCC
            # bank templates against MFCC queries would silently collapse
            raise NotImplementedError(
                "StreamingRecognizer supports feature_type='mfcc' only "
                f"(got {self.cfg.frontend.feature_type!r})")
        self.chunk_len = chunk_len
        self.mats = recognizer.mats
        self.state = st.init_state(self.cfg.frontend, chunk_len)
        self._frames: list[np.ndarray] = []   # recent MFCC frames, host side
        self._offset = 0                      # global index of _frames[0]
        # keep enough history for the longest classifiable utterance plus
        # VAD hangover; bounds host memory on long-running streams
        self.history_frames = history_frames or 4 * self.cfg.max_frames

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len)
        self._frames = []
        self._offset = 0

    def _trim_history(self) -> None:
        extra = len(self._frames) - self.history_frames
        if extra > 0:
            del self._frames[:extra]
            self._offset += extra

    def feed(self, chunk: np.ndarray):
        """One chunk [chunk_len] -> list of recognized utterance events."""
        assert len(chunk) == self.chunk_len
        self.state, out = st.process_chunk(
            self.state, jnp.asarray(chunk, dtype=jnp.float32), self.mats,
            self.cfg.frontend, self.cfg.vad, self.chunk_len)
        mfcc = np.asarray(out.mfcc)
        valid = np.asarray(out.frame_valid)
        self._frames.extend(mfcc[valid])

        events = []
        ends = np.asarray(out.utt_end)
        min_frames = self.cfg.vad.min_utterance_frames
        for t in np.nonzero(ends)[0]:
            start = int(np.asarray(out.utt_start_idx)[t])
            end = int(np.asarray(out.utt_end_idx)[t])
            end = min(end, self._offset + len(self._frames))
            if end - start >= min_frames:
                ev = self._classify(start, end)
                if ev is not None:
                    events.append(ev)
        self._trim_history()
        return events

    def _classify(self, start: int, end: int):
        # global frame indices -> positions in the trimmed history window
        lo = max(start - self._offset, 0)
        hi = max(end - self._offset, lo)
        if hi <= lo:
            # utterance fell entirely behind the trimmed history window
            # (history_frames < the VAD's silence+hangover horizon) —
            # nothing classifiable; callers drop the None event
            return None
        seg = np.stack(self._frames[lo:hi])                   # [T', n_mfcc]
        t_max = self.cfg.max_frames
        padded = np.zeros((t_max, seg.shape[1]), dtype=np.float32)
        padded[: len(seg)] = seg[:t_max]
        length = jnp.asarray(min(len(seg), t_max))
        if self.cfg.frontend.cmn:
            # mirror pipeline._finalize_window so streaming queries live
            # in the same feature space as the CMN-normalised bank
            valid = (np.arange(t_max) < int(length))[:, None]
            if self.cfg.frontend.cmn_mode == "causal":
                from dsp_asr.golden.frontend import causal_cmn
                n_valid = int(length)
                padded[:n_valid] = causal_cmn(padded[:n_valid],
                                              self.cfg.frontend.cmn_alpha)
                padded = np.where(valid, padded, 0.0).astype(np.float32)
            else:
                mean = ((padded * valid).sum(0, keepdims=True)
                        / max(int(length), 1))
                padded = np.where(valid, padded - mean, 0.0).astype(np.float32)
        feats = fe.add_deltas(jnp.asarray(padded), self.cfg.frontend, length)
        feats = jnp.where((jnp.arange(t_max) < length)[:, None], feats, 0.0)
        query = pl.Features(feats[None], length[None])
        bank, ids = self.rec.device_bank()
        # same matcher routing and kNN vote as the offline recognizer,
        # so a streamed utterance and classify_batch of the identical
        # frames agree (the class docstring's parity promise)
        r = self.rec
        if r.matcher == "ltw":
            label_ids, _ = pl.classify_features_ltw(query, bank, ids,
                                                    r.ltw_len)
        elif r.matcher == "cascade":
            label_ids, _, _ = pl.classify_features_cascade(
                query, bank, ids, r.shortlist, r.k,
                n_labels=len(r.labels), target_len=r.ltw_len, cfg=self.cfg)
        else:
            label_ids, _ = pl.classify_features(
                query, bank, ids, n_labels=len(r.labels), k=r.k,
                cfg=self.cfg)
        label = r._ids_to_labels(label_ids)[0]
        return label, start, end

    def flush(self):
        """Force-close a speech segment in progress (end of stream)."""
        if int(np.asarray(self.state.vad_state)) == st.SPEECH:
            start = int(np.asarray(self.state.utt_start))
            end = self._offset + len(self._frames)
            if end - start >= self.cfg.vad.min_utterance_frames:
                ev = self._classify(start, end)
                return [ev] if ev is not None else []
        return []


def _np_deltas(c: np.ndarray, width: int) -> np.ndarray:
    """Host mirror of ops/frontend.deltas (edge-replicated regression
    deltas) for incremental streaming feature assembly."""
    t = len(c)
    denom = 2.0 * sum(n * n for n in range(1, width + 1))
    idx = np.arange(t)
    acc = np.zeros_like(c)
    for n in range(1, width + 1):
        hi = np.minimum(idx + n, t - 1)
        lo = np.maximum(idx - n, 0)
        acc += n * (c[hi] - c[lo])
    return acc / denom


class StreamingConnectedRecognizer:
    """Online GAPLESS connected-word decoding (ROADMAP #21).

    Couples the streaming front-end (bit-exact offline framing grid,
    ops/streaming.py) with STREAMING level building
    (ops/level_building.py:level_build_chunk — bit-exact vs the batch
    DP under any chunking): while an utterance is open, every frame
    whose features are FINAL flows into the joint DP, so the word
    sequence of a gapless multi-word utterance is being decoded as it
    is spoken — `hypothesis()` returns the running best word sequence
    mid-utterance, and the closed utterance emits a
    ``(labels, start_frame, end_frame)`` event exactly like
    :class:`StreamingRecognizer` does for isolated words.

    A frame's [c, Δ, ΔΔ] row is final once ``2*delta_width`` more
    frames exist (edge replication then cannot touch it), so the DP
    runs that many frames (~40 ms) behind the microphone; the
    utterance-final frames are completed with the true end clamp at
    close, matching ops/frontend.add_deltas row-for-row.  The causal
    VAD still finds UTTERANCE boundaries (leading/trailing silence);
    the DP replaces the per-utterance isolated classify, so words
    INSIDE the utterance need no gaps.

    Envelope: feature_type='mfcc' only (as StreamingRecognizer) and
    cmn=False (CMN is an utterance-global statistic — applying it
    online would retract already-decoded DP frames).  The per-frame DP
    step compiles ONE [1, F] program; throughput-oriented offline use
    should call ``classify_connected(method='level')`` instead.
    """

    def __init__(self, recognizer: KnnDtwRecognizer, chunk_len: int = 1600,
                 max_levels: int = 8, word_penalty: float = 0.0):
        from dsp_asr.ops import level_building as lb

        self.rec = recognizer
        self.cfg: PipelineConfig = recognizer.cfg
        if self.cfg.frontend.feature_type != "mfcc":
            raise NotImplementedError(
                "StreamingConnectedRecognizer supports "
                "feature_type='mfcc' only")
        if self.cfg.frontend.cmn and self.cfg.frontend.cmn_mode != "causal":
            # utterance-mode cmn is a whole-utterance statistic; the
            # online DP cannot retract frames it already decoded.
            # cmn_mode="causal" (prefix-stable running mean, round 5) IS
            # supported — enroll the bank with the same mode.
            raise NotImplementedError(
                "cmn_mode='utterance' cannot stream; enroll a cmn=False "
                "or cmn_mode='causal' bank for streaming connected "
                "decoding")
        self._lb = lb
        self.chunk_len = chunk_len
        self.max_levels = max_levels
        self.word_penalty = word_penalty
        self.mats = recognizer.mats
        bank, ids = recognizer.device_bank()
        self._bank = bank
        self._ids = np.asarray(ids)
        self._lag = 2 * self.cfg.frontend.delta_width
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len)
        self._frames: list[np.ndarray] = []   # raw 13-dim MFCC, host
        self._offset = 0                      # global index of _frames[0]
        self._utt = None                      # open-utterance DP state

    # ------------------------------------------------------------ internals
    def _open_utt(self, start: int) -> None:
        k, u = self._bank.feats.shape[0], self._bank.feats.shape[1]
        self._utt = {
            "start": start,                   # global frame index
            "fed": 0,                         # frames fed to the DP
            "state": self._lb.level_stream_init(self.max_levels, k, u),
            "planes": ([], [], []),           # per-feed [L, t] columns
        }

    def _utt_feats(self, n_avail: int, final: bool) -> np.ndarray:
        """Features for the open utterance's first ``n_avail`` frames,
        clamped as if the utterance were ``n_avail`` long — rows
        [0, n_avail - lag) (all rows when ``final``) equal
        ops/frontend.add_deltas over the closed utterance."""
        lo = self._utt["start"] - self._offset
        c = np.stack(self._frames[lo:lo + n_avail]).astype(np.float32)
        if self.cfg.frontend.cmn:
            # causal mode only (the __init__ guard): prefix-stable, so
            # rows already fed to the DP are reproduced bit-identically
            from dsp_asr.golden.frontend import causal_cmn
            c = causal_cmn(c, self.cfg.frontend.cmn_alpha)
        if not self.cfg.frontend.add_deltas:
            return c
        d1 = _np_deltas(c, self.cfg.frontend.delta_width)
        d2 = _np_deltas(d1, self.cfg.frontend.delta_width)
        return np.concatenate([c, d1, d2], axis=1)

    def _feed_dp(self, upto: int, final: bool) -> None:
        """Advance the DP to utterance frame ``upto`` (exclusive)."""
        utt = self._utt
        if upto <= utt["fed"]:
            return
        feats = self._utt_feats(upto if final else upto + self._lag,
                                final)[utt["fed"]:upto]
        for row in feats:                     # one [1, F] program, reused
            utt["state"], (cs, ws, ss) = self._lb.level_build_chunk(
                utt["state"], jnp.asarray(row[None]), self._bank.feats,
                self._bank.length, word_penalty=self.word_penalty,
                squared=self.cfg.dtw.squared)
            for acc, x in zip(utt["planes"], (cs, ws, ss)):
                acc.append(np.asarray(x))
        utt["fed"] = upto

    def _decode(self, t_valid: int):
        cs, ws, ss = (np.concatenate(p, axis=1) for p in
                      self._utt["planes"])
        seq, cost = self._lb.backtrack(cs, ws, ss, t_valid,
                                       max_levels=self.max_levels)
        return [self.rec.labels[int(self._ids[v])] for v in seq], cost

    def _close_utt(self, end: int):
        utt = self._utt
        n = end - utt["start"]
        event = None
        if n >= self.cfg.vad.min_utterance_frames and n > 0:
            self._feed_dp(n, final=True)
            labels, _ = self._decode(n)
            if labels:
                event = (labels, utt["start"], end)
        self._utt = None
        return event

    def _trim_history(self) -> None:
        keep_from = (self._utt["start"] - self._offset
                     if self._utt else len(self._frames))
        extra = min(keep_from, len(self._frames) - 4 * self.cfg.max_frames)
        if extra > 0:
            del self._frames[:extra]
            self._offset += extra

    # ------------------------------------------------------------ public
    def feed(self, chunk: np.ndarray):
        """One audio chunk -> list of finished-utterance events
        ``(word labels, start frame, end frame)``."""
        assert len(chunk) == self.chunk_len
        self.state, out = st.process_chunk(
            self.state, jnp.asarray(chunk, dtype=jnp.float32), self.mats,
            self.cfg.frontend, self.cfg.vad, self.chunk_len)
        mfcc = np.asarray(out.mfcc)
        valid = np.asarray(out.frame_valid)
        self._frames.extend(mfcc[valid])
        n_total = self._offset + len(self._frames)

        events = []
        for t in np.nonzero(np.asarray(out.utt_end))[0]:
            if self._utt is None:
                self._open_utt(int(np.asarray(out.utt_start_idx)[t]))
            ev = self._close_utt(
                min(int(np.asarray(out.utt_end_idx)[t]), n_total))
            if ev is not None:
                events.append(ev)
        if self._utt is None and int(np.asarray(self.state.vad_state)) \
                == st.SPEECH:
            self._open_utt(int(np.asarray(self.state.utt_start)))
        if self._utt is not None:
            # stream the DP up to the last FINAL-featured frame
            avail = n_total - self._utt["start"]
            self._feed_dp(max(0, avail - self._lag), final=False)
        self._trim_history()
        return events

    def hypothesis(self):
        """Running best word sequence of the OPEN utterance (decoded
        from the frames fed so far), or None outside speech."""
        if self._utt is None or self._utt["fed"] == 0:
            return None
        return self._decode(self._utt["fed"])[0]

    def flush(self):
        """End of stream: close any open utterance."""
        if self._utt is None:
            return []
        end = self._offset + len(self._frames)
        ev = self._close_utt(end)
        return [ev] if ev is not None else []
