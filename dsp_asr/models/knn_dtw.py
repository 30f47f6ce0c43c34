"""kNN-DTW isolated-word recognizer (the reference's primary model).

Mirrors the reference's template-matching recognizer (SURVEY.md L3/L4:
`enroll`, `classify`, template bank, argmin/kNN vote) with a device-friendly
data layout: the bank is one padded device array ``[K, U_max, F]`` with a
length vector, so classification against the whole vocabulary is a single
jitted all-pairs DTW (and shards over a mesh via dsp_asr.parallel).

Checkpointing: the bank round-trips through a plain ``.npz`` file
(SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig
from dsp_asr.ops import frontend as fe

# Returned when a vote row had no live candidates (pipeline.vote_topk's
# -1 sentinel): the query was unreachable from every template, e.g. under
# slope="itakura" with all length ratios > 2.
NO_MATCH = "<no-match>"

# Returned under rejection (classify_batch(reject=...)) for a query whose
# best bank distance fails the utterance-verification threshold — the
# classical out-of-vocabulary / garbage-input reject decision (SURVEY.md
# §1a L3: the reference's argmin classifier has no OOV notion; a
# production recognizer needs one).
REJECT = "<reject>"


class KnnDtwRecognizer:
    """Template-bank recognizer: enroll utterances, classify by DTW.

    Pass ``mesh`` (a `jax.sharding.Mesh` from `dsp_asr.parallel.make_mesh`)
    to run classification bank-sharded across devices — including kNN
    voting (per-shard top-k gather); the query batch and bank are padded
    to the mesh axes transparently.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), k: int = 1,
                 mesh=None, matcher: str = "dtw", ltw_len: int = 64,
                 shortlist: int = 8, bucketed: bool = False):
        if matcher not in ("dtw", "ltw", "cascade"):
            raise ValueError(f"unknown matcher: {matcher}")
        self.cfg = cfg
        self.k = k
        self.mesh = mesh
        self.matcher = matcher          # 'ltw' fast path | 'cascade' = LTW
        self.ltw_len = ltw_len          # shortlist -> DTW rerank
        self.shortlist = shortlist
        self.bucketed = bucketed        # opt-in length-bucketed DTW (see
        #   pipeline.classify_features_bucketed: exact, but extra launch
        #   + fetch round-trips — only pays off for large genuinely
        #   mixed-length batches)
        self.mats = fe.make_matrices(cfg.frontend)
        self.spot_threshold: float | None = None   # per-bank calibrated
        #   spotting threshold (models/spotter.py calibrate_threshold),
        #   written at enroll time and persisted in the checkpoint; the
        #   fixed default 40 decays at vocabulary scale (35 keywords:
        #   F1 0.80 vs 0.91 calibrated — docs/RESULTS.md)
        self.reject_threshold: float | None = None  # per-bank calibrated
        #   OOV-rejection threshold (calibrate_rejection), persisted in
        #   the checkpoint; used by classify_batch(reject=True)
        self.reject_scale: str | None = None        # score scale it was
        #   calibrated in ("dtw" | "ltw") — validated at use time, since
        #   the matcher can be switched after enrollment
        self.labels: list[str] = []          # label id -> string
        self._bank_feats: list[np.ndarray] = []   # [U_max, F] each
        self._bank_lens: list[int] = []
        self._bank_label_ids: list[int] = []
        self._device_bank = None             # cached (Features, label_ids)
        self._sharded_bank = None            # cached mesh-resident bank

    # ------------------------------------------------------------- enroll
    def _pad_signals(self, signals):
        return pl.pad_signals(signals, self.cfg.max_samples)

    def extract(self, signals) -> pl.Features:
        """Host list of signals -> device Features (one jit call)."""
        return pl.extract_signals(signals, self.mats, self.cfg)

    def enroll(self, label: str, signals) -> None:
        """Add template utterances for ``label`` to the bank."""
        if label not in self.labels:
            self.labels.append(label)
        label_id = self.labels.index(label)
        feats = self.extract(signals)
        f = np.asarray(feats.feats)
        l = np.asarray(feats.length)
        for i in range(f.shape[0]):
            self._bank_feats.append(f[i])
            self._bank_lens.append(int(l[i]))
            self._bank_label_ids.append(label_id)
        self._device_bank = None
        self._sharded_bank = None

    @property
    def n_templates(self) -> int:
        return len(self._bank_feats)

    def device_bank(self):
        if self._device_bank is None:
            if not self._bank_feats:
                raise ValueError("empty template bank — enroll first")
            bank = pl.Features(
                jnp.asarray(np.stack(self._bank_feats)),
                jnp.asarray(np.asarray(self._bank_lens, dtype=np.int32)),
            )
            ids = jnp.asarray(np.asarray(self._bank_label_ids, dtype=np.int32))
            self._device_bank = (bank, ids)
        return self._device_bank

    def sharded_bank(self):
        """Bank padded to the mesh bank axis and placed shard-wise."""
        from dsp_asr import parallel as par

        if self._sharded_bank is None:
            if not self._bank_feats:
                raise ValueError("empty template bank — enroll first")
            nb = self.mesh.shape[par.BANK_AXIS]
            feats, k_orig = par.pad_axis_to_multiple(
                np.stack(self._bank_feats).astype(np.float32), nb)
            lens, _ = par.pad_axis_to_multiple(
                np.asarray(self._bank_lens, dtype=np.int32), nb)
            ids, _ = par.pad_axis_to_multiple(
                np.asarray(self._bank_label_ids, dtype=np.int32), nb)
            lens = np.maximum(lens, 1)
            valid = np.arange(len(lens)) < k_orig
            self._sharded_bank = (
                par.shard_bank(self.mesh, feats),
                par.shard_bank(self.mesh, lens),
                par.replicate(self.mesh, ids),
                par.shard_bank(self.mesh, valid),
            )
        return self._sharded_bank

    # ----------------------------------------------------------- rejection
    def _bank_self_distances(self) -> np.ndarray:
        """[K, K] distance of every enrolled template against the bank,
        in the DEPLOYED matcher's score scale: ltw scores in squared
        linear-warp units; dtw / cascade / bucketed / mesh all score in
        full-DTW units (the cascade's rerank distances ARE DTW)."""
        bank, ids = self.device_bank()
        if self.matcher == "ltw":
            _, d = pl.classify_features_ltw(bank, bank, ids, self.ltw_len)
        else:
            _, d = pl.classify_features(bank, bank, ids,
                                        n_labels=len(self.labels), k=1,
                                        cfg=self.cfg)
        return np.asarray(d)

    def calibrate_rejection(self, genuine_q: float = 0.9,
                            impostor_q: float = 0.02) -> float:
        """Per-bank OOV-rejection threshold from enrollment data alone.

        The classical utterance-verification decision: ACCEPT a query
        iff its best bank distance clears a threshold; anything else —
        out-of-vocabulary words, coughs, line noise — returns
        ``REJECT`` instead of silently electing the nearest enrolled
        word (which the plain argmin always does).

        Two populations the threshold must separate, both available
        from the bank itself (the same separation rule as the spotting
        calibration, models/spotter.py:calibrate_threshold):

        * GENUINE — each template's best leave-one-out distance to a
          SAME-label template: what an in-vocabulary query scores.
          (The test-time statistic is the min over the WHOLE bank,
          which is <= this, so the genuine side is conservative.)
        * IMPOSTOR — each template's best distance to a WRONG-label
          template: what a query scores when its own word is absent
          from the bank — the OOV mechanism.

        Returns midpoint(genuine q0.9, impostor q0.02) and stores it on
        ``self.reject_threshold`` (persisted by save/load).  Requires
        >= 2 templates of some label and >= 2 labels.
        """
        d = self._bank_self_distances()
        ids = np.asarray(self._bank_label_ids)
        same = ids[:, None] == ids[None, :]
        eye = np.eye(len(ids), dtype=bool)
        dd = np.where(d < 1e20, d, np.inf)      # dead pairs carry no info
        genuine = np.min(np.where(same & ~eye, dd, np.inf), axis=1)
        impostor = np.min(np.where(~same, dd, np.inf), axis=1)
        genuine = genuine[np.isfinite(genuine)]
        impostor = impostor[np.isfinite(impostor)]
        if not len(genuine):
            raise ValueError("calibrate_rejection needs >= 2 templates "
                             "of some label (no genuine pairs in bank)")
        if not len(impostor):
            raise ValueError("calibrate_rejection needs >= 2 labels "
                             "(no impostor pairs in bank)")
        self.reject_threshold = float(
            (np.quantile(genuine, genuine_q)
             + np.quantile(impostor, impostor_q)) / 2.0)
        self.reject_scale = self._score_scale()
        return self.reject_threshold

    def _score_scale(self) -> str:
        return "ltw" if self.matcher == "ltw" else "dtw"

    def _resolve_reject(self, reject) -> float | None:
        """None/False = off; True = the calibrated per-bank threshold
        (error if none is stored); a number = explicit threshold."""
        if reject is None or reject is False:
            return None
        if reject is True:
            if self.reject_threshold is None:
                raise ValueError(
                    "reject=True but no rejection threshold is stored — "
                    "calibrate_rejection() first (enroll does this by "
                    "default) or pass an explicit number")
            if (self.reject_scale is not None
                    and self.reject_scale != self._score_scale()):
                raise ValueError(
                    f"stored rejection threshold was calibrated in "
                    f"{self.reject_scale!r} score units but the current "
                    f"matcher scores in {self._score_scale()!r} — "
                    f"recalibrate (calibrate_rejection) under this "
                    f"matcher or pass an explicit threshold")
            return float(self.reject_threshold)
        return float(reject)

    # ------------------------------------------------------------ classify
    def classify_batch(self, signals, return_distances: bool = False,
                       chunk: int = 256, reject=None):
        """List of signals -> list of labels.

        Large batches are processed in fixed-size chunks (padded to the
        chunk size so only one program is compiled) to bound the [B, K,
        T, U] DTW cost memory on device.

        ``reject`` turns on utterance verification (see
        :meth:`calibrate_rejection`): queries whose best bank distance
        fails the threshold come back as ``REJECT``.  Works under every
        matcher and the mesh — the decision reads the distances the
        matcher already returns (the cascade's shortlist minimum IS its
        best DTW distance; ltw thresholds in ltw units, which is the
        scale its calibration uses).
        """
        thr = self._resolve_reject(reject)
        if thr is not None:
            labels, dists = self.classify_batch(signals, chunk=chunk,
                                                return_distances=True)
            dd = np.where(np.asarray(dists) < 1e20, dists, np.inf)
            best = dd.min(axis=1) if dd.size else np.zeros(len(labels))
            labels = [REJECT if (lab != NO_MATCH and not (b < thr))
                      else lab for lab, b in zip(labels, best)]
            if return_distances:
                return labels, dists
            return labels
        if self.mesh is not None:
            if self.matcher != "dtw":
                raise ValueError(
                    f"matcher={self.matcher!r} is not supported with a "
                    "mesh — bank-sharded classification implements the "
                    "full banded DTW only (clear the mesh or use "
                    "matcher='dtw')")
            return self._classify_sharded(signals, return_distances)
        if len(signals) > chunk:
            labels, dists = [], []
            for lo in range(0, len(signals), chunk):
                part = list(signals[lo:lo + chunk])
                n_real = len(part)
                part += [part[-1]] * (chunk - n_real)     # pad, same shapes
                got = self.classify_batch(part, return_distances=True)
                labels.extend(got[0][:n_real])
                dists.append(got[1][:n_real])
            if return_distances:
                return labels, np.concatenate(dists)
            return labels
        x, n = self._pad_signals(signals)
        bank, ids = self.device_bank()
        if self.matcher == "ltw":
            feats = pl.extract_features(x, n, self.mats, self.cfg)
            label_ids, dists = pl.classify_features_ltw(
                feats, bank, ids, self.ltw_len)
        elif self.matcher == "cascade":
            feats = pl.extract_features(x, n, self.mats, self.cfg)
            label_ids, dists, _ = pl.classify_features_cascade(
                feats, bank, ids, self.shortlist, self.k,
                n_labels=len(self.labels), target_len=self.ltw_len,
                cfg=self.cfg)
        elif self.bucketed and len(signals) > 32:
            # host-side length bucketing: short utterances run a smaller
            # static-T DTW program; bit-identical per pair to the
            # unbucketed path (pipeline.classify_features_bucketed docs)
            feats = pl.extract_features(x, n, self.mats, self.cfg)
            label_ids, dists = pl.classify_features_bucketed(
                feats, bank, ids, n_labels=len(self.labels), k=self.k,
                cfg=self.cfg)
        elif self.k <= 1:
            label_ids, dists = pl.recognize_batch(
                x, n, self.mats, bank, ids, self.cfg)
        else:
            label_ids, dists = self._classify_knn(x, n, bank, ids)
        labels = self._ids_to_labels(label_ids)
        if return_distances:
            return labels, np.asarray(dists)
        return labels

    def classify_nbest(self, signals, n: int = 3):
        """Top-n label hypotheses per utterance: ``[[(label, distance,
        weight)]]`` sorted best-first.

        Per-label score = the min DTW distance over that label's
        templates (the 1-NN rule applied per label); ``weight`` is
        pipeline.nbest_from_scores's relative confidence.  Rides
        ``classify_batch(return_distances=True)``, so it works under
        every matcher and bank-sharded over a mesh; labels whose every
        template is dead (e.g. unreachable under slope='itakura') are
        dropped — an utterance no template can reach returns [].
        """
        if not len(signals):
            return []
        _, dists = self.classify_batch(signals, return_distances=True)
        ids = np.asarray(self._bank_label_ids)
        label_d = np.full((dists.shape[0], len(self.labels)), 1e30)
        np.minimum.at(label_d, (np.arange(dists.shape[0])[:, None],
                                np.broadcast_to(ids, dists.shape)), dists)
        return pl.nbest_from_scores(label_d, self.labels, n)

    def _ids_to_labels(self, label_ids) -> list:
        """Map vote ids to strings; the vote's -1 all-candidates-dead
        sentinel (pipeline.vote_topk) becomes NO_MATCH instead of
        wrapping around to the last enrolled label."""
        return [self.labels[i] if i >= 0 else NO_MATCH
                for i in map(int, np.asarray(label_ids))]

    def _classify_sharded(self, signals, return_distances: bool):
        from dsp_asr import parallel as par

        x, n = self._pad_signals(signals)
        nd = self.mesh.shape[par.DATA_AXIS]
        x_p, b_orig = par.pad_axis_to_multiple(np.asarray(x), nd)
        n_p, _ = par.pad_axis_to_multiple(np.asarray(n), nd)
        n_p = np.maximum(n_p, self.cfg.frontend.frame_len)
        xd, nd_ = par.shard_queries(self.mesh, x_p, n_p)
        bf, bl, ids, valid = self.sharded_bank()
        label_ids, dist = par.recognize_sharded(
            self.mesh, xd, nd_, self.mats, bf, bl, ids, valid, cfg=self.cfg,
            k=self.k, n_labels=len(self.labels),
            return_full=return_distances)
        labels = self._ids_to_labels(np.asarray(label_ids)[:b_orig])
        if return_distances:
            # full [B, K] matrix gathered over the mesh (trim bank padding)
            return labels, np.asarray(dist)[:b_orig, :self.n_templates]
        return labels

    def _classify_knn(self, x, n, bank, ids):
        feats = pl.extract_features(x, n, self.mats, self.cfg)
        return pl.classify_features(feats, bank, ids, n_labels=len(self.labels),
                                    k=self.k, cfg=self.cfg)

    def recognize(self, signal, reject=None) -> str:
        """Single utterance -> label (the reference's main entry point).
        ``reject`` as in :meth:`classify_batch` (may return REJECT)."""
        return self.classify_batch([signal], reject=reject)[0]

    def resolve_grammar(self, grammar):
        """Normalise a grammar argument -> UNIT-level masks for the bank.

        ``grammar`` may be an ops/grammar.py:Grammar, a spec dict, or a
        path to a JSON spec file (dict/path are compiled over THIS
        recognizer's vocabulary).  A ready-made Grammar is matched to
        the bank BY LABEL STRING (its word order need not match
        enrollment order); every enrolled label must appear in it.
        Returns ``(start [K], pairs [K, K], end [K])`` numpy bools over
        bank template rows.
        """
        from dsp_asr.ops.grammar import Grammar

        if isinstance(grammar, str):
            grammar = Grammar.load(grammar, self.labels)
        elif isinstance(grammar, dict):
            grammar = Grammar.from_spec(grammar, self.labels)
        gidx = {w: i for i, w in enumerate(grammar.labels)}
        missing = [w for w in self.labels if w not in gidx]
        if missing:
            raise ValueError(
                "grammar does not cover enrolled labels: "
                + ", ".join(missing))
        unit_gids = np.asarray([gidx[self.labels[i]]
                                for i in self._bank_label_ids])
        return grammar.unit_masks(unit_gids)

    def classify_connected(self, signals, max_segments: int = 8,
                           return_segments: bool = False,
                           method: str = "vad",
                           word_penalty: float = 0.0,
                           grammar=None):
        """Recordings with SEVERAL words each -> one label list per recording.

        Two decoders:

        ``method="vad"`` (default) — the splitter path (SURVEY.md §1a
        L1: the reference's endpoint detector also "splits
        utterances"): the multi-segment VAD (ops/vad.py:detect_segments)
        splits each recording into up to ``max_segments`` utterances,
        and every segment is classified against the bank in one flat
        batch with the same matcher kernels and kNN vote as
        ``classify_batch``.  Requires silence gaps between words.

        ``method="level"`` — level-building DP
        (ops/level_building.py): word count, identities and boundaries
        are chosen JOINTLY by dynamic programming against the template
        bank, so coarticulated/GAPLESS recordings decode correctly
        (``max_segments`` caps the word count; ``word_penalty`` biases
        it, 0 = pure distance).  With ``mesh`` set the DP runs
        bank-sharded (parallel/sharding.py:level_build_sharded).  The
        ltw/cascade matchers do not apply (the DP aligns raw frames
        against the full bank).

        ``grammar`` (method="level" only) — a finite-state word syntax
        (ops/grammar.py: Grammar | spec dict | JSON path, see
        :meth:`resolve_grammar`) constraining which words may start/end
        the utterance and which pairs may be adjacent; the constraint
        enters the joint DP itself (level_build_grammar), not a
        post-filter, so the decoder returns the best GRAMMATICAL
        sequence.  Returns ``[]`` for a recording the grammar cannot
        explain.

        Recordings may be longer than ``cfg.max_samples`` — they are
        padded to a whole multiple of it so compile shapes stay
        quantised.  With ``return_segments`` also returns segment
        metadata: (starts, ends, n_segs) frame indices for "vad"; the
        per-recording DP costs for "level".  Chunking, empty-input and
        dummy-segment handling live in ``pipeline.decode_connected`` /
        ``decode_connected_level`` (shared machinery).  With ``mesh``
        set the per-segment classify runs bank-sharded over the mesh,
        exactly like ``classify_batch`` (method="vad" only).
        """
        if grammar is not None and method != "level":
            raise ValueError(
                "grammar constraints require method='level' (the VAD "
                "splitter classifies segments independently — there is "
                "no joint sequence to constrain)")
        if method == "level":
            if grammar is not None and self.mesh is not None:
                # bank-sharded grammar DP (parallel/sharding.py:
                # level_build_grammar_sharded); the pipeline pads the
                # real-bank masks to the mesh's padded bank
                bf, bl, ids_r, valid = self.sharded_bank()
                id_lists, costs = pl.decode_connected_level(
                    signals, self.mats, self.cfg, pl.Features(bf, bl),
                    np.asarray(ids_r), max_levels=max_segments,
                    word_penalty=word_penalty, mesh=self.mesh,
                    bank_valid=valid,
                    grammar_masks=self.resolve_grammar(grammar))
            elif grammar is not None:
                bank, ids = self.device_bank()
                id_lists, costs = pl.decode_connected_level(
                    signals, self.mats, self.cfg, bank, ids,
                    max_levels=max_segments, word_penalty=word_penalty,
                    grammar_masks=self.resolve_grammar(grammar))
            elif self.mesh is not None:
                # bank-sharded DP over the mesh (parallel/sharding.py:
                # level_build_sharded) — same results as single-device
                bf, bl, ids_r, valid = self.sharded_bank()
                id_lists, costs = pl.decode_connected_level(
                    signals, self.mats, self.cfg, pl.Features(bf, bl),
                    np.asarray(ids_r), max_levels=max_segments,
                    word_penalty=word_penalty, mesh=self.mesh,
                    bank_valid=valid)
            else:
                bank, ids = self.device_bank()
                id_lists, costs = pl.decode_connected_level(
                    signals, self.mats, self.cfg, bank, ids,
                    max_levels=max_segments, word_penalty=word_penalty)
            out = [self._ids_to_labels(np.asarray(ids_i, np.int32))
                   for ids_i in id_lists]
            if return_segments:
                return out, costs
            return out
        if method != "vad":
            raise ValueError(f"unknown connected method {method!r} "
                             "(vad | level)")
        if self.mesh is not None:
            if self.matcher != "dtw":
                raise ValueError(
                    f"matcher={self.matcher!r} is not supported with a "
                    "mesh — bank-sharded classification implements the "
                    "full banded DTW only (clear the mesh or use "
                    "matcher='dtw')")
            score = self._score_flat_sharded
        else:
            bank, ids = self.device_bank()

            def score(flat):
                # same matcher routing as classify_batch
                if self.matcher == "ltw":
                    label_ids, _ = pl.classify_features_ltw(
                        flat, bank, ids, self.ltw_len)
                elif self.matcher == "cascade":
                    label_ids, _, _ = pl.classify_features_cascade(
                        flat, bank, ids, self.shortlist, self.k,
                        n_labels=len(self.labels), target_len=self.ltw_len,
                        cfg=self.cfg)
                else:
                    label_ids, _ = pl.classify_features(
                        flat, bank, ids, n_labels=len(self.labels),
                        k=self.k, cfg=self.cfg)
                return label_ids

        out, starts, ends, n_segs = pl.decode_connected(
            signals, self.mats, self.cfg, max_segments,
            score, self._ids_to_labels)
        if return_segments:
            return out, starts, ends, n_segs
        return out

    def _score_flat_sharded(self, flat: pl.Features):
        """Flat per-segment Features -> label ids via the sharded bank
        (pads the batch to the data-axis multiple, trims after)."""
        from dsp_asr import parallel as par

        bf, bl, ids_r, valid = self.sharded_bank()
        nd = self.mesh.shape[par.DATA_AXIS]
        q, b_orig = par.pad_axis_to_multiple(np.asarray(flat.feats), nd)
        ql, _ = par.pad_axis_to_multiple(np.asarray(flat.length), nd)
        ql = np.maximum(ql, 1)
        qd, qld = par.shard_queries(self.mesh, q, ql)
        label_ids, _ = par.classify_sharded(
            self.mesh, qd, qld, bf, bl, ids_r, valid, cfg=self.cfg.dtw,
            k=self.k, n_labels=len(self.labels))
        return np.asarray(label_ids)[:b_orig]

    def evaluate(self, corpus: dict, reject=None) -> dict:
        """{label: [signals]} -> accuracy + per-label confusion counts.

        With ``reject`` set (see :meth:`classify_batch`), corpus labels
        NOT in the bank are treated as out-of-vocabulary truth: those
        queries count correct iff rejected (their confusion row is
        keyed ``REJECT``), and an in-vocabulary query that gets
        rejected counts wrong — so the single accuracy number folds in
        both the false-accept and false-reject rates.
        """
        thr = self._resolve_reject(reject)
        if thr is None:
            return pl.evaluate_corpus(self.classify_batch, corpus)
        mapped: dict = {}
        for lab, xs in corpus.items():
            key = lab if lab in self.labels else REJECT
            mapped.setdefault(key, []).extend(xs)
        return pl.evaluate_corpus(
            lambda s: self.classify_batch(s, reject=thr), mapped)

    # ------------------------------------------------------------ condense
    def condense(self, method: str = "dba", n_iter: int = 3) -> None:
        """Collapse each label's templates into one (medoid or DBA average).

        Shrinks the bank K-fold — classification cost scales with K, so a
        condensed bank trades a little accuracy for proportional speed
        (the reference's optional template-averaging enrollment step).
        """
        import dataclasses

        from dsp_asr.ops import align as jalign

        # medoid/DBA alignment runs unbanded: condensation is offline and
        # the averaged templates are better with exact alignments
        align_cfg = dataclasses.replace(self.cfg.dtw, band_frac=None)
        new_feats, new_lens, new_ids = [], [], []
        for label_id in range(len(self.labels)):
            idx = [i for i, l in enumerate(self._bank_label_ids)
                   if l == label_id]
            if not idx:
                continue
            feats = jnp.asarray(np.stack([self._bank_feats[i] for i in idx]))
            lens = jnp.asarray(np.asarray([self._bank_lens[i] for i in idx],
                                          dtype=np.int32))
            mi = int(jalign.medoid(feats, lens, align_cfg))
            center, len_c = feats[mi], lens[mi]
            if method == "dba" and len(idx) > 1:
                center = jalign.dba_average(feats, lens, center, len_c,
                                            n_iter, align_cfg)
            new_feats.append(np.asarray(center))
            new_lens.append(int(len_c))
            new_ids.append(label_id)
        self._bank_feats, self._bank_lens = new_feats, new_lens
        self._bank_label_ids = new_ids
        self._device_bank = None
        self._sharded_bank = None

    # ---------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        bank = np.stack(self._bank_feats) if self._bank_feats else \
            np.zeros((0, self.cfg.max_frames, self.cfg.frontend.n_feats), np.float32)
        np.savez(
            path,
            bank=bank,
            lens=np.asarray(self._bank_lens, dtype=np.int32),
            label_ids=np.asarray(self._bank_label_ids, dtype=np.int32),
            labels=json.dumps(self.labels),
            k=self.k,
            matcher=self.matcher,
            ltw_len=self.ltw_len,
            shortlist=self.shortlist,
            bucketed=self.bucketed,
            spot_threshold=(np.nan if self.spot_threshold is None
                            else float(self.spot_threshold)),
            reject_threshold=(np.nan if self.reject_threshold is None
                              else float(self.reject_threshold)),
            reject_scale=self.reject_scale or "",
            frontend=json.dumps(frontend_signature(self.cfg)),
        )

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig = PipelineConfig()):
        data = np.load(path, allow_pickle=False)
        matcher = str(data["matcher"]) if "matcher" in data.files else "dtw"
        ltw_len = int(data["ltw_len"]) if "ltw_len" in data.files else 64
        shortlist = int(data["shortlist"]) if "shortlist" in data.files else 8
        bucketed = bool(data["bucketed"]) if "bucketed" in data.files else False
        check_frontend_signature(data, cfg, path)
        rec = cls(cfg, k=int(data["k"]), matcher=matcher, ltw_len=ltw_len,
                  shortlist=shortlist, bucketed=bucketed)
        rec.labels = json.loads(str(data["labels"]))
        rec._bank_feats = [f for f in data["bank"]]
        rec._bank_lens = [int(v) for v in data["lens"]]
        rec._bank_label_ids = [int(v) for v in data["label_ids"]]
        if "spot_threshold" in data.files:
            st = float(data["spot_threshold"])
            rec.spot_threshold = st if np.isfinite(st) else None
        if "reject_threshold" in data.files:
            rt = float(data["reject_threshold"])
            rec.reject_threshold = rt if np.isfinite(rt) else None
            rec.reject_scale = str(data["reject_scale"]) or None
        return rec


def frontend_signature(cfg: PipelineConfig) -> dict:
    """The config fields that define the checkpoint's feature space."""
    f = cfg.frontend
    return {
        "sample_rate": f.sample_rate,
        "n_mfcc": f.n_mfcc,
        "add_deltas": f.add_deltas,
        # encode the mode+alpha only when they matter so utterance-mode
        # checkpoints keep the legacy boolean (older banks still load)
        "cmn": (f"causal:a{f.cmn_alpha}"
                if f.cmn and f.cmn_mode == "causal" else f.cmn),
        # the subtraction parameters shape the feature space too — a
        # mismatched alpha would silently classify in a different space
        "denoise": (f"{f.denoise}:a{f.ss_alpha}:b{f.ss_beta}:f{f.ss_frac}"
                    if f.denoise else "none"),
        "feature_type": f.feature_type,
        "n_feats": f.n_feats,
        "max_frames": cfg.max_frames,
    }


def check_frontend_signature(data, cfg: PipelineConfig, path: str) -> None:
    """Refuse to load a bank whose features were extracted under a
    different front-end: the mismatch would otherwise classify queries in
    a silently different feature space (or die on a cryptic shape error).
    Older checkpoints without the signature load unchecked."""
    if "frontend" not in data.files:
        return
    saved = json.loads(str(data["frontend"]))
    now = frontend_signature(cfg)
    bad = {key: (saved[key], now[key])
           for key in saved if key in now and saved[key] != now[key]}
    if bad:
        detail = ", ".join(f"{key}: checkpoint={a!r} vs cfg={b!r}"
                           for key, (a, b) in bad.items())
        raise ValueError(
            f"checkpoint {path} was created with a different front-end "
            f"config ({detail}); pass the matching PipelineConfig")
