"""VQ-codebook isolated-word recognizer (classical distortion matching).

The third classical recognizer family alongside template DTW and
GMM-HMM (Rabiner & Juang ch. 3/8 describe the VQ word recognizer; the
reference repo's family of DSP-course recognizers commonly includes it —
reconstruction, the reference mount is empty, SURVEY.md §0).  Each word
gets a k-means codebook over its enrollment MFCC frames; a query is
scored by its mean quantisation distortion against every codebook and
classified to the argmin word.  Time structure is deliberately ignored —
the model is the fastest and smallest of the three families.

Device mapping:

* **Training is ONE jitted program for all words** (the round-1 HMM
  lesson: never compile/launch per word).  Frames are pooled per word
  into a padded ``[W, N_max, F]`` tensor with a validity mask; Lloyd
  iterations run batched over the word axis via `lax.fori_loop`, with
  assignment distances computed by one einsum per iteration.
  Deterministic init: codewords seeded from evenly strided valid frames
  (no RNG — results are reproducible by construction).
* **Scoring is one einsum**: ``[B,T,F] x [W,C,F] -> [B,T,W,C]`` min
  over codes, masked mean over valid frames -> ``[B, W]`` distortions.
  Empty-cluster update keeps the previous centroid (standard Lloyd
  fallback).
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig, VqConfig
from dsp_asr.ops import frontend as fe


def _sq_dists(x: jax.Array, cb: jax.Array,
              precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """[..., N, F] x [..., C, F] -> [..., N, C] squared distances."""
    cross = jnp.einsum("...nf,...cf->...nc", x, cb, precision=precision)
    xsq = jnp.sum(x * x, axis=-1)[..., :, None]
    csq = jnp.sum(cb * cb, axis=-1)[..., None, :]
    return jnp.maximum(xsq + csq - 2.0 * cross, 0.0)


def kmeans_fit(frames: jax.Array, mask: jax.Array, n_codes: int,
               n_iter: int) -> jax.Array:
    """Batched masked k-means: [W, N, F] + [W, N] -> codebooks [W, C, F].

    Deterministic strided init over each word's valid frames; Lloyd
    updates with empty-cluster carry-over.  Runs entirely on device.
    """
    w, n, f = frames.shape
    valid_counts = jnp.sum(mask, axis=1).astype(jnp.int32)      # [W]
    # strided init: index floor(i * n_valid / C) per word
    idx = (jnp.arange(n_codes)[None, :]
           * jnp.maximum(valid_counts - 1, 0)[:, None]
           // jnp.maximum(n_codes - 1, 1))                       # [W, C]
    init = jnp.take_along_axis(frames, idx[:, :, None], axis=1)  # [W, C, F]

    maskf = mask.astype(frames.dtype)[:, :, None]                # [W, N, 1]

    def body(_, cb):
        d = _sq_dists(frames, cb)                                # [W, N, C]
        assign = jnp.argmin(d, axis=-1)                          # [W, N]
        onehot = jax.nn.one_hot(assign, n_codes,
                                dtype=frames.dtype) * maskf      # [W, N, C]
        counts = jnp.sum(onehot, axis=1)                         # [W, C]
        # f32 matmul precision: bf16 or TF32 inputs round the centroid
        # sums ~1e-3 relative, so device-fitted codebooks would drift
        # from CPU fits
        # (same fit-precision rule as models/gmm_hmm.py)
        sums = jnp.einsum("wnc,wnf->wcf", onehot, frames,
                          precision=jax.lax.Precision.HIGHEST)
        new = sums / jnp.maximum(counts, 1.0)[:, :, None]
        return jnp.where(counts[:, :, None] > 0, new, cb)

    return jax.lax.fori_loop(0, n_iter, body, init)


def vq_distortion(feats: jax.Array, lengths: jax.Array, codebooks: jax.Array,
                  squared: bool = True,
                  precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """[B,T,F] queries vs [W,C,F] codebooks -> [B,W] mean distortions."""
    b, t, f = feats.shape
    d = _sq_dists(feats[:, None, :, :], codebooks[None, :, :, :],
                  precision)                                     # [B,W,T,C]
    dmin = jnp.min(d, axis=-1)                                   # [B,W,T]
    if not squared:
        dmin = jnp.sqrt(dmin)
    tmask = (jnp.arange(t)[None, :] < lengths[:, None]).astype(feats.dtype)
    num = jnp.einsum("bwt,bt->bw", dmin, tmask,
                     precision=jax.lax.Precision.HIGHEST)
    return num / jnp.maximum(lengths, 1).astype(feats.dtype)[:, None]


@functools.partial(jax.jit, static_argnames=("cfg", "squared"))
def _extract_and_distort(xs, ns, cb, mats, cfg, squared):
    """Module-level jitted extract+score so repeated sharded classify
    calls reuse one compiled program (ADVICE round 2: an @jax.jit defined
    inside the method retraced per call)."""
    feats = pl.extract_features(xs, ns, mats, cfg)
    return vq_distortion(feats.feats, feats.length, cb, squared)


class VqRecognizer:
    """Per-word VQ codebooks; classify by minimum mean distortion."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 vq: VqConfig = VqConfig(), mesh=None):
        self.cfg = cfg
        self.vq = vq
        self.mesh = mesh                # data-parallel scoring mesh
        self.mats = fe.make_matrices(cfg.frontend)
        self.labels: list[str] = []
        self._train_feats: dict[int, list[np.ndarray]] = {}  # id -> [Ti,F]
        self.codebooks: np.ndarray | None = None             # [W, C, F]

    # ------------------------------------------------------------- enroll
    def extract(self, signals) -> pl.Features:
        return pl.extract_signals(signals, self.mats, self.cfg)

    def enroll(self, label: str, signals) -> None:
        if label not in self.labels:
            self.labels.append(label)
        lid = self.labels.index(label)
        feats = self.extract(signals)
        f = np.asarray(feats.feats)
        l = np.asarray(feats.length)
        store = self._train_feats.setdefault(lid, [])
        for i in range(f.shape[0]):
            store.append(f[i, : max(int(l[i]), 1)])
        self.codebooks = None

    def fit(self, corpus: dict | None = None) -> None:
        """Build all codebooks in one jitted k-means program.

        ``corpus`` ({label: [signals]}) is optional sugar for enroll-all;
        call with no argument after manual `enroll` calls.
        """
        if corpus is not None:
            for lab, sigs in corpus.items():
                self.enroll(lab, sigs)
        if not self._train_feats:
            raise ValueError("no enrollment data")
        w = len(self.labels)
        pooled = [np.concatenate(self._train_feats[i], axis=0)
                  for i in range(w)]
        n_max = max(p.shape[0] for p in pooled)
        f = pooled[0].shape[1]
        frames = np.zeros((w, n_max, f), np.float32)
        mask = np.zeros((w, n_max), np.float32)
        for i, p in enumerate(pooled):
            frames[i, : p.shape[0]] = p
            mask[i, : p.shape[0]] = 1.0
        fit = jax.jit(kmeans_fit, static_argnames=("n_codes", "n_iter"))
        self.codebooks = np.asarray(
            fit(jnp.asarray(frames), jnp.asarray(mask),
                n_codes=self.vq.n_codes, n_iter=self.vq.n_iter))

    # ------------------------------------------------------------ classify
    def classify_batch(self, signals, return_distances: bool = False,
                       chunk: int = 256):
        """List of signals -> labels.  Chunked like KnnDtwRecognizer:
        the [B, W, T, C] distance intermediate scales with the batch, so
        large corpora must not go through one einsum."""
        if self.codebooks is None:
            self.fit()
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
        if self.mesh is not None:
            d = self._distortion_sharded(signals)
        else:
            feats = self.extract(signals)
            d = np.asarray(vq_distortion(feats.feats, feats.length,
                                         jnp.asarray(self.codebooks),
                                         self.vq.squared))
        got = [self.labels[int(i)] for i in d.argmin(axis=1)]
        return (got, d) if return_distances else got

    def classify_nbest(self, signals, n: int = 3):
        """Top-n label hypotheses per utterance: ``[[(label, distortion,
        weight)]]`` best-first (pipeline.nbest_from_scores over the
        per-codebook mean distortions; mesh-aware via classify_batch)."""
        if not len(signals):
            return []
        _, d = self.classify_batch(signals, return_distances=True)
        from dsp_asr import pipeline as pl
        return pl.nbest_from_scores(d, self.labels, n)

    def _distortion_sharded(self, signals) -> np.ndarray:
        """Data-parallel scoring: utterances shard over all mesh devices,
        codebooks replicate (embarrassingly parallel, zero collectives)."""
        import jax.sharding as shd

        from dsp_asr import parallel as par

        x, n = pl.pad_signals(signals, self.cfg.max_samples)
        nd = int(np.prod(list(self.mesh.shape.values())))
        x, b_orig = par.pad_axis_to_multiple(np.asarray(x), nd)
        n, _ = par.pad_axis_to_multiple(np.asarray(n), nd)
        n = np.maximum(n, 1)          # clamp AFTER padding: pad rows get n=1
        mesh1 = shd.Mesh(self.mesh.devices.reshape(-1), ("decode",))
        data = shd.NamedSharding(mesh1, shd.PartitionSpec("decode"))
        rep = shd.NamedSharding(mesh1, shd.PartitionSpec())
        xs, ns = jax.device_put(x, data), jax.device_put(n, data)
        cb = jax.device_put(jnp.asarray(self.codebooks), rep)
        return np.asarray(_extract_and_distort(
            xs, ns, cb, self.mats, self.cfg, self.vq.squared))[:b_orig]

    def classify_connected(self, signals, max_segments: int = 8):
        """Recordings of SEVERAL words -> one label list per recording.

        Connected-word decoding for the VQ family: the shared
        multi-segment VAD split (pipeline.decode_connected) feeds every
        segment through the same distortion matcher as
        ``classify_batch``.
        """
        if self.codebooks is None:
            self.fit()
        cb = jnp.asarray(self.codebooks)
        score = lambda flat: np.asarray(
            vq_distortion(flat.feats, flat.length, cb,
                          self.vq.squared)).argmin(-1)
        return pl.decode_connected(
            signals, self.mats, self.cfg, max_segments, score,
            lambda ids: [self.labels[int(i)] for i in ids])[0]

    def recognize(self, signal) -> str:
        return self.classify_batch([signal])[0]

    def evaluate(self, corpus: dict) -> dict:
        return pl.evaluate_corpus(self.classify_batch, corpus)

    # -------------------------------------------------------- checkpointing
    def save(self, path: str) -> None:
        if self.codebooks is None:
            self.fit()
        from dsp_asr.models.knn_dtw import frontend_signature
        np.savez(path, codebooks=self.codebooks,
                 labels=np.array(self.labels),
                 n_codes=self.vq.n_codes, n_iter=self.vq.n_iter,
                 squared=self.vq.squared,
                 frontend=json.dumps(frontend_signature(self.cfg)))

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig = PipelineConfig()):
        from dsp_asr.models.knn_dtw import check_frontend_signature
        data = np.load(path, allow_pickle=False)
        check_frontend_signature(data, cfg, path)
        vq = VqConfig(n_codes=int(data["n_codes"]),
                      n_iter=int(data["n_iter"]),
                      squared=bool(data["squared"]))
        rec = cls(cfg, vq)
        rec.labels = [str(x) for x in data["labels"]]
        rec.codebooks = np.asarray(data["codebooks"], np.float32)
        return rec
