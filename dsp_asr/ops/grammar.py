"""Finite-state word grammars for connected-word decoding.

Classical connected-word recognizers constrain the word sequence with a
syntax network — Rabiner & Juang's level building "with syntactic
constraints": which words may START an utterance, which word PAIRS may
follow each other, and which words may END it.  The reference's scope
(SURVEY.md §1a L1, isolated/connected digits) implies the loop grammar
(anything can follow anything); this module adds the general word-pair
case as the natural batched extension: the constraint enters the joint DP
as a ``[K, K]`` boolean mask on the inter-level transition
(ops/level_building.py:level_build_grammar — one masked min reduction
per level, still fully batched), NOT as host-side sequence filtering.

A :class:`Grammar` is defined over LABELS (words).  The template bank
stores several templates per label and the HMM family one model per
label, so decoders compile the label-level grammar down to unit-level
masks with :meth:`Grammar.unit_masks` (units = templates or word HMMs).

Spec format (JSON file or dict, see :meth:`Grammar.from_spec`)::

    {
      "start":     ["one", "two"] | "*",          # allowed first words
      "end":       ["stop"] | "*",                # allowed last words
      "pairs":     [["one", "two"], ["two", "*"]],# allow-list (u -> v)
      "forbidden": [["one", "one"]],              # deny-list, wins
      "no_repeat": true                           # forbid w -> w
    }

Omitted keys allow everything; ``"*"`` is a wildcard on either side of
a pair.  ``pairs`` (if present) REPLACES the all-allowed default;
``no_repeat`` and ``forbidden`` then subtract from it, in that order.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


def _as_list(x):
    return [x] if isinstance(x, str) else list(x)


@dataclasses.dataclass(frozen=True)
class Grammar:
    """Word-pair grammar over a label vocabulary.

    ``pairs[u, v]`` = label ``u`` may be FOLLOWED by label ``v``;
    ``start``/``end`` mark the allowed first/last words.  Arrays are
    host numpy bools — decoders pass the compiled unit-level masks into
    jit as ordinary (traced) arguments, so changing the grammar never
    recompiles.
    """

    labels: tuple
    start: np.ndarray           # [V] bool
    pairs: np.ndarray           # [V, V] bool
    end: np.ndarray             # [V] bool

    # -- constructors ---------------------------------------------------
    @classmethod
    def loop(cls, labels) -> "Grammar":
        """The unconstrained grammar: any word anywhere (the default
        connected-digits syntax)."""
        v = len(labels)
        return cls(tuple(labels), np.ones(v, bool),
                   np.ones((v, v), bool), np.ones(v, bool))

    @classmethod
    def no_repeat(cls, labels) -> "Grammar":
        """Loop grammar minus immediate repetitions (w -> w forbidden)."""
        g = cls.loop(labels)
        p = g.pairs.copy()
        np.fill_diagonal(p, False)
        return dataclasses.replace(g, pairs=p)

    @classmethod
    def from_spec(cls, spec: dict, labels) -> "Grammar":
        """Build from the JSON-able dict format (module docstring)."""
        labels = tuple(labels)
        index = {w: i for i, w in enumerate(labels)}
        v = len(labels)

        def resolve(side) -> np.ndarray:
            # one side of a pair / a start-end list -> [V] bool
            mask = np.zeros(v, bool)
            for w in _as_list(side):
                if w == "*":
                    mask[:] = True
                elif w in index:
                    mask[index[w]] = True
                else:
                    raise ValueError(
                        f"grammar references unknown word {w!r} "
                        f"(vocabulary: {', '.join(labels)})")
            return mask

        start = resolve(spec.get("start", "*"))
        end = resolve(spec.get("end", "*"))
        if "pairs" in spec:
            pairs = np.zeros((v, v), bool)
            for u, w in spec["pairs"]:
                pairs |= np.outer(resolve(u), resolve(w))
        else:
            pairs = np.ones((v, v), bool)
        if spec.get("no_repeat", False):
            np.fill_diagonal(pairs, False)
        for u, w in spec.get("forbidden", ()):
            pairs &= ~np.outer(resolve(u), resolve(w))
        return cls(labels, start, pairs, end)

    @classmethod
    def load(cls, path: str, labels) -> "Grammar":
        """Read a JSON spec file (module docstring format)."""
        with open(path) as f:
            return cls.from_spec(json.load(f), labels)

    # -- compilation ----------------------------------------------------
    def unit_masks(self, unit_label_ids):
        """Label-level grammar -> unit-level masks.

        ``unit_label_ids [K]`` maps each decode unit (bank template /
        word HMM) to its label index in ``self.labels``.  Returns
        ``(start [K], pairs [K, K], end [K])`` boolean numpy arrays —
        a template pair is allowed iff its LABEL pair is (templates of
        the same word are interchangeable under the syntax).
        """
        ids = np.asarray(unit_label_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.labels)):
            raise ValueError("unit label id outside the grammar vocabulary")
        return (self.start[ids], self.pairs[np.ix_(ids, ids)],
                self.end[ids])

    def describe(self) -> str:
        """One-line human summary (for logs / serve banner)."""
        v = len(self.labels)
        return (f"grammar over {v} words: {int(self.start.sum())} start, "
                f"{int(self.pairs.sum())}/{v * v} pairs, "
                f"{int(self.end.sum())} end")
