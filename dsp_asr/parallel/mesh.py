"""Device mesh construction for the ('data', 'bank') layout.

The reference is single-process/single-core (SURVEY.md §2b: parallelism
ABSENT).  This framework scales along two axes:

* ``data`` — the utterance batch (pure data parallelism; no collectives
  until the final metrics reduction);
* ``bank`` — the template bank (the expert-parallel analog: each device
  holds a vocabulary shard and classification ends in a tiny cross-shard
  argmin over the interconnect).

TP/PP/SP have no counterpart in this workload and are intentionally
absent (SURVEY.md §2b); the sequence axis shards trivially through the
streaming front-end instead.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
BANK_AXIS = "bank"


def make_mesh(data: int | None = None, bank: int | None = None,
              devices=None) -> Mesh:
    """Build a ('data', 'bank') mesh.

    With no arguments, uses all local devices and puts them on the bank
    axis (vocabulary sharding is the axis that reduces per-chip work for
    the dominant DTW cost).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None and bank is None:
        data, bank = 1, n
    elif data is None:
        data = n // bank
    elif bank is None:
        bank = n // data
    # data/bank can round to 0 when one axis exceeds the device count —
    # require both >= 1 so a misconfiguration fails HERE, not as a
    # confusing empty-placement error downstream
    if data < 1 or bank < 1 or data * bank > n:
        raise ValueError(f"mesh {data}x{bank} invalid for {n} devices")
    arr = np.asarray(devices[: data * bank]).reshape(data, bank)
    return Mesh(arr, (DATA_AXIS, BANK_AXIS))


def shard_queries(mesh: Mesh, *arrays):
    """Place query-batch arrays with the batch dim on the data axis."""
    out = tuple(
        jax.device_put(a, NamedSharding(mesh, P(DATA_AXIS, *([None] * (a.ndim - 1)))))
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def shard_bank(mesh: Mesh, *arrays):
    """Place template-bank arrays with the bank dim on the bank axis."""
    out = tuple(
        jax.device_put(a, NamedSharding(mesh, P(BANK_AXIS, *([None] * (a.ndim - 1)))))
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, *arrays):
    out = tuple(jax.device_put(a, NamedSharding(mesh, P())) for a in arrays)
    return out if len(out) > 1 else out[0]


def pad_axis_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple (returns padded, orig_size)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n
