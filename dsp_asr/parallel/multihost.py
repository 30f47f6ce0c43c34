"""Multi-host execution support (SURVEY.md §2b / §5).

A GPU cluster spanning several hosts runs this framework SPMD: every
host executes the same program, `jax.distributed.initialize()` wires the
hosts into one runtime, and the ('data','bank') mesh then spans the
global device set.  Failure policy is fail-fast (documented non-goal:
no elastic recovery) — if a host dies, the collective times out and the
job must be restarted.

Typical use:

    from dsp_asr.parallel import multihost, make_mesh
    multihost.initialize()                  # no-op on a single host
    mesh = make_mesh()                      # all global devices on 'bank'
    ...
    metrics = multihost.all_hosts_agree(local_metrics)
"""

from __future__ import annotations

import os

import jax
import numpy as np

from dsp_asr.utils.logging import get_logger

log = get_logger("dsp_asr.multihost")

_initialized = False        # idempotency: initialize() is call-once

# environment variables through which jax.distributed's auto-detection
# finds a cluster: its own coordinator variable, then the launchers
# (Slurm, Open MPI) it recognises
CLUSTER_MARKERS = ("JAX_COORDINATOR_ADDRESS", "SLURM_JOB_ID",
                   "OMPI_MCA_orte_hnp_uri")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialise the multi-host runtime (no-op for single-process runs).

    With no arguments, relies on the cluster auto-detection of
    `jax.distributed.initialize` (``CLUSTER_MARKERS``); arguments are
    passed through for manual clusters.
    """
    global _initialized
    if _initialized:
        return
    if num_processes == 1:
        # explicit single-process run: nothing to wire up
        log.info("single-process run; distributed init skipped")
        return
    if coordinator_address is None and num_processes is None:
        # Auto-detection path.  jax.distributed.initialize must run
        # BEFORE anything initialises the XLA backend, so do NOT probe
        # jax.process_count() first (it initialises the backend and the
        # subsequent initialize() call then raises).
        try:
            jax.distributed.initialize()
        except Exception as e:
            # On a box with no cluster markers this is the normal
            # single-process path (INFO).  But when the environment SAYS
            # multi-host, a failed init is a misconfiguration degrading
            # to a silent 1-process run — warn loudly.
            markers = [v for v in CLUSTER_MARKERS if os.environ.get(v)]
            if markers:
                log.warning(
                    "distributed auto-init FAILED (%s) although multi-host "
                    "env markers are set (%s) — this looks like a cluster "
                    "misconfiguration; continuing as a SINGLE-process run, "
                    "which will silently compute on 1/N of the data",
                    e, ", ".join(markers))
            else:
                log.info("distributed auto-init unavailable (%s); "
                         "single-process run", e)
            return
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    _initialized = True
    log.info("distributed: process %d/%d, %d global devices",
             jax.process_index(), jax.process_count(),
             len(jax.devices()))


def is_primary() -> bool:
    """True on the host that should write checkpoints / print reports."""
    return jax.process_index() == 0


def all_hosts_agree(value: float, atol: float = 0.0) -> bool:
    """Cross-host consistency check for replicated scalars (e.g. accuracy).

    Compares the global min against the global max — unlike a mean test
    this cannot be fooled by disagreements that average out.
    """
    lo, hi = _min_max_across_hosts(value)
    return bool(abs(hi - lo) <= atol + 1e-9 * abs(value))


def jnp_mean_across_hosts(value: float) -> float:
    """Mean of a per-host scalar over all global devices."""
    import jax.numpy as jnp

    return float(jnp.mean(_global_scalar_array(value)))


def _min_max_across_hosts(value: float):
    import jax.numpy as jnp

    arr = _global_scalar_array(value)
    return float(jnp.min(arr)), float(jnp.max(arr))


def _global_scalar_array(value: float):
    """One f32 per local device, assembled into a global device array.

    Built with `jax.make_array_from_process_local_data` so multi-process
    runs contribute only their addressable shards (a process-local
    jnp.full over a global mesh is rejected by shard_map there).
    """
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = np.asarray(jax.devices())
    mesh = Mesh(devices.reshape(-1), ("all",))
    sharding = NamedSharding(mesh, P("all"))
    local = np.full((len(jax.local_devices()),), float(value),
                    dtype=np.float32)
    arr = jax.make_array_from_process_local_data(
        sharding, local, global_shape=(len(devices),))
    return jnp.asarray(arr)
