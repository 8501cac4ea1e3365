"""Multi-host execution glue.

The reference scales across machines by running module processes against a
shared filesystem (SURVEY.md §2.5 "multi-node"); the device equivalents
are (a) that same module workflow — every `kmtricks_tpu` subcommand works
against a shared run directory — and (b) a jax.distributed mesh where the
fused pipeline's all_to_all rides the interconnect instead of files.

Each process calls :func:`initialize`, builds the global mesh, and feeds
its process-local shard of the read batches; `build_sharded_pipeline`
handles the rest — the in/out specs are GLOBAL shapes, jax splits them
over processes.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op if already initialized or single
    process). GPU hosts detect nothing: every process passes the same
    ``coordinator_address`` (``host:port`` of process 0), the
    ``num_processes`` and its own ``process_id``."""
    try:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
    except RuntimeError:
        pass   # already initialized
    except ValueError:
        # nothing to auto-detect: single process with no coordinator —
        # the documented no-op case (reached when jax backends have not
        # been touched yet, e.g. a fresh test worker)
        pass


def global_mesh(axis: str = "d") -> Mesh:
    """1-D mesh over every device of every host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_shard_bounds(total_rows: int, mesh: Mesh) -> tuple[int, int]:
    """Row range of the global batch this process must provide (data
    parallelism over hosts: rows are sharded over the mesh axis, devices
    are grouped per host)."""
    nproc = jax.process_count()
    per = total_rows // nproc
    i = jax.process_index()
    return i * per, (i + 1) * per if i + 1 < nproc else total_rows


def make_global_batch(local_rows: np.ndarray, mesh: Mesh, axis: str = "d",
                      spec: P | None = None):
    """Assemble a globally-sharded device array from per-host local rows
    (jax.make_array_from_process_local_data). ``spec`` overrides the
    default row sharding — pass ``P(None, axis)`` for transposed (L, B)
    batches (batch_layout="lb")."""
    sharding = NamedSharding(mesh, P(axis) if spec is None else spec)
    return jax.make_array_from_process_local_data(sharding, local_rows)


def replicated(value: np.ndarray, mesh: Mesh):
    """Fully-replicated global array (every process passes the same
    value — repartition tables, threshold vectors)."""
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_process_local_data(sharding, value)
