"""Multi-host runtime orchestration.

The reference is strictly one GPU, one process (SURVEY.md §2.6).  For
N>=2 hosts (several GPU hosts) this module wires
`jax.distributed.initialize` and builds the global (data, model) mesh
over all hosts' devices.  Weights load host-locally through
`runtime.sharded_loader.load_model_sharded`: each weight is a
`jax.make_array_from_callback` whose callback decodes only the mmap
byte ranges of the requesting shard, so a host materializes 1/tp of the
model (70B memory math in that module's docstring).

Collectives over "model" are the heavy per-layer all-reduces: keep tp
within a host, whose cards share NVLink, and put "data" across hosts,
whose network is much slower.

This module is exercised via the single-process virtual mesh in the
tests; the code paths are the standard JAX multi-controller idioms and
activate when run under a real multi-host launcher (one process per
host, with `coordinator_address`, `num_processes` and `process_id`
given explicitly).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from tokenhawk_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the JAX multi-controller runtime (idempotent).

    On GPU hosts pass `coordinator_address`, `num_processes` and
    `process_id`: nothing on a plain host tells JAX of a cluster.  With
    no args a single process carries on uninitialized.
    """
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:  # single-process / already up
        if "already" not in str(e).lower() and num_processes not in (None, 1):
            raise


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None) -> Mesh:
    """(data, model) mesh over every device of every host.

    Defaults: tp = devices per host (TP over a host's NVLink), dp =
    number of hosts (DP across the network between hosts) — the layout
    that keeps the heavy psums on NVLink.
    """
    devices = jax.devices()
    n = len(devices)
    per_host = max(1, n // max(jax.process_count(), 1))
    if tp is None:
        tp = per_host
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    grid = np.asarray(devices).reshape(dp, tp)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def host_local_slice(total: int, axis_shards: int) -> Sequence[slice]:
    """Row ranges each shard owns when splitting `total` into axis_shards."""
    per = total // axis_shards
    return [slice(i * per, (i + 1) * per) for i in range(axis_shards)]
