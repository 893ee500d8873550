"""Device mesh construction.

Axes:
  "data"  — batch/data parallelism (continuous-batching shards requests)
  "model" — tensor parallelism (attention heads + FFN columns + vocab)
  "ctx"   — context parallelism (KV cache sharded along the sequence;
            see parallel/cp.py)

The reference has no multi-device layer at all (SURVEY.md §2.6); its
k-way split-GEMV + local reduce (th.cpp:3795-3912, :4042-4127) is the
one-device seed of exactly this "model" axis — here the splits live on
different cards and the reduce is an XLA psum (NCCL over NVLink).  The
cards of a host are joined all to all, so a mesh is a plain reshape of
`jax.devices()` and its shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
CTX_AXIS = "ctx"
STAGE_AXIS = "stage"


def make_pp_mesh(
    dp: int = 1, pp: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a (data, stage) mesh for pipeline parallelism (parallel/pp.py).

    The stage axis is the one mesh axis meant to cross hosts: stage
    boundaries exchange only [B, T, D] activations per hop (vs TP's
    per-layer all-reduces), the classic multi-host cut for models too
    big for one host's cards (SURVEY §2.6, 70B config)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if pp is None:
        if n % dp:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        pp = n // dp
    if dp * pp > n:
        raise ValueError(f"dp*pp={dp * pp} exceeds {n} devices")
    grid = np.asarray(devices[: dp * pp]).reshape(dp, pp)
    return Mesh(grid, (DATA_AXIS, STAGE_AXIS))


def make_cp_mesh(
    dp: int = 1, cp: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a (data, ctx) mesh for context parallelism."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if cp is None:
        if n % dp:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        cp = n // dp
    if dp * cp > n:
        raise ValueError(f"dp*cp={dp * cp} exceeds {n} devices")
    grid = np.asarray(devices[: dp * cp]).reshape(dp, cp)
    return Mesh(grid, (DATA_AXIS, CTX_AXIS))


def make_mesh(
    dp: int = 1, tp: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a (data, model) mesh. tp=None uses all remaining devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if tp is None:
        if n % dp:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        tp = n // dp
    if dp * tp > n:
        raise ValueError(f"dp*tp={dp * tp} exceeds {n} devices")
    grid = np.asarray(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(dp=1, tp=1)
