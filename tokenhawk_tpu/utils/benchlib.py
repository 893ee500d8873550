"""Device memory stream probe: the yardstick beside the published peak.

A roofline share against the data-sheet bandwidth says how far a kernel
is from the card's promise; a share of what a plain read stream reaches
on the same card, in the same process, says how far it is from what the
card delivers today.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def hbm_stream_gbps(nbytes: int = 1 << 31, iters: int = 20,
                    trials: int = 5) -> float:
    """Achieved read bandwidth (GB/s) of a plain XLA reduction over a
    `nbytes` bf16 array.

    The array is re-read `iters` times inside one jitted program (a
    fori_loop whose carry feeds each pass, so XLA cannot hoist it); the
    sum is a fused reduction, so the only device-memory traffic is the
    read.  Timed with block_until_ready around warmed calls; the median
    of `trials` is returned."""
    cols = 1 << 14
    rows = max(1, int(nbytes) // (2 * cols))
    x = jnp.ones((rows, cols), jnp.bfloat16)
    actual_bytes = rows * cols * 2

    @jax.jit
    def stream(x):
        def body(_, acc):
            y = x + acc.astype(x.dtype)
            return acc + jnp.sum(y, dtype=jnp.float32) * 1e-30

        return jax.lax.fori_loop(0, iters, body, jnp.float32(0))

    jax.block_until_ready(stream(x))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(stream(x))
        times.append(time.perf_counter() - t0)
    per_pass = sorted(times)[len(times) // 2] / iters
    return actual_bytes / per_pass / 1e9
