"""RMSNorm (fused with its gain).

The reference splits the norm and the gain into two kernels
(`cmdbuf_rms_norm` /root/reference/th.cpp:1202-1296 then
`cmdbuf_row_element_multiply` /root/reference/th.cpp:1329-1449);
under jit XLA fuses both into one elementwise expression.  Statistics in f32
regardless of activation dtype; eps matches the reference's 1e-6
(/root/reference/th.cpp:1184).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rms_norm(x: jax.Array, gain: jax.Array, eps: float = 1e-6) -> jax.Array:
    x32 = x.astype(jnp.float32)
    ms = jnp.mean(x32 * x32, axis=-1, keepdims=True)
    y = x32 * jax.lax.rsqrt(ms + eps)
    return (y * gain.astype(jnp.float32)).astype(x.dtype)
