"""Int8 KV-cache quantization.

Each cached K/V vector quantizes per (sequence, head, token) over the
head dimension: int8 payload + one bf16 scale.  Halves KV memory traffic at
long context versus bf16 (the decode KV read grows linearly with n_past
while weights stay constant).

Scale layout: `[..., S]` — one scale per token, with the TOKEN axis
innermost, so a score-space fold (`q.(k_i8*ksc)^T == (q.k_i8^T) *
ksc_row`) consumes the scales as one row vector.  Storage overhead: 2B
per 128B int8 payload = 1.6%.  Attention over int8 caches is plain XLA
(dequantize, then attend); an int8-KV decode kernel is future work.

Opt-in: engine integration is cache_dtype="int8"; this module provides
the codec, the jnp reference attention, and the cache-update paths, all
tested against the bf16 path (tests/test_kvquant.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def quantize_kv_block(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[..., Dh] f32/bf16 -> (int8 [..., Dh], scales bf16 [...])."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scale = amax / 127.0
    inv = jnp.where(scale > 0, 1.0 / jnp.where(scale > 0, scale, 1.0), 0.0)
    q = jnp.clip(jnp.round(xf * inv), -127, 127).astype(jnp.int8)
    return q, scale[..., 0].astype(jnp.bfloat16)


def dequantize_kv(q: jax.Array, scales: jax.Array) -> jax.Array:
    """(int8 [..., Dh], scales [...]) -> f32 [..., Dh]."""
    return q.astype(jnp.float32) * scales[..., None].astype(jnp.float32)


def update_kv_cache_int8(
    k_cache: jax.Array,  # int8 [B, Hkv, S, Dh]
    ks_cache: jax.Array,  # bf16 [B, Hkv, S]
    v_cache: jax.Array,
    vs_cache: jax.Array,
    k_new: jax.Array,  # [B, T, Hkv, Dh] (bf16/f32)
    v_new: jax.Array,
    offsets: jax.Array,  # [B]
):
    """Quantize a new block and write it at each sequence's offset.

    Decode (T == 1) uses a static-unrolled chain of scalar-start
    dynamic_update_slices so the writes alias in place on the donated
    cache (vmap lowers to scatter = whole-cache rewrite per step, a
    cost that grows with the context; same fix as the bf16 path)."""
    kq, ks = quantize_kv_block(jnp.swapaxes(k_new, 1, 2))  # [B, Hkv, T, *]
    vq, vs = quantize_kv_block(jnp.swapaxes(v_new, 1, 2))

    if k_new.shape[1] == 1:  # decode
        B = k_cache.shape[0]
        for b in range(B):
            at = (b, 0, offsets[b], 0)
            k_cache = jax.lax.dynamic_update_slice(
                k_cache, kq[b][None].astype(k_cache.dtype), at)
            ks_cache = jax.lax.dynamic_update_slice(
                ks_cache, ks[b][None].astype(ks_cache.dtype), at[:3])
            v_cache = jax.lax.dynamic_update_slice(
                v_cache, vq[b][None].astype(v_cache.dtype), at)
            vs_cache = jax.lax.dynamic_update_slice(
                vs_cache, vs[b][None].astype(vs_cache.dtype), at[:3])
        return k_cache, ks_cache, v_cache, vs_cache

    def upd(cache, new, off):
        return jax.lax.dynamic_update_slice(
            cache, new.astype(cache.dtype), (0, off, 0)
        )

    def upd_s(cache, new, off):
        return jax.lax.dynamic_update_slice(
            cache, new.astype(cache.dtype), (0, off)
        )

    k_cache = jax.vmap(upd)(k_cache, kq, offsets)
    ks_cache = jax.vmap(upd_s)(ks_cache, ks, offsets)
    v_cache = jax.vmap(upd)(v_cache, vq, offsets)
    vs_cache = jax.vmap(upd_s)(vs_cache, vs, offsets)
    return k_cache, ks_cache, v_cache, vs_cache


def attend_cache_int8(
    q: jax.Array,  # [B, T, H, Dh]
    k_cache: jax.Array,  # int8 [B, Hkv, S, Dh]
    ks_cache: jax.Array,  # bf16 [B, Hkv, S]
    v_cache: jax.Array,
    vs_cache: jax.Array,
    q_positions: jax.Array,  # [B, T]
    scale: float | None = None,
) -> jax.Array:
    """Reference attention over the quantized cache (XLA path)."""
    from tokenhawk_tpu.ops.attention import attend_cache

    k = dequantize_kv(k_cache, ks_cache)
    v = dequantize_kv(v_cache, vs_cache)
    return attend_cache(q, k, v, q_positions, scale=scale)
