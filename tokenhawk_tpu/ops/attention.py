"""Attention over a dense KV cache (plain XLA).

Replaces the reference's materialized scores + masked/row softmax
pipeline (/root/reference/th-llama.cpp:361-380: Q·K^T via `mat_mul`,
`masked_softmax`/`row_softmax`, probs·V) with a single jnp expression.
It serves prefill, the CLI engine's dense-cache decode and the paged
fallbacks; paged decode on the GPU takes ops/pallas/paged_attention.py.

Supports GQA: queries have H heads, cache has Hkv heads, H % Hkv == 0.
Mask semantics: query at absolute position p attends to cache slots with
position <= p; slots beyond the write frontier are masked by that same
condition because the current block is written to the cache *before*
attention runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def attend_cache(
    q: jax.Array,  # [B, T, H, Dh] (already RoPE'd)
    k_cache: jax.Array,  # [B, Hkv, S, Dh]
    v_cache: jax.Array,  # [B, Hkv, S, Dh]
    q_positions: jax.Array,  # [B, T] absolute positions of the queries
    scale: float | None = None,
) -> jax.Array:
    """Causal attention of a query block against the full cache.

    Cache layout is head-major [B, Hkv, S, Dh].  Operands are the cache
    dtype (bf16 in serving) with f32 accumulation and an f32 softmax.
    """
    B, T, H, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / (Dh**0.5)

    # Queries grouped by KV head as [B, Hkv, rep*T, Dh]: both dots are
    # plain batched matmuls over (B, Hkv).  Operands stay in the cache
    # dtype (no f32 copy of the cache); the dots accumulate in f32.
    qg = (q * scale).astype(k_cache.dtype).reshape(B, T, Hkv, rep, Dh)
    qg = qg.transpose(0, 2, 3, 1, 4).reshape(B, Hkv, rep * T, Dh)
    scores = jnp.einsum("bhmd,bhsd->bhms", qg, k_cache,
                        preferred_element_type=jnp.float32)
    scores = scores.reshape(B, Hkv, rep, T, S)

    key_pos = jnp.arange(S)[None, None, :]  # [1, 1, S]
    mask = key_pos <= q_positions[:, :, None]  # [B, T, S]
    scores = jnp.where(mask[:, None, None, :, :], scores, _MASK_VALUE)

    probs = jax.nn.softmax(scores, axis=-1).astype(v_cache.dtype)
    ctx = jnp.einsum("bhms,bhsd->bhmd", probs.reshape(B, Hkv, rep * T, S),
                     v_cache, preferred_element_type=jnp.float32)
    ctx = ctx.reshape(B, Hkv, rep, T, Dh).transpose(0, 3, 1, 2, 4)
    return ctx.reshape(B, T, H, Dh).astype(q.dtype)


def update_kv_cache(
    k_cache: jax.Array,  # [B, Hkv, S, Dh]
    v_cache: jax.Array,
    k_new: jax.Array,  # [B, T, Hkv, Dh]
    v_new: jax.Array,
    offsets: jax.Array,  # [B] write offsets
):
    """Write a new block into each sequence's cache at its offset.

    For decode (T == 1) this is a fori_loop of scalar-start
    dynamic_update_slices rather than vmap (which lowers to scatter): a
    chain of dus on a donated buffer aliases in place, keeping the
    per-step cache write O(1) instead of a whole-cache rewrite, which
    keeps decode cost independent of the cache length.
    Prefill blocks (T > 1) keep the vmap/scatter form: the write is
    amortized over T tokens, and the fori+dus pattern at prefill shapes
    trips an XLA copy-insertion RET_CHECK (b/large-block while fusion).
    """
    k_new = jnp.swapaxes(k_new.astype(k_cache.dtype), 1, 2)  # [B, Hkv, T, Dh]
    v_new = jnp.swapaxes(v_new.astype(v_cache.dtype), 1, 2)
    B = k_cache.shape[0]
    T = k_new.shape[2]

    if T == 1:
        # Static unroll over B (a fori_loop/while here trips an XLA
        # copy-insertion RET_CHECK at B > 1); a plain chain of dus ops
        # aliases in place on the donated cache.
        kc, vc = k_cache, v_cache
        for b in range(B):
            kc = jax.lax.dynamic_update_slice(
                kc, k_new[b][None], (b, 0, offsets[b], 0)
            )
            vc = jax.lax.dynamic_update_slice(
                vc, v_new[b][None], (b, 0, offsets[b], 0)
            )
        return kc, vc

    def upd(cache, new, off):
        return jax.lax.dynamic_update_slice(cache, new, (0, off, 0))

    k_cache = jax.vmap(upd)(k_cache, k_new, offsets)
    v_cache = jax.vmap(upd)(v_cache, v_new, offsets)
    return k_cache, v_cache
