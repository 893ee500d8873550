"""Context parallelism: KV sharded along the sequence dimension.

Head parallelism (parallel/tp.py) tops out at n_kv_head chips; for long
contexts the sequence itself must shard.  Two mechanisms, both written
to run inside shard_map over a context axis:

  - `ring_attention`: prefill.  Each chip owns a query block and a KV
    block; KV blocks rotate around the ring via `jax.lax.ppermute`, one
    hop per step, while each chip folds the visiting block into its
    online-softmax state.  Communication is neighbor-to-neighbor and
    overlaps compute; total traffic equals one all-gather but never
    materializes the full KV anywhere.

  - `decode_attend_cp`: decode.  The single query attends to every
    shard's KV; each chip computes a partial flash-decode with softmax
    statistics (m, l) over its local shard, then the partials merge with
    the cross-chip online-softmax correction (pmax + psum) — O(Dh)
    communicated per head instead of the KV cache.

This is the "sequence/context parallel" capability absent from the
reference (ctx hard-capped at 512, one device —
/root/reference/th-llama.cpp:19, SURVEY.md §2.6).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

_MASK = -0.7 * float(jnp.finfo(jnp.float32).max)


def _block_attend_stats(q, k, v, mask):
    """softmax-attend q to (k, v) under mask, returning (o*l, m, l).

    q [B, H, T, Dh], k/v [B, Hkv, S, Dh], mask [B, T, S] broadcastable.
    Outputs: o_unnorm [B, H, T, Dh], m [B, H, T, 1], l [B, H, T, 1].
    """
    B, H, T, Dh = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, T, Dh).astype(jnp.float32)
    s = jnp.einsum("bhrtd,bhsd->bhrts", qg, k.astype(jnp.float32))
    s = jnp.where(mask[:, None, None, :, :], s, _MASK)
    m = jnp.max(s, axis=-1, keepdims=True)  # [B, Hkv, rep, T, 1]
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum("bhrts,bhsd->bhrtd", p, v.astype(jnp.float32))
    return (
        o.reshape(B, H, T, Dh),
        m.reshape(B, H, T, 1),
        l.reshape(B, H, T, 1),
    )


def _merge_stats(o1, m1, l1, o2, m2, l2):
    """Combine two unnormalized softmax partials (online-softmax merge)."""
    m = jnp.maximum(m1, m2)
    a1 = jnp.exp(m1 - m)
    a2 = jnp.exp(m2 - m)
    return o1 * a1 + o2 * a2, m, l1 * a1 + l2 * a2


def ring_attention(
    q_local: jax.Array,  # [B, H, T_local, Dh] queries of this shard's block
    k_local: jax.Array,  # [B, Hkv, T_local, Dh]
    v_local: jax.Array,
    axis_name: str,
    n_shards: int,
    scale: Optional[float] = None,
    layout: str = "block",
) -> jax.Array:
    """Causal ring attention (call inside shard_map over `axis_name`).

    layout "block":  shard i's queries sit at global positions
                     [i*T, (i+1)*T) (contiguous blocks in axis order).
    layout "cyclic": shard i owns positions {i, i+n, i+2n, ...} — the
                     interleave parallel/cp.py uses so decode appends
                     land round-robin on shards (even load, O(1) writes).
    """
    B, H, T, Dh = q_local.shape
    if scale is None:
        scale = 1.0 / (Dh**0.5)
    idx = jax.lax.axis_index(axis_name)
    q = q_local.astype(jnp.float32) * scale

    def pos_of(shard):
        if layout == "cyclic":
            return shard + jnp.arange(T) * n_shards
        return shard * T + jnp.arange(T)

    def step_stats(src, k_blk, v_blk):
        """One ring step's softmax partials (o_unnorm, m, l)."""
        kpos = pos_of(src)  # [T]
        mask = kpos[None, None, :] <= qpos[None, :, None]  # [1, T, T]
        return _block_attend_stats(
            q, k_blk, v_blk, jnp.broadcast_to(mask, (B, T, T))
        )

    qpos = pos_of(idx)  # [T]
    o = jnp.zeros((B, H, T, Dh), jnp.float32)
    m = jnp.full((B, H, T, 1), -jnp.inf, jnp.float32)
    l = jnp.zeros((B, H, T, 1), jnp.float32)

    k_blk, v_blk = k_local, v_local
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    for step in range(n_shards):
        src = (idx - step) % n_shards  # owner of the visiting KV block
        o_b, m_b, l_b = step_stats(src, k_blk, v_blk)
        o, m, l = _merge_stats(o, m, l, o_b, m_b, l_b)
        if step < n_shards - 1:
            k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
            v_blk = jax.lax.ppermute(v_blk, axis_name, perm)

    l_safe = jnp.where(l == 0.0, 1.0, l)
    return (o / l_safe).astype(q_local.dtype)


def decode_attend_cp(
    q: jax.Array,  # [B, H, Dh] replicated single-token queries
    k_shard: jax.Array,  # [B, Hkv, S_local, Dh] this shard's KV slots
    v_shard: jax.Array,
    shard_lengths: jax.Array,  # [B] valid slots in THIS shard
    axis_name: str,
    scale: Optional[float] = None,
) -> jax.Array:
    """Decode attention over sequence-sharded KV (inside shard_map).

    Each shard masks beyond its own `shard_lengths`; the partials merge
    with pmax/psum.  A shard with zero valid slots contributes l=0.
    """
    B, H, Dh = q.shape
    S = k_shard.shape[2]
    if scale is None:
        scale = 1.0 / (Dh**0.5)

    qf = q.astype(jnp.float32)[:, :, None, :] * scale  # [B, H, 1, Dh]
    slot = jnp.arange(S)[None, None, :]  # [1, 1, S]
    mask = slot < shard_lengths[:, None, None]  # [B, 1, S]
    o, m, l = _block_attend_stats(qf, k_shard, v_shard, mask)

    # Fully-masked rows give p = exp(MASK - MASK) = 1 per slot; zero
    # empty shards to the merge identity.
    empty = (shard_lengths == 0)[:, None, None, None]
    o = jnp.where(empty, 0.0, o)
    l = jnp.where(empty, 0.0, l)
    m = jnp.where(empty, -jnp.inf, m)

    m_g = jax.lax.pmax(m, axis_name)
    alpha = jnp.where(jnp.isinf(m) & (m < 0), 0.0, jnp.exp(m - m_g))
    o_g = jax.lax.psum(o * alpha, axis_name)
    l_g = jax.lax.psum(l * alpha, axis_name)
    l_safe = jnp.where(l_g == 0.0, 1.0, l_g)
    return (o_g / l_safe)[:, :, 0, :].astype(q.dtype)
