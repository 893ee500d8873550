"""LLaMA-family model as pure functions over a parameter pytree.

This is the JAX redesign of the reference's model layer
(/root/reference/th-llama.cpp:270-452 `build_layer_cmdbuf` and
:240-268 `build_final_compute_cmdbuf`): instead of encoding 19 pipeline
dispatches per layer into a command buffer, the whole forward pass is one
traced XLA program — `lax.scan` over stacked layer weights, KV-cache
updates via dynamic_update_slice on donated buffers, and every matmul
routed through `ops.matmul` (dense bf16 or dequantizing quantized).

Weight orientation: GGML stores [out, in] and computes y = x·W^T
(/root/reference/th.cpp:2839-2892 contracts B's columns); here weights
are [in, out] so y = x @ W contracts directly.

GGML tensor names follow the reference loader
(/root/reference/th-llama-loader.cpp:355-432): tok_embeddings.weight,
layers.{i}.attention.{wq,wk,wv,wo}.weight, layers.{i}.attention_norm.weight,
layers.{i}.feed_forward.{w1,w2,w3}.weight, layers.{i}.ffn_norm.weight,
norm.weight, output.weight.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.ggml.quants import QuantizedTensor, dequantize
from tokenhawk_tpu.ops import (
    ArrayOrQ,
    QWeight,
    apply_rope,
    attend_cache,
    from_quantized_tensor,
    matmul,
    rope_cos_sin,
    update_kv_cache,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LayerParams:
    wq: Optional[ArrayOrQ]
    wk: Optional[ArrayOrQ]
    wv: Optional[ArrayOrQ]
    wo: ArrayOrQ
    w1: Optional[ArrayOrQ]
    w2: ArrayOrQ
    w3: Optional[ArrayOrQ]
    attn_norm: jax.Array
    ffn_norm: jax.Array
    # Fused variants (see fuse_params): wqkv = [wq|wk|wv], w13 = [w1|w3].
    # When set, the unfused fields are None — one matmul instead of three
    # halves the kernel-launch count of the decode hot loop.
    wqkv: Optional[ArrayOrQ] = None
    w13: Optional[ArrayOrQ] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LlamaParams:
    tok_embd: jax.Array  # [V, D]
    layers: LayerParams  # leaves stacked along a leading [L] axis
    norm: jax.Array  # [D]
    output: ArrayOrQ  # [D, V]


class KVCache(NamedTuple):
    """Dense KV cache, head-major: [L, B, Hkv, S, Dh]."""

    k: jax.Array
    v: jax.Array

    @staticmethod
    def create(
        cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None, dtype=jnp.bfloat16
    ) -> "KVCache":
        S = max_seq or cfg.n_ctx
        shape = (cfg.n_layer, batch, cfg.n_kv_head, S, cfg.head_dim)
        return KVCache(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def _attend_and_update(cfg, q, k, v, lcache, offsets, positions):
    """Write (k, v) into this layer's cache and attend.

    lcache is (k_cache, v_cache) for a bf16/f32 cache or
    (k, k_scales, v, v_scales) for an int8-quantized cache
    (ops/kvquant.py).
    """
    if len(lcache) == 2:
        kc, vc = update_kv_cache(*lcache, k, v, offsets)
        return attend_cache(q, kc, vc, positions), (kc, vc)

    from tokenhawk_tpu.ops.kvquant import (
        attend_cache_int8,
        update_kv_cache_int8,
    )

    kc, ksc, vc, vsc = update_kv_cache_int8(*lcache, k, v, offsets)
    ctx = attend_cache_int8(q, kc, ksc, vc, vsc, positions)
    return ctx, (kc, ksc, vc, vsc)


def _wo_ffn_block(cfg: LlamaConfig, x, ctx, lp: LayerParams,
                  psum_axis=None):
    """x + ctx @ Wo followed by the SwiGLU MLP block.

    psum_axis: tensor-parallel mode (inside shard_map) — ctx holds
    local heads and wo/w2 are row-parallel shards, so their matmul
    partials all-reduce before the residual adds."""
    attn = matmul(ctx, lp.wo)
    if psum_axis is not None:
        attn = jax.lax.psum(attn, psum_axis)
    x = x + attn
    return _ffn_block(cfg, x, lp, psum_axis)


def _ffn_block(cfg: LlamaConfig, x, lp: LayerParams, psum_axis=None):
    """SwiGLU MLP with residual: x + silu(norm(x)@w1)*(norm(x)@w3) @ w2.

    XLA fuses the gate, the product and the residual add around the two
    (GEMV or GEMM) projections."""
    if lp.w13 is not None:
        gate_up = matmul(x, lp.w13, lp.ffn_norm, eps=cfg.rms_norm_eps)
        Fl = gate_up.shape[-1] // 2
        g, u = gate_up[..., :Fl], gate_up[..., Fl:]
    else:
        g = matmul(x, lp.w1, lp.ffn_norm, eps=cfg.rms_norm_eps)
        u = matmul(x, lp.w3, lp.ffn_norm, eps=cfg.rms_norm_eps)
    gate = jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype)
    ffn = matmul(gate * u, lp.w2)
    if psum_axis is not None:
        ffn = jax.lax.psum(ffn, psum_axis)
    return x + ffn


def _layer_forward(cfg: LlamaConfig, x, lp: LayerParams, lcache, cos, sin, offsets, positions):
    B, T, D = x.shape
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim

    Dq, Dkv = H * Dh, Hkv * Dh
    if lp.wqkv is not None:
        qkv = matmul(x, lp.wqkv, lp.attn_norm,
                     eps=cfg.rms_norm_eps)  # [B, T, Dq + 2*Dkv]
        q = qkv[..., :Dq].reshape(B, T, H, Dh)
        k = qkv[..., Dq : Dq + Dkv].reshape(B, T, Hkv, Dh)
        v = qkv[..., Dq + Dkv :].reshape(B, T, Hkv, Dh)
    else:
        q = matmul(x, lp.wq, lp.attn_norm,
                   eps=cfg.rms_norm_eps).reshape(B, T, H, Dh)
        k = matmul(x, lp.wk, lp.attn_norm,
                   eps=cfg.rms_norm_eps).reshape(B, T, Hkv, Dh)
        v = matmul(x, lp.wv, lp.attn_norm,
                   eps=cfg.rms_norm_eps).reshape(B, T, Hkv, Dh)
    q = apply_rope(q, cos, sin, cfg.rope_style)
    k = apply_rope(k, cos, sin, cfg.rope_style)
    ctx, lcache = _attend_and_update(cfg, q, k, v, lcache, offsets, positions)
    return _wo_ffn_block(cfg, x, ctx.reshape(B, T, D), lp), lcache


class QuantKVCache(NamedTuple):
    """Int8 KV cache (see ops/kvquant.py): [L, B, Hkv, S, *] arrays."""

    k: jax.Array  # int8 [L, B, Hkv, S, Dh]
    ks: jax.Array  # bf16 [L, B, Hkv, S] (token-innermost scales)
    v: jax.Array
    vs: jax.Array

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None) -> "QuantKVCache":
        S = max_seq or cfg.n_ctx
        shape = (cfg.n_layer, batch, cfg.n_kv_head, S, cfg.head_dim)
        sshape = (cfg.n_layer, batch, cfg.n_kv_head, S)
        return QuantKVCache(
            jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.bfloat16),
            jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.bfloat16),
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def make_unrolled_cache(
    cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
    dtype=jnp.bfloat16,
) -> Tuple:
    """Per-layer cache tuple for unrolled-layer params (see unstack_params)."""
    S = max_seq or cfg.n_ctx
    shape = (batch, cfg.n_kv_head, S, cfg.head_dim)
    return tuple(
        (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
        for _ in range(cfg.n_layer)
    )


def make_unrolled_quant_cache(
    cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
) -> Tuple:
    """Per-layer int8 cache tuple: (k, ks, v, vs) per layer — the 4-tuple
    form `_attend_and_update` dispatches on (ops/kvquant.py)."""
    S = max_seq or cfg.n_ctx
    shape = (batch, cfg.n_kv_head, S, cfg.head_dim)
    sshape = (batch, cfg.n_kv_head, S)
    return tuple(
        (
            jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.bfloat16),
            jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.bfloat16),
        )
        for _ in range(cfg.n_layer)
    )


def forward(
    cfg: LlamaConfig,
    params: LlamaParams,
    tokens: jax.Array,  # [B, T] int32
    cache,  # KVCache (stacked layers) or tuple of (k_l, v_l) (unrolled)
    offsets: jax.Array,  # [B] int32: cache write offset per sequence
):
    """Run a token block through all layers.

    Returns hidden states [B, T, D] (pre final norm) and the updated cache.
    Works for prefill (T = block) and decode (T = 1) alike; the per-token
    "single vs batch pipeline" split of the reference
    (/root/reference/th-llama.hpp:118-122) disappears — XLA specializes on
    the traced shapes.

    Two layer-iteration modes:
      - stacked [L, ...] weights + lax.scan: small compiled program;
      - unrolled tuple-of-layers weights + python loop: each kernel reads
        its weight array in place (no per-layer dynamic-slice buffers),
        which matters when weights dominate HBM traffic.
    """
    B, T = tokens.shape
    x = params.tok_embd[tokens].astype(params.tok_embd.dtype)
    positions = offsets[:, None] + jnp.arange(T, dtype=offsets.dtype)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    if isinstance(params.layers, tuple):  # unrolled
        new_cache = []
        for lp, lcache in zip(params.layers, cache):
            x, lcache = _layer_forward(
                cfg, x, lp, lcache, cos, sin, offsets, positions
            )
            new_cache.append(lcache)
        return x, tuple(new_cache)

    if isinstance(cache, QuantKVCache):
        xs = (params.layers, (cache.k, cache.ks, cache.v, cache.vs))
    else:
        xs = (params.layers, (cache.k, cache.v))

    def body(x, layer_inputs):
        lp, lcache = layer_inputs
        x, lcache = _layer_forward(cfg, x, lp, lcache, cos, sin, offsets, positions)
        return x, lcache

    x, new = jax.lax.scan(body, x, xs)
    if isinstance(cache, QuantKVCache):
        return x, QuantKVCache(*new)
    return x, KVCache(*new)


def rope_half_params(cfg: LlamaConfig, params: LlamaParams):
    """Load-time column permutation: interleaved RoPE -> "half" RoPE.

    The reference rotates (x[2i], x[2i+1]) pairs
    (/root/reference/th.cpp:1457-1492); computing that directly needs
    even/odd deinterleaves that XLA lowers to strided shuffles
    on every q/k per step.  Permuting each head's wq/wk OUTPUT columns
    once at load time (new j = old 2j for j < Dh/2, new Dh/2+j = old
    2j+1) makes the cheap contiguous-halves "half" rotation compute the
    exact same values on the permuted axis; attention is invariant to a
    fixed permutation of the head dim applied to both q and k (the KV
    cache simply stores permuted keys), and v/wo are untouched.

    Apply BEFORE fuse_params/sharding; returns (cfg', params') with
    cfg'.rope_style == "half".
    """
    if cfg.rope_style != "interleaved":
        return cfg, params
    if params.layers.wqkv is not None:
        raise ValueError("rope_half_params must run before fuse_params")
    Dh = cfg.head_dim
    half = Dh // 2
    within = np.empty(Dh, np.int64)
    within[:half] = np.arange(half) * 2
    within[half:] = np.arange(half) * 2 + 1

    def permute_cols(w, n_heads):
        perm = (np.arange(n_heads)[:, None] * Dh + within[None, :]).reshape(-1)

        def take(a):
            return None if a is None else jnp.take(a, perm, axis=-1)

        if isinstance(w, QWeight):
            return dataclasses.replace(
                w, qs=take(w.qs), scales=take(w.scales), mins=take(w.mins),
                scales_hi=take(w.scales_hi),
            )
        return take(w)

    layers = dataclasses.replace(
        params.layers,
        wq=permute_cols(params.layers.wq, cfg.n_head),
        wk=permute_cols(params.layers.wk, cfg.n_kv_head),
    )
    return (
        dataclasses.replace(cfg, rope_style="half"),
        dataclasses.replace(params, layers=layers),
    )


def unstack_params(params: LlamaParams) -> LlamaParams:
    """Stacked [L, ...] layer weights -> tuple of per-layer LayerParams.

    Kernels then consume each layer's weights directly from their own
    HBM buffers instead of per-iteration dynamic slices of a stacked
    array."""
    if isinstance(params.layers, tuple):
        return params

    def slice_leaf(leaf, l):
        if leaf is None:
            return None
        if isinstance(leaf, QWeight):
            return QWeight(
                qs=leaf.qs[l], scales=leaf.scales[l],
                mins=None if leaf.mins is None else leaf.mins[l],
                scales_hi=None if leaf.scales_hi is None else leaf.scales_hi[l],
                kind=leaf.kind, group=leaf.group,
            )
        return leaf[l]

    L = params.layers.attn_norm.shape[0]
    layers = tuple(
        LayerParams(**{
            f.name: slice_leaf(getattr(params.layers, f.name), l)
            for f in dataclasses.fields(LayerParams)
        })
        for l in range(L)
    )
    return dataclasses.replace(params, layers=layers)


def stack_params(params: LlamaParams) -> LlamaParams:
    """Inverse of unstack_params: tuple-of-LayerParams -> stacked [L]
    leaves (the lax.scan form the paged forwards consume).

    Needed because the loader's single-chip/TP pipelines end in the
    unrolled decode-fast form while PagedScheduler scans stacked layer
    weights."""
    if not isinstance(params.layers, tuple):
        return params
    lps = params.layers

    def stack_field(name):
        vals = [getattr(lp, name) for lp in lps]
        if vals[0] is None:
            return None
        if isinstance(vals[0], QWeight):
            def opt(f):
                vs = [getattr(w, f) for w in vals]
                return jnp.stack(vs) if vs[0] is not None else None

            return QWeight(qs=opt("qs"), scales=opt("scales"),
                           mins=opt("mins"), scales_hi=opt("scales_hi"),
                           kind=vals[0].kind, group=vals[0].group)
        return jnp.stack(vals)

    layers = LayerParams(**{
        f.name: stack_field(f.name)
        for f in dataclasses.fields(LayerParams)
    })
    return dataclasses.replace(params, layers=layers)


def _embed_vp(tok_embd_local, tokens, axis):
    """Vocab-parallel embedding for shard_map TP: local gather + psum."""
    v_local = tok_embd_local.shape[0]
    vi = jax.lax.axis_index(axis)
    local_ids = tokens - vi * v_local
    valid = (local_ids >= 0) & (local_ids < v_local)
    safe = jnp.clip(local_ids, 0, v_local - 1)
    x = tok_embd_local[safe]
    x = jnp.where(valid[..., None], x, jnp.zeros_like(x))
    return jax.lax.psum(x, axis)


def forward_paged_decode(
    cfg: LlamaConfig,
    params: LlamaParams,
    tokens: jax.Array,  # [B, 1] int32
    cache,  # runtime.paged.PagedKVCache
    page_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,  # [B] tokens already stored (new token's position)
    psum_axis=None,
    tp: int = 1,
):
    """One decode step over the paged KV cache.

    Same math as `forward` with T=1, but KV state lives in pages mapped
    through per-sequence page tables (runtime/paged.py).  Returns
    (hidden [B, 1, D], new cache).
    """
    from tokenhawk_tpu.runtime.paged import (
        PagedKVCache,
        PagedQuantKVCache,
        append_token_layer,
        append_token_layer_int8,
        attend_paged_layer,
        attend_paged_layer_int8,
    )

    from tokenhawk_tpu.runtime.paged import is_unrolled_pool

    quant = (isinstance(cache, PagedQuantKVCache)
             or (is_unrolled_pool(cache) and len(cache[0]) == 4))
    B = tokens.shape[0]
    H, Hkv = cfg.n_head // tp, cfg.n_kv_head // tp  # local under TP
    Dh = cfg.head_dim
    D = cfg.n_embd
    if psum_axis is not None:
        x = _embed_vp(params.tok_embd, tokens, psum_axis)
    else:
        x = params.tok_embd[tokens]
    x = x.astype(params.tok_embd.dtype)  # [B, 1, D]
    positions = lengths[:, None]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    def body(x, layer_inputs):
        lp, lcache = layer_inputs[0], layer_inputs[1:]
        if lp.wqkv is not None:
            qkv = matmul(x, lp.wqkv, lp.attn_norm, eps=cfg.rms_norm_eps)
            Dq, Dkv = H * Dh, Hkv * Dh
            q = qkv[..., :Dq].reshape(B, 1, H, Dh)
            k = qkv[..., Dq : Dq + Dkv].reshape(B, 1, Hkv, Dh)
            v = qkv[..., Dq + Dkv :].reshape(B, 1, Hkv, Dh)
        else:
            q = matmul(x, lp.wq, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, 1, H, Dh)
            k = matmul(x, lp.wk, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, 1, Hkv, Dh)
            v = matmul(x, lp.wv, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, 1, Hkv, Dh)
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)

        if quant:
            k_l, ks_l, v_l, vs_l = lcache
            k_l, ks_l = append_token_layer_int8(
                k_l, ks_l, k[:, 0], page_table, lengths)
            v_l, vs_l = append_token_layer_int8(
                v_l, vs_l, v[:, 0], page_table, lengths)
            ctx = attend_paged_layer_int8(
                q, k_l, ks_l, v_l, vs_l, page_table, lengths + 1)
            lcache = (k_l, ks_l, v_l, vs_l)
        else:
            k_l, v_l = lcache
            k_l = append_token_layer(k_l, k[:, 0], page_table, lengths)
            v_l = append_token_layer(v_l, v[:, 0], page_table, lengths)
            ctx = attend_paged_layer(q, k_l, v_l, page_table, lengths + 1)
            lcache = (k_l, v_l)
        return _wo_ffn_block(cfg, x, ctx.reshape(B, 1, H * Dh), lp,
                             psum_axis), lcache

    if isinstance(params.layers, tuple):
        # Decode-fast unrolled form (per-layer tuple pool): the python
        # layer loop updates each donated per-layer pool array IN PLACE
        # via its dynamic-update-slice chain.  The stacked form below
        # carries the pool through lax.scan as xs/ys, and scan ys
        # reallocate and rewrite the whole pool every call, so its step
        # cost grows with the pool size instead of the live tokens.
        new = []
        for lp, lcache in zip(params.layers, cache):
            x, lc = body(x, (lp, *lcache))
            new.append(lc)
        return x, tuple(new)
    x, new = jax.lax.scan(body, x, (params.layers, *cache))
    return x, type(cache)(*new)


def forward_paged_prefill(
    cfg: LlamaConfig,
    params: LlamaParams,
    tokens: jax.Array,  # [B, Tb] int32 (fresh prompts, positions 0..Tb)
    cache,  # runtime.paged.PagedKVCache
    page_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,  # [B] valid prompt tokens
    psum_axis=None,
    tp: int = 1,
):
    """Prefill straight into pages — no dense-fragment detour.

    The previous admission path prefilled a dense fragment and then
    copied it page-by-page (double-writing every prompt token); here each
    layer's K/V block pages out in place during the forward.  Attention
    is block-local (the prompt attends only to itself: fresh admission,
    position 0), so the math is identical to the dense fragment prefill.
    Returns (hidden [B, Tb, D], new cache).
    """
    from tokenhawk_tpu.runtime.paged import (
        PagedKVCache,
        PagedQuantKVCache,
        paginate_fragment_layer,
        paginate_fragment_layer_int8,
    )

    from tokenhawk_tpu.runtime.paged import is_unrolled_pool

    quant = (isinstance(cache, PagedQuantKVCache)
             or (is_unrolled_pool(cache) and len(cache[0]) == 4))
    B, T = tokens.shape
    H, Hkv = cfg.n_head // tp, cfg.n_kv_head // tp  # local under TP
    Dh = cfg.head_dim
    if psum_axis is not None:
        x = _embed_vp(params.tok_embd, tokens, psum_axis)
    else:
        x = params.tok_embd[tokens]
    x = x.astype(params.tok_embd.dtype)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None, :], (B, T))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    def body(x, layer_inputs):
        lp, lcache = layer_inputs[0], layer_inputs[1:]
        Dq, Dkv = H * Dh, Hkv * Dh
        if lp.wqkv is not None:
            qkv = matmul(x, lp.wqkv, lp.attn_norm, eps=cfg.rms_norm_eps)
            q = qkv[..., :Dq].reshape(B, T, H, Dh)
            k = qkv[..., Dq : Dq + Dkv].reshape(B, T, Hkv, Dh)
            v = qkv[..., Dq + Dkv :].reshape(B, T, Hkv, Dh)
        else:
            q = matmul(x, lp.wq, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, T, H, Dh)
            k = matmul(x, lp.wk, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, T, Hkv, Dh)
            v = matmul(x, lp.wv, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, T, Hkv, Dh)
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)

        k_b = jnp.swapaxes(k, 1, 2)  # [B, Hkv, T, Dh]
        v_b = jnp.swapaxes(v, 1, 2)
        ctx = attend_cache(q, k_b, v_b, positions)
        if quant:
            k_l, ks_l, v_l, vs_l = lcache
            k_l, ks_l = paginate_fragment_layer_int8(
                k_l, ks_l, k_b, page_table)
            v_l, vs_l = paginate_fragment_layer_int8(
                v_l, vs_l, v_b, page_table)
            lcache = (k_l, ks_l, v_l, vs_l)
        else:
            k_l, v_l = lcache
            k_l = paginate_fragment_layer(k_l, k_b, page_table)
            v_l = paginate_fragment_layer(v_l, v_b, page_table)
            lcache = (k_l, v_l)
        return _wo_ffn_block(cfg, x, ctx.reshape(B, T, H * Dh), lp,
                             psum_axis), lcache

    if isinstance(params.layers, tuple):
        # Decode-fast unrolled form (per-layer tuple pool): the python
        # layer loop updates each donated per-layer pool array IN PLACE
        # via its dynamic-update-slice chain.  The stacked form below
        # carries the pool through lax.scan as xs/ys, and scan ys
        # reallocate and rewrite the whole pool every call, so its step
        # cost grows with the pool size instead of the live tokens.
        new = []
        for lp, lcache in zip(params.layers, cache):
            x, lc = body(x, (lp, *lcache))
            new.append(lc)
        return x, tuple(new)
    x, new = jax.lax.scan(body, x, (params.layers, *cache))
    return x, type(cache)(*new)


def forward_paged_prefill_cont(
    cfg: LlamaConfig,
    params: LlamaParams,
    tokens: jax.Array,  # [B, C] int32 (one chunk of a long prompt)
    cache,  # runtime.paged.PagedKVCache or PagedQuantKVCache
    page_table: jax.Array,  # [B, max_pages]
    start: jax.Array,  # [B] int32 position of tokens[:, 0] (page-aligned)
    n_new: jax.Array,  # [B] valid tokens in this chunk
    psum_axis=None,
    tp: int = 1,
):
    """Chunked-prefill continuation: one prompt chunk attends to the
    slot's already-written pages plus itself (causal), and its KV pages
    out in place.  `start` must be page-aligned (the scheduler admits in
    page-multiple chunks), so writes are whole-page DMAs.

    Attention uses the gathered-page XLA path (jnp.take on the page
    axis): every chunk re-reads the
    history pages once, which costs the same KV traffic as ~1 decode
    step per chunk — the price of not stalling concurrent decodes for a
    whole long-prompt prefill.  Returns (hidden [B, C, D], new cache).
    """
    from tokenhawk_tpu.runtime.paged import (
        PagedQuantKVCache,
        paginate_fragment_layer_at,
        paginate_fragment_layer_int8_at,
    )

    from tokenhawk_tpu.runtime.paged import is_unrolled_pool

    quant = (isinstance(cache, PagedQuantKVCache)
             or (is_unrolled_pool(cache) and len(cache[0]) == 4))
    B, C = tokens.shape
    H, Hkv = cfg.n_head // tp, cfg.n_kv_head // tp  # local under TP
    Dh = cfg.head_dim
    if psum_axis is not None:
        x = _embed_vp(params.tok_embd, tokens, psum_axis)
    else:
        x = params.tok_embd[tokens]
    x = x.astype(params.tok_embd.dtype)
    positions = start[:, None] + jnp.arange(C, dtype=jnp.int32)[None, :]
    # Rows beyond n_new are padding; park them before the chunk so they
    # can't unmask history they shouldn't see (their outputs are unused).
    positions = jnp.where(
        jnp.arange(C)[None, :] < n_new[:, None], positions, 0
    )
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    from tokenhawk_tpu.runtime.paged import pool_page_size

    ps = pool_page_size(cache)
    start_page = start // ps

    def body(x, layer_inputs):
        lp, lcache = layer_inputs[0], layer_inputs[1:]
        Dq, Dkv = H * Dh, Hkv * Dh
        if lp.wqkv is not None:
            qkv = matmul(x, lp.wqkv, lp.attn_norm, eps=cfg.rms_norm_eps)
            q = qkv[..., :Dq].reshape(B, C, H, Dh)
            k = qkv[..., Dq : Dq + Dkv].reshape(B, C, Hkv, Dh)
            v = qkv[..., Dq + Dkv :].reshape(B, C, Hkv, Dh)
        else:
            q = matmul(x, lp.wq, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, C, H, Dh)
            k = matmul(x, lp.wk, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, C, Hkv, Dh)
            v = matmul(x, lp.wv, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, C, Hkv, Dh)
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)

        k_b = jnp.swapaxes(k, 1, 2)  # [B, Hkv, C, Dh]
        v_b = jnp.swapaxes(v, 1, 2)
        mp = page_table.shape[1]
        # Write the fragment first, then gather history + self from the
        # pages (slot p*ps+i holds global position p*ps+i, so the causal
        # mask in attend_cache is exact; trash/garbage pages sit at
        # positions > every query and mask out).
        if quant:
            k_l, ks_l, v_l, vs_l = lcache
            k_l, ks_l = paginate_fragment_layer_int8_at(
                k_l, ks_l, k_b, page_table, start_page)
            v_l, vs_l = paginate_fragment_layer_int8_at(
                v_l, vs_l, v_b, page_table, start_page)
            lcache = (k_l, ks_l, v_l, vs_l)
            from tokenhawk_tpu.runtime.paged import (
                gather_pool_payload,
                gather_pool_scales,
            )

            def dq(pages, spages):
                g = gather_pool_payload(pages, page_table)
                sg = gather_pool_scales(spages, page_table)
                g = g.astype(x.dtype) * sg[..., None].astype(x.dtype)
                return g.reshape(B, Hkv, mp * ps, Dh)

            kg, vg = dq(k_l, ks_l), dq(v_l, vs_l)
        else:
            k_l, v_l = lcache
            k_l = paginate_fragment_layer_at(k_l, k_b, page_table,
                                             start_page)
            v_l = paginate_fragment_layer_at(v_l, v_b, page_table,
                                             start_page)
            lcache = (k_l, v_l)
            from tokenhawk_tpu.runtime.paged import gather_pool_payload

            kg = gather_pool_payload(k_l, page_table).reshape(
                B, Hkv, mp * ps, Dh)
            vg = gather_pool_payload(v_l, page_table).reshape(
                B, Hkv, mp * ps, Dh)
        ctx = attend_cache(q, kg, vg, positions)
        return _wo_ffn_block(cfg, x, ctx.reshape(B, C, H * Dh), lp,
                             psum_axis), lcache

    if isinstance(params.layers, tuple):
        # Decode-fast unrolled form (per-layer tuple pool): the python
        # layer loop updates each donated per-layer pool array IN PLACE
        # via its dynamic-update-slice chain.  The stacked form below
        # carries the pool through lax.scan as xs/ys, and scan ys
        # reallocate and rewrite the whole pool every call, so its step
        # cost grows with the pool size instead of the live tokens.
        new = []
        for lp, lcache in zip(params.layers, cache):
            x, lc = body(x, (lp, *lcache))
            new.append(lc)
        return x, tuple(new)
    x, new = jax.lax.scan(body, x, (params.layers, *cache))
    return x, type(cache)(*new)


def forward_paged_verify(
    cfg: LlamaConfig,
    params: LlamaParams,
    tokens: jax.Array,  # [B, T] int32 (speculative verify block)
    cache,  # runtime.paged.PagedKVCache (bf16 pages)
    page_table: jax.Array,  # [B, max_pages]
    start: jax.Array,  # [B] int32 position of tokens[:, 0] (ANY offset)
    adv: jax.Array,  # [B] int32 1 = live (positions advance), 0 = frozen
    psum_axis=None,
    tp: int = 1,
):
    """Multi-token forward over paged KV at an arbitrary (unaligned)
    offset — the target-verify step of speculative decoding.  Each
    token's KV lands via a per-token page write (T = gamma+1 is small);
    rejected drafts' writes sit beyond the committed frontier and are
    overwritten by the next round, exactly like the dense no-rollback
    scheme (runtime/speculative.py).  Frozen slots (adv=0) keep writing
    at their frontier, invisible to length-masked attention.

    Returns (hidden [B, T, D], new cache).
    """
    from tokenhawk_tpu.runtime.paged import append_token_layer

    B, T = tokens.shape
    H, Hkv = cfg.n_head // tp, cfg.n_kv_head // tp  # local under TP
    Dh = cfg.head_dim
    if psum_axis is not None:
        x = _embed_vp(params.tok_embd, tokens, psum_axis)
    else:
        x = params.tok_embd[tokens]
    x = x.astype(params.tok_embd.dtype)
    positions = start[:, None] + adv[:, None] * jnp.arange(T, dtype=jnp.int32)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    from tokenhawk_tpu.runtime.paged import pool_page_size

    ps = pool_page_size(cache)
    mp = page_table.shape[1]

    def body(x, layer_inputs):
        lp, (k_l, v_l) = layer_inputs[0], layer_inputs[1:]
        Dq, Dkv = H * Dh, Hkv * Dh
        if lp.wqkv is not None:
            qkv = matmul(x, lp.wqkv, lp.attn_norm, eps=cfg.rms_norm_eps)
            q = qkv[..., :Dq].reshape(B, T, H, Dh)
            k = qkv[..., Dq : Dq + Dkv].reshape(B, T, Hkv, Dh)
            v = qkv[..., Dq + Dkv :].reshape(B, T, Hkv, Dh)
        else:
            q = matmul(x, lp.wq, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, T, H, Dh)
            k = matmul(x, lp.wk, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, T, Hkv, Dh)
            v = matmul(x, lp.wv, lp.attn_norm,
                       eps=cfg.rms_norm_eps).reshape(B, T, Hkv, Dh)
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)

        for jj in range(T):  # per-token page writes (T = gamma+1, small)
            k_l = append_token_layer(k_l, k[:, jj], page_table,
                                     positions[:, jj])
            v_l = append_token_layer(v_l, v[:, jj], page_table,
                                     positions[:, jj])
        from tokenhawk_tpu.runtime.paged import gather_pool_payload

        kg = gather_pool_payload(k_l, page_table).reshape(
            B, Hkv, mp * ps, Dh)
        vg = gather_pool_payload(v_l, page_table).reshape(
            B, Hkv, mp * ps, Dh)
        ctx = attend_cache(q, kg, vg, positions)
        return _wo_ffn_block(cfg, x, ctx.reshape(B, T, H * Dh), lp,
                             psum_axis), (k_l, v_l)

    if isinstance(params.layers, tuple):
        # Decode-fast unrolled form (per-layer tuple pool): the python
        # layer loop updates each donated per-layer pool array IN PLACE
        # via its dynamic-update-slice chain.  The stacked form below
        # carries the pool through lax.scan as xs/ys, and scan ys
        # reallocate and rewrite the whole pool every call, so its step
        # cost grows with the pool size instead of the live tokens.
        new = []
        for lp, lcache in zip(params.layers, cache):
            x, lc = body(x, (lp, *lcache))
            new.append(lc)
        return x, tuple(new)
    x, new = jax.lax.scan(body, x, (params.layers, *cache))
    return x, type(cache)(*new)


def logits_from_hidden(
    cfg: LlamaConfig, params: LlamaParams, hidden: jax.Array
) -> jax.Array:
    """Final RMSNorm + output projection -> f32 logits [..., V]."""
    return matmul(hidden, params.output, params.norm, eps=cfg.rms_norm_eps,
                  accum_dtype=jnp.float32).astype(jnp.float32)


def fuse_params(params: LlamaParams) -> LlamaParams:
    """Fuse wq|wk|wv -> wqkv and w1|w3 -> w13 (single-chip / replicated
    layouts; for tensor-parallel layouts fusion must interleave per shard
    — use the unfused form there)."""

    def fusable(ws):
        """Mixed quant kinds (e.g. Q4_K wq/wk with a Q6_K wv in a
        Q4_K_M file) cannot concatenate; keep those separate."""
        qws = [w for w in ws if isinstance(w, QWeight)]
        if not qws:
            return True
        if len(qws) != len(ws):
            return False
        return (len({w.kind for w in qws}) == 1
                and len({w.group for w in qws}) == 1
                and len({w.mins is None for w in qws}) == 1)

    def cat(ws):
        if isinstance(ws[0], QWeight):
            from tokenhawk_tpu.ops.qweight import concat_qweights

            return concat_qweights(ws)
        return jnp.concatenate(ws, axis=-1)

    lay = params.layers
    upd = {}
    if fusable([lay.wq, lay.wk, lay.wv]):
        upd.update(wqkv=cat([lay.wq, lay.wk, lay.wv]),
                   wq=None, wk=None, wv=None)
    if fusable([lay.w1, lay.w3]):
        upd.update(w13=cat([lay.w1, lay.w3]), w1=None, w3=None)
    layers = dataclasses.replace(lay, **upd)
    return dataclasses.replace(params, layers=layers)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def init_params(
    cfg: LlamaConfig, key: jax.Array, dtype=jnp.bfloat16, scale: float = 0.02
) -> LlamaParams:
    """Random parameters (tests, synthetic benchmarks)."""
    ks = jax.random.split(key, 10)
    D, F, V, L = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_layer
    Dkv = cfg.n_embd_kv

    def w(k, shape):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    layers = LayerParams(
        wq=w(ks[0], (L, D, D)),
        wk=w(ks[1], (L, D, Dkv)),
        wv=w(ks[2], (L, D, Dkv)),
        wo=w(ks[3], (L, D, D)),
        w1=w(ks[4], (L, D, F)),
        w2=w(ks[5], (L, F, D)),
        w3=w(ks[6], (L, D, F)),
        attn_norm=jnp.ones((L, D), dtype),
        ffn_norm=jnp.ones((L, D), dtype),
    )
    return LlamaParams(
        tok_embd=w(ks[7], (V, D)),
        layers=layers,
        norm=jnp.ones((D,), dtype),
        output=w(ks[8], (D, V)),
    )


HostTensor = Union[np.ndarray, QuantizedTensor]


def _to_device_weight(
    t: HostTensor, dtype, transpose: bool, k_shards: int = 1,
    scale_dtype=jnp.float32,
) -> ArrayOrQ:
    if isinstance(t, QWeight):
        return t  # already in device layout (native fast-path loader)
    if isinstance(t, QuantizedTensor):
        if not transpose:
            return jnp.asarray(dequantize(t), dtype=dtype)
        return from_quantized_tensor(t, k_shards=k_shards, scale_dtype=scale_dtype)
    arr = np.asarray(t)
    if transpose:
        arr = np.ascontiguousarray(arr.T)
    return jnp.asarray(arr.astype(np.float32), dtype=dtype)


def params_from_ggml(
    cfg: LlamaConfig,
    tensors: Dict[str, HostTensor],
    dtype=jnp.bfloat16,
    row_parallel_shards: int = 1,
    scale_dtype=jnp.float32,
) -> LlamaParams:
    """Build the device parameter pytree from loaded GGML tensors.

    2-D projection weights transpose from GGML's [out, in] to [in, out];
    quantized tensors stay quantized (QWeight).  The embedding table is
    always densified (it is a gather, not a matmul — the reference keeps
    it CPU-side in f32, /root/reference/th-llama-loader.cpp:180-196).

    row_parallel_shards: for shard_map tensor parallelism, q4_0 weights
    whose contraction dim gets sharded (wo, w2) are nibble-packed per
    shard (see ops.qweight.pack_q4_rows).
    """
    _ROW_PARALLEL = ("attention.wo.weight", "feed_forward.w2.weight")

    def get(name: str, transpose=True) -> ArrayOrQ:
        ks = row_parallel_shards if name.endswith(_ROW_PARALLEL) else 1
        return _to_device_weight(tensors[name], dtype, transpose, k_shards=ks,
                                 scale_dtype=scale_dtype)

    def stack(fmt: str, transpose=True):
        ws = [get(fmt.format(i), transpose) for i in range(cfg.n_layer)]
        if isinstance(ws[0], QWeight):
            hetero = (len({w.kind for w in ws}) > 1
                      or len({w.group for w in ws}) > 1
                      or len({w.mins is None for w in ws}) > 1)
            if hetero:
                # llama.cpp's *_M recipes mix kinds within one family
                # across layers (Q6_K attention.wv / feed_forward.w2 on
                # some layers); re-encode EXACTLY to the common group-16
                # affine int8 container so the family stacks.
                from tokenhawk_tpu.ops.qweight import to_qk16

                ws = [to_qk16(w) for w in ws]

            def opt(field):
                vals = [getattr(w, field) for w in ws]
                return jnp.stack(vals) if vals[0] is not None else None

            return QWeight(
                qs=jnp.stack([w.qs for w in ws]),
                scales=jnp.stack([w.scales for w in ws]),
                mins=opt("mins"),
                scales_hi=opt("scales_hi"),
                kind=ws[0].kind,
                group=ws[0].group,
            )
        return jnp.stack(ws)

    layers = LayerParams(
        wq=stack("layers.{}.attention.wq.weight"),
        wk=stack("layers.{}.attention.wk.weight"),
        wv=stack("layers.{}.attention.wv.weight"),
        wo=stack("layers.{}.attention.wo.weight"),
        w1=stack("layers.{}.feed_forward.w1.weight"),
        w2=stack("layers.{}.feed_forward.w2.weight"),
        w3=stack("layers.{}.feed_forward.w3.weight"),
        attn_norm=stack("layers.{}.attention_norm.weight", transpose=False),
        ffn_norm=stack("layers.{}.ffn_norm.weight", transpose=False),
    )
    tok = tensors["tok_embeddings.weight"]
    if isinstance(tok, QuantizedTensor):
        tok = dequantize(tok)
    tok_embd = jnp.asarray(np.asarray(tok).astype(np.float32), dtype=dtype)
    return LlamaParams(
        tok_embd=tok_embd,
        layers=layers,
        norm=get("norm.weight", transpose=False),
        output=get("output.weight"),
    )
