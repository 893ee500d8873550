"""Explicit tensor-parallel forward under shard_map.

GSPMD partitions plain XLA ops automatically, but Pallas kernels are
opaque custom calls — to run them tensor-parallel the partitioning must
be explicit.  This module rebuilds the model step as a shard_map program
with Megatron-style TP over the "model" axis and data parallelism over
"data":

  per layer:   wq/wk/wv column-parallel -> local heads -> local flash
               attention -> wo row-parallel -> psum    (1 all-reduce)
               w1/w3 column-parallel -> w2 row-parallel -> psum (1 all-reduce)
  embedding:   vocab-parallel gather + psum
  logits:      vocab-column-parallel matmul + tiled all-gather
  sampling:    replicated (same key everywhere -> same sample)

This is the multi-chip realization of the reference's k-way split-GEMV +
`vector_reduce` pattern (th.cpp:3795-3912, :4042-4127) with the reduce
riding NVLink.  Weight layout contract: see
`param_specs_tp` and `pack_q4_rows` (row-parallel q4 weights are packed
per shard).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import KVCache, LayerParams, LlamaParams
from tokenhawk_tpu.ops import (
    apply_rope,
    attend_cache,
    matmul,
    rope_cos_sin,
    update_kv_cache,
)
from tokenhawk_tpu.ops.qweight import QWeight
from tokenhawk_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from tokenhawk_tpu.sampling import is_eos as _is_eos
from tokenhawk_tpu.sampling import normalize_eos, sample

try:  # jax >= 0.7 exposes shard_map at the top level
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                          check_vma=False)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_old

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map_old(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_rep=False)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def layer_specs_tp(lp: LayerParams = None, stacked: bool = True) -> LayerParams:
    pre = (None,) if stacked else ()
    col = P(*pre, None, MODEL_AXIS)  # [(L,) K, N/tp]
    row = P(*pre, MODEL_AXIS, None)  # [(L,) K/tp, N]
    vec = P(*pre, None)

    def opt(w, spec):
        return None if (lp is not None and w is None) else spec

    if lp is None:
        lp = LayerParams(wq=1, wk=1, wv=1, wo=1, w1=1, w2=1, w3=1,
                         attn_norm=1, ffn_norm=1)
    return LayerParams(
        wq=opt(lp.wq, col), wk=opt(lp.wk, col), wv=opt(lp.wv, col),
        wo=row, w1=opt(lp.w1, col), w2=row, w3=opt(lp.w3, col),
        attn_norm=vec, ffn_norm=vec,
        wqkv=opt(lp.wqkv, col) if lp.wqkv is not None else None,
        w13=opt(lp.w13, col) if lp.w13 is not None else None,
    )


def param_specs_tp(params: LlamaParams = None) -> LlamaParams:
    """Partition specs matching `params`' structure (stacked or unrolled,
    fused or unfused).  With no argument: stacked unfused (legacy)."""
    if params is not None and isinstance(params.layers, tuple):
        layers = tuple(layer_specs_tp(lp, stacked=False)
                       for lp in params.layers)
    else:
        layers = layer_specs_tp(None if params is None else params.layers,
                                stacked=True)
    return LlamaParams(
        tok_embd=P(MODEL_AXIS, None),  # vocab-parallel rows
        layers=layers,
        norm=P(None),
        output=P(None, MODEL_AXIS),  # vocab-column-parallel
    )


def kv_cache_spec_tp() -> P:
    # [L, B, Hkv, S, Dh]
    return P(None, DATA_AXIS, MODEL_AXIS, None, None)


def layer_cache_spec_tp() -> P:
    # unrolled per-layer cache [B, Hkv, S, Dh]
    return P(DATA_AXIS, MODEL_AXIS, None, None)


def cache_specs_tp(cache):
    """Spec pytree matching a KVCache (stacked) or tuple-of-layers cache."""
    if isinstance(cache, KVCache):
        return KVCache(kv_cache_spec_tp(), kv_cache_spec_tp())
    lay = layer_cache_spec_tp()
    return tuple((lay, lay) for _ in cache)


def shard_cache_tp(cache, mesh: Mesh):
    """Place a KV cache in the TP layout (heads sharded over `model`)."""
    if isinstance(cache, KVCache):
        sh = NamedSharding(mesh, kv_cache_spec_tp())
        return KVCache(jax.device_put(cache.k, sh), jax.device_put(cache.v, sh))
    sh = NamedSharding(mesh, layer_cache_spec_tp())
    return tuple(
        tuple(jax.device_put(a, sh) for a in layer) for layer in cache
    )


def validate_tp(cfg: LlamaConfig, tp: int):
    for name, v in (("n_kv_head", cfg.n_kv_head), ("n_vocab", cfg.n_vocab),
                    ("n_ff", cfg.n_ff)):
        if v % tp:
            raise ValueError(f"tp={tp} must divide {name}={v}")


# ---------------------------------------------------------------------------
# Local (per-shard) computation
# ---------------------------------------------------------------------------


def _embed_vocab_parallel(tok_embd_local, tokens, tp):
    """Vocab-parallel embedding: local gather + psum."""
    v_local = tok_embd_local.shape[0]
    vi = jax.lax.axis_index(MODEL_AXIS)
    local_ids = tokens - vi * v_local
    valid = (local_ids >= 0) & (local_ids < v_local)
    safe = jnp.clip(local_ids, 0, v_local - 1)
    x = tok_embd_local[safe]
    x = jnp.where(valid[..., None], x, jnp.zeros_like(x))
    return jax.lax.psum(x, MODEL_AXIS)


def _layer_forward_tp(cfg: LlamaConfig, tp: int, x, lp: LayerParams, kc, vc,
                      cos, sin, offsets, positions):
    B, T, D = x.shape
    Hl = cfg.n_head // tp  # local q heads
    Hkvl = cfg.n_kv_head // tp
    Dh = cfg.head_dim
    Dql, Dkvl = Hl * Dh, Hkvl * Dh

    if lp.wqkv is not None:
        # Fused projection: the shard was interleaved as [wq_s|wk_s|wv_s]
        # (fuse_params_tp), so the local split uses local widths.
        qkv = matmul(x, lp.wqkv, lp.attn_norm,
                     eps=cfg.rms_norm_eps)  # [B, T, (Dq + 2 Dkv) / tp]
        q = qkv[..., :Dql].reshape(B, T, Hl, Dh)
        k = qkv[..., Dql : Dql + Dkvl].reshape(B, T, Hkvl, Dh)
        v = qkv[..., Dql + Dkvl :].reshape(B, T, Hkvl, Dh)
    else:
        q = matmul(x, lp.wq, lp.attn_norm,
                   eps=cfg.rms_norm_eps).reshape(B, T, Hl, Dh)
        k = matmul(x, lp.wk, lp.attn_norm,
                   eps=cfg.rms_norm_eps).reshape(B, T, Hkvl, Dh)
        v = matmul(x, lp.wv, lp.attn_norm,
                   eps=cfg.rms_norm_eps).reshape(B, T, Hkvl, Dh)
    q = apply_rope(q, cos, sin, cfg.rope_style)
    k = apply_rope(k, cos, sin, cfg.rope_style)

    kc, vc = update_kv_cache(kc, vc, k, v, offsets)
    ctx = attend_cache(q, kc, vc, positions)  # local heads only
    attn = matmul(ctx.reshape(B, T, Dql), lp.wo)  # row-parallel partial
    x = x + jax.lax.psum(attn, MODEL_AXIS)

    if lp.w13 is not None:
        Fl = cfg.n_ff // tp
        gate_up = matmul(x, lp.w13, lp.ffn_norm,
                         eps=cfg.rms_norm_eps)  # [B, T, 2F/tp] as [w1_s|w3_s]
        g, u = gate_up[..., :Fl], gate_up[..., Fl:]
    else:
        g = matmul(x, lp.w1, lp.ffn_norm, eps=cfg.rms_norm_eps)
        u = matmul(x, lp.w3, lp.ffn_norm, eps=cfg.rms_norm_eps)
    gate = jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype)
    ffn = matmul(gate * u, lp.w2)  # row-parallel partial
    x = x + jax.lax.psum(ffn, MODEL_AXIS)
    return x, kc, vc


def _forward_tp(cfg: LlamaConfig, tp: int, params: LlamaParams, tokens, cache,
                offsets):
    """cache: KVCache (stacked layers, lax.scan) or tuple of per-layer
    (k, v) pairs (unrolled python loop).

    Unrolled is the decode-fast form: the stacked scan returns the cache
    as scan ys, which reallocates and rewrites the WHOLE cache every
    step (a cost that grows with the context, fixed the same way on
    one device); the unrolled loop's dynamic_update_slice chains
    alias in place on the donated per-layer buffers.
    """
    x = _embed_vocab_parallel(params.tok_embd, tokens, tp)
    x = x.astype(params.tok_embd.dtype)
    T = tokens.shape[1]
    positions = offsets[:, None] + jnp.arange(T, dtype=offsets.dtype)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    if isinstance(params.layers, tuple):  # unrolled
        new_cache = []
        for lp, (kc, vc) in zip(params.layers, cache):
            x, kc, vc = _layer_forward_tp(
                cfg, tp, x, lp, kc, vc, cos, sin, offsets, positions
            )
            new_cache.append((kc, vc))
        return x, tuple(new_cache)

    def body(x, layer_inputs):
        lp, kc, vc = layer_inputs
        x, kc, vc = _layer_forward_tp(
            cfg, tp, x, lp, kc, vc, cos, sin, offsets, positions
        )
        return x, (kc, vc)

    x, (k_new, v_new) = jax.lax.scan(body, x, (params.layers, cache.k, cache.v))
    return x, KVCache(k_new, v_new)


def _logits_tp(cfg, params, hidden):
    logits_local = matmul(hidden, params.output, params.norm,
                          eps=cfg.rms_norm_eps,
                          accum_dtype=jnp.float32).astype(
        jnp.float32
    )  # [..., V/tp]
    return jax.lax.all_gather(logits_local, MODEL_AXIS, axis=-1, tiled=True)


# ---------------------------------------------------------------------------
# Step functions (mirror runtime.engine.make_prefill_fn / make_decode_fn)
# ---------------------------------------------------------------------------


def make_tp_prefill_fn(cfg: LlamaConfig, mesh: Mesh,
                       params: LlamaParams = None):
    """`params` (structure only) selects stacked vs unrolled and
    fused vs unfused specs; None = legacy stacked unfused."""
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    pspecs = param_specs_tp(params)
    unrolled = params is not None and isinstance(params.layers, tuple)
    cspecs = (cache_specs_tp(tuple(range(cfg.n_layer))) if unrolled
              else KVCache(kv_cache_spec_tp(), kv_cache_spec_tp()))
    bspec = P(DATA_AXIS)

    def local_fn(params, cache, tokens, lengths, offsets):
        h, cache = _forward_tp(cfg, tp, params, tokens, cache, offsets)
        idx = jnp.clip(lengths - 1, 0, tokens.shape[1] - 1)
        h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
        logits = _logits_tp(cfg, params, h_last)
        return cache, logits

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, P(DATA_AXIS, None), bspec, bspec),
        out_specs=(cspecs, P(DATA_AXIS, None)),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def prefill(params, cache, tokens, lengths, offsets):
        return mapped(params, cache, tokens, lengths, offsets)

    return prefill


def make_tp_decode_fn(cfg: LlamaConfig, mesh: Mesh, sampling: SamplingConfig,
                      chunk: int, eos_id=2,
                      params: LlamaParams = None):
    eos0, eos_ids = normalize_eos(eos_id)
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    pspecs = param_specs_tp(params)
    unrolled = params is not None and isinstance(params.layers, tuple)
    cspecs = (cache_specs_tp(tuple(range(cfg.n_layer))) if unrolled
              else KVCache(kv_cache_spec_tp(), kv_cache_spec_tp()))
    bspec = P(DATA_AXIS)

    def local_fn(params, cache, last_tok, offsets, last_n, done, key):
        def step(carry, k):
            cache, tok, off, last_n, done = carry
            h, cache = _forward_tp(cfg, tp, params, tok[:, None], cache, off)
            logits = _logits_tp(cfg, params, h[:, 0])
            nxt = sample(logits, k, sampling, last_n)
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            # Freeze offsets for done/idle slots (see engine.make_decode_fn).
            off = off + jnp.where(done, 0, 1)
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (cache, nxt, off, last_n, done), nxt

        keys = jax.random.split(key, chunk)
        (cache, tok, offsets, last_n, done), toks = jax.lax.scan(
            step, (cache, last_tok, offsets, last_n, done), keys
        )
        return cache, toks.T, offsets, last_n, done

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, bspec, bspec, P(DATA_AXIS, None),
                  bspec, P()),
        out_specs=(cspecs, P(DATA_AXIS, None), bspec,
                   P(DATA_AXIS, None), bspec),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, last_tok, offsets, last_n, done, key):
        return mapped(params, cache, last_tok, offsets, last_n, done, key)

    return decode


def make_tp_decode_fn_dynamic(cfg: LlamaConfig, mesh: Mesh, chunk: int,
                              eos_id: int = 2, params: LlamaParams = None):
    """TP decode chunk with PER-SLOT sampling parameters (the shard_map
    twin of engine.make_decode_fn_dynamic).

    (params, cache, last_tok [B], offsets [B], last_n [B,N], done [B],
     sp: SamplingParams, counters [B])
      -> (cache, tokens [B,chunk], offsets, last_n, done, counters)

    SamplingParams/counters are [B] arrays sharded along the data axis
    like every other per-slot array; `_logits_tp` all-gathers full-vocab
    logits per model shard, so sample_dynamic runs replicated across the
    model axis and identically per slot (each slot keeps its own
    (seed, counter) RNG stream)."""
    from tokenhawk_tpu.sampling import SamplingParams, sample_dynamic

    eos0, eos_ids = normalize_eos(eos_id)
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    pspecs = param_specs_tp(params)
    unrolled = params is not None and isinstance(params.layers, tuple)
    cspecs = (cache_specs_tp(tuple(range(cfg.n_layer))) if unrolled
              else KVCache(kv_cache_spec_tp(), kv_cache_spec_tp()))
    bspec = P(DATA_AXIS)
    sp_spec = SamplingParams(bspec, bspec, bspec, bspec, bspec)

    def local_fn(params, cache, last_tok, offsets, last_n, done, sp, counters):
        def step(carry, _):
            cache, tok, off, last_n, done, counters = carry
            h, cache = _forward_tp(cfg, tp, params, tok[:, None], cache, off)
            logits = _logits_tp(cfg, params, h[:, 0])
            nxt = sample_dynamic(logits, sp, counters, last_n)
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            off = off + jnp.where(done, 0, 1)
            counters = counters + 1
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (cache, nxt, off, last_n, done, counters), nxt

        (cache, tok, offsets, last_n, done, counters), toks = jax.lax.scan(
            step, (cache, last_tok, offsets, last_n, done, counters),
            None, length=chunk,
        )
        return cache, toks.T, offsets, last_n, done, counters

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, bspec, bspec, P(DATA_AXIS, None),
                  bspec, sp_spec, bspec),
        out_specs=(cspecs, P(DATA_AXIS, None), bspec,
                   P(DATA_AXIS, None), bspec, bspec),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, last_tok, offsets, last_n, done, sp, counters):
        return mapped(params, cache, last_tok, offsets, last_n, done,
                      sp, counters)

    return decode


def _draft_cache_specs(cfg_draft: LlamaConfig, params_d: LlamaParams):
    """Draft dense-cache partition specs: batch on data, heads replicated
    (the draft itself is replicated over the model axis).  Form follows
    the draft params: unrolled tuple-of-(k, v) per layer vs stacked
    KVCache (runtime/scheduler.py picks the matching cache)."""
    if params_d is not None and isinstance(params_d.layers, tuple):
        lay = P(DATA_AXIS, None, None, None)
        return tuple((lay, lay) for _ in range(cfg_draft.n_layer))
    dc = P(None, DATA_AXIS, None, None, None)
    return KVCache(dc, dc)


def make_tp_spec_serving_fn(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                            mesh: Mesh, gamma: int, eos_id: int = 2,
                            params: LlamaParams = None,
                            params_d: LlamaParams = None):
    """Greedy speculative round under shard_map TP (the twin of
    speculative.make_spec_serving_fn, dense target cache).

    The draft stays replicated over the model axis (small by
    construction) and batch-sharded over data like every per-slot array;
    the target verify block runs head-sharded through _forward_tp."""
    from tokenhawk_tpu.runtime.speculative import _spec_round_greedy

    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg_target, tp)
    pspecs_t = param_specs_tp(params)
    unrolled = params is not None and isinstance(params.layers, tuple)
    cspecs_t = (cache_specs_tp(tuple(range(cfg_target.n_layer))) if unrolled
                else KVCache(kv_cache_spec_tp(), kv_cache_spec_tp()))
    cspecs_d = _draft_cache_specs(cfg_draft, params_d)
    bspec = P(DATA_AXIS)

    def local_fn(params_d, params_t, cache_d, cache_t, last_tok, offsets,
                 done):
        def tgt_fwd(params_t, seq, cache_t, offsets, adv):
            return _forward_tp(cfg_target, tp, params_t, seq, cache_t,
                               offsets)

        def tgt_logits(params_t, h):
            return _logits_tp(cfg_target, params_t, h)

        return _spec_round_greedy(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd, tgt_logits,
            params_d, params_t, cache_d, cache_t, last_tok, offsets, done)

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(P(), pspecs_t, cspecs_d, cspecs_t, bspec, bspec, bspec),
        out_specs=(cspecs_d, cspecs_t, P(DATA_AXIS, None), bspec, bspec,
                   bspec, bspec),
    )

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets, done):
        return mapped(params_d, params_t, cache_d, cache_t, last_tok,
                      offsets, done)

    return step


def make_tp_spec_serving_fn_sampled(cfg_draft: LlamaConfig,
                                    cfg_target: LlamaConfig, mesh: Mesh,
                                    gamma: int, eos_id: int = 2,
                                    params: LlamaParams = None,
                                    params_d: LlamaParams = None):
    """Sampled (rejection-sampling) speculative round under shard_map TP,
    dense target cache.  Per-slot (seed, counter) RNG streams run on
    replicated-within-model-axis values, so draws are identical on every
    model shard (same argument as make_tp_decode_fn_dynamic)."""
    from tokenhawk_tpu.runtime.speculative import _spec_round_sampled
    from tokenhawk_tpu.sampling import SamplingParams

    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg_target, tp)
    pspecs_t = param_specs_tp(params)
    unrolled = params is not None and isinstance(params.layers, tuple)
    cspecs_t = (cache_specs_tp(tuple(range(cfg_target.n_layer))) if unrolled
                else KVCache(kv_cache_spec_tp(), kv_cache_spec_tp()))
    cspecs_d = _draft_cache_specs(cfg_draft, params_d)
    bspec = P(DATA_AXIS)
    sp_spec = SamplingParams(bspec, bspec, bspec, bspec, bspec)

    def local_fn(params_d, params_t, cache_d, cache_t, last_tok, offsets,
                 done, last_n, sp, counters):
        def tgt_fwd(params_t, seq, cache_t, offsets, adv):
            return _forward_tp(cfg_target, tp, params_t, seq, cache_t,
                               offsets)

        def tgt_logits(params_t, h):
            return _logits_tp(cfg_target, params_t, h)

        return _spec_round_sampled(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd,
            params_d, params_t, cache_d, cache_t, last_tok, offsets, done,
            last_n, sp, counters, target_logits=tgt_logits)

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(P(), pspecs_t, cspecs_d, cspecs_t, bspec, bspec, bspec,
                  P(DATA_AXIS, None), sp_spec, bspec),
        out_specs=(cspecs_d, cspecs_t, P(DATA_AXIS, None), bspec, bspec,
                   bspec, bspec, P(DATA_AXIS, None), bspec),
    )

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets, done,
             last_n, sp, counters):
        return mapped(params_d, params_t, cache_d, cache_t, last_tok,
                      offsets, done, last_n, sp, counters)

    return step


# ---------------------------------------------------------------------------
# Parameter placement / fusion
# ---------------------------------------------------------------------------


def _slice_cols(w, lo: int, hi: int):
    if isinstance(w, QWeight):
        def f(a):
            return None if a is None else a[..., lo:hi]

        return QWeight(qs=f(w.qs), scales=f(w.scales), mins=f(w.mins),
                       scales_hi=f(w.scales_hi), kind=w.kind, group=w.group)
    return w[..., lo:hi]


def _concat_cols(ws):
    if isinstance(ws[0], QWeight):
        from tokenhawk_tpu.ops.qweight import concat_qweights

        return concat_qweights(ws)
    return jnp.concatenate(ws, axis=-1)


def fuse_params_tp(cfg: LlamaConfig, params: LlamaParams, tp: int) -> LlamaParams:
    """Fuse wq|wk|wv -> wqkv and w1|w3 -> w13 with per-shard interleaving.

    Plain concatenation + output-dim sharding would put the wq/wk
    boundary inside a shard; instead shard s of the fused matrix is
    [wq_s | wk_s | wv_s], so each TP rank slices its local q/k/v at the
    LOCAL widths (see _layer_forward_tp).  Column slicing is always
    group-quantization-safe (groups run down K).
    """
    if isinstance(params.layers, tuple):
        raise ValueError("fuse before unstacking (stacked [L,...] layers)")
    validate_tp(cfg, tp)

    def interleave(ws):
        widths = [w.shape[-1] for w in ws]
        parts = []
        for s in range(tp):
            for w, n in zip(ws, widths):
                parts.append(_slice_cols(w, s * n // tp, (s + 1) * n // tp))
        return _concat_cols(parts)

    lp = params.layers
    layers = dataclasses.replace(
        lp,
        wqkv=interleave([lp.wq, lp.wk, lp.wv]),
        w13=interleave([lp.w1, lp.w3]),
        wq=None, wk=None, wv=None, w1=None, w3=None,
    )
    return dataclasses.replace(params, layers=layers)


def shard_params_tp(cfg: LlamaConfig, params: LlamaParams, mesh: Mesh) -> LlamaParams:
    """Place params in the shard_map TP layout.

    NOTE: q4_0 row-parallel weights (wo, w2) must have been packed with
    k_shards=tp (see ops.qweight.pack_q4_rows); the loader does this when
    given a mesh.
    """
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    specs = param_specs_tp(params)

    def place(leaf, spec):
        sh = NamedSharding(mesh, spec)
        if isinstance(leaf, QWeight):
            def put(x):
                return None if x is None else jax.device_put(x, sh)

            return QWeight(
                qs=jax.device_put(leaf.qs, sh),
                scales=jax.device_put(leaf.scales, sh),
                mins=put(leaf.mins),
                scales_hi=put(leaf.scales_hi),
                kind=leaf.kind,
                group=leaf.group,
            )
        return jax.device_put(leaf, sh)

    return jax.tree_util.tree_map(
        place, params, specs,
        is_leaf=lambda x: isinstance(x, (QWeight, jax.Array)) or hasattr(x, "shape"),
    )


def stack_params_tp(params: LlamaParams, mesh: Mesh) -> LlamaParams:
    """Stack unrolled per-layer weights directly into the TP-sharded
    stacked [L, ...] form (the lax.scan layout the paged forwards use).

    A plain `stack_params` on sharded per-layer leaves lets XLA pick the
    intermediate layout, which can transiently materialize the full
    stacked weight replicated per device — an OOM for models that only
    fit sharded.  Running the stack under jit with `out_shardings`
    pinned to the TP specs keeps every intermediate sharded: the
    stacked arrays are born in their final head/column placement.
    """
    from tokenhawk_tpu.models.llama import stack_params

    if not isinstance(params.layers, tuple):
        return params
    abs_out = jax.eval_shape(stack_params, params)
    specs = param_specs_tp(abs_out)
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), specs,
        is_leaf=lambda x: isinstance(x, P))
    return jax.jit(stack_params, out_shardings=shardings)(params)
