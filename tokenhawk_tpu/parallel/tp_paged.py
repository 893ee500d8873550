"""Tensor-parallel PAGED serving: the production scheduler's page-pool
path under shard_map.

The page pool [L, Hkv, n_pages, ps, Dh] shards along the KV-head axis —
the same Megatron head split as the dense TP path (parallel/tp.py), so
column-parallel wqkv/w13 shards produce exactly the local heads whose
pages live on the shard, attention is fully local, and the row-parallel
wo/w2 partials all-reduce over NVLink.  Page TABLES, lengths, and token ids
stay replicated (they are tiny host-driven control state); the paged
forwards themselves run per shard with a LOCAL head-count config and
psum hooks (models/llama.py forward_paged_* psum_axis).

This gives the full production serving stack — continuous batching,
chunked prefill, automatic prefix caching (page reuse is index-level and
device-layout agnostic), per-request sampling, int8 pages (scale pages
shard along the same head axis as their payloads), and speculative
decoding (draft replicated per shard, target verify under psum hooks) —
on tensor-sharded models: BASELINE configs 4-5.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import (
    forward_paged_decode,
    forward_paged_prefill,
    forward_paged_prefill_cont,
)
from tokenhawk_tpu.parallel.mesh import MODEL_AXIS
from tokenhawk_tpu.parallel.tp import (
    _logits_tp,
    param_specs_tp,
    shard_map,
    validate_tp,
)
from tokenhawk_tpu.runtime.paged import PagedKVCache
from tokenhawk_tpu.sampling import is_eos as _is_eos
from tokenhawk_tpu.sampling import normalize_eos

EOS_ID = 2


def paged_cache_spec_tp(quant: bool = False):
    """Page-pool partition specs: heads sharded, everything else local.

    bf16: payload pages [L, Hkv, n_pages, ps, Dh] (head layout) or
    [L, n_pages, Hkv, ps, Dh] (contig layout — THAWK_POOL_LAYOUT).
    int8: payload pages plus per-token scale pages — the scales shard
    along the SAME head axis as their payloads, so quantize-on-append
    and the int8 attention kernels stay fully local per shard."""
    from tokenhawk_tpu.runtime.paged import _contig

    if _contig():
        s = P(None, None, MODEL_AXIS, None, None)
        sc = P(None, None, MODEL_AXIS, None)
    else:
        s = P(None, MODEL_AXIS, None, None, None)
        sc = P(None, MODEL_AXIS, None, None)
    if quant:
        from tokenhawk_tpu.runtime.paged import PagedQuantKVCache

        return PagedQuantKVCache(s, sc, s, sc)
    return PagedKVCache(s, s)


def shard_paged_cache_tp(cache, mesh: Mesh):
    from tokenhawk_tpu.runtime.paged import PagedQuantKVCache

    specs = paged_cache_spec_tp(quant=isinstance(cache, PagedQuantKVCache))
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        cache, specs)


def make_tp_paged_prefill_fn(cfg: LlamaConfig, mesh: Mesh,
                             params=None, quant: bool = False):
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    pspecs = param_specs_tp(params)
    cspecs = paged_cache_spec_tp(quant)
    rep = P()

    def local_fn(params, cache, tokens, lengths, table_row):
        h, cache = forward_paged_prefill(
            cfg, params, tokens, cache, table_row, lengths,
            psum_axis=MODEL_AXIS, tp=tp)
        idx = jnp.clip(lengths - 1, 0, tokens.shape[1] - 1)
        h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
        logits = _logits_tp(cfg, params, h_last)
        return cache, logits

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, rep, rep, rep),
        out_specs=(cspecs, rep),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def prefill(params, cache, tokens, lengths, table_row):
        return mapped(params, cache, tokens, lengths, table_row)

    return prefill


def make_tp_paged_prefill_cont_fn(cfg: LlamaConfig, mesh: Mesh,
                                  params=None, quant: bool = False):
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    pspecs = param_specs_tp(params)
    cspecs = paged_cache_spec_tp(quant)
    rep = P()

    def local_fn(params, cache, tokens, table_row, start, n_new):
        h, cache = forward_paged_prefill_cont(
            cfg, params, tokens, cache, table_row, start, n_new,
            psum_axis=MODEL_AXIS, tp=tp)
        idx = jnp.clip(n_new - 1, 0, tokens.shape[1] - 1)
        h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
        logits = _logits_tp(cfg, params, h_last)
        return cache, logits

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, rep, rep, rep, rep),
        out_specs=(cspecs, rep),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def prefill_cont(params, cache, tokens, table_row, start, n_new):
        return mapped(params, cache, tokens, table_row, start, n_new)

    return prefill_cont


def make_tp_paged_decode_fn_dynamic(cfg: LlamaConfig, mesh: Mesh,
                                    chunk: int, eos_id: int = EOS_ID,
                                    params=None, quant: bool = False):
    """Chunked paged decode with per-slot sampling under shard_map TP.

    Sampling runs REPLICATED per shard on the all-gathered logits (same
    per-slot counter streams -> identical draws on every shard), so
    token feedback never leaves the mesh mid-chunk.
    """
    from tokenhawk_tpu.sampling import sample_dynamic

    eos0, eos_ids = normalize_eos(eos_id)
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    pspecs = param_specs_tp(params)
    cspecs = paged_cache_spec_tp(quant)
    rep = P()

    def local_fn(params, cache, table, last_tok, lengths, last_n, done,
                 sp, counters):
        def step(carry, _):
            cache, tok, lens, last_n, done, counters = carry
            h, cache = forward_paged_decode(
                cfg, params, tok[:, None], cache, table, lens,
                psum_axis=MODEL_AXIS, tp=tp)
            logits = _logits_tp(cfg, params, h[:, 0])
            nxt = sample_dynamic(logits, sp, counters, last_n)
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            lens = lens + jnp.where(done, 0, 1)
            counters = counters + 1
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (cache, nxt, lens, last_n, done, counters), nxt

        (cache, tok, lengths, last_n, done, counters), toks = jax.lax.scan(
            step, (cache, last_tok, lengths, last_n, done, counters),
            None, length=chunk,
        )
        # last_n rides out of the scan (replicated: sampling is identical
        # per shard) so the scheduler skips a host-side ring rebuild.
        return cache, toks.T, done, counters, last_n

    sp_spec = jax.tree_util.tree_map(lambda _: rep,
                                     _sp_structure())
    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, rep, rep, rep, rep, rep, sp_spec, rep),
        out_specs=(cspecs, rep, rep, rep, rep),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, table, last_tok, lengths, last_n, done, sp,
               counters):
        return mapped(params, cache, table, last_tok, lengths, last_n,
                      done, sp, counters)

    return decode


def _sp_structure():
    """A SamplingParams pytree skeleton for spec construction."""
    from tokenhawk_tpu.sampling import SamplingParams

    z = jnp.zeros((1,))
    return SamplingParams(temperature=z, top_k=z, top_p=z,
                          repeat_penalty=z, seed=z)


def make_tp_spec_serving_fn_paged(cfg_draft: LlamaConfig,
                                  cfg_target: LlamaConfig, mesh: Mesh,
                                  gamma: int, eos_id: int = EOS_ID,
                                  params=None):
    """Greedy speculative round under shard_map TP (the twin of
    speculative.make_spec_serving_fn_paged).

    The DRAFT stays replicated (params, dense cache, its forwards) — a
    draft is small by construction, so every shard runs the identical
    draft computation locally and no collective touches it.  The TARGET
    verify runs head-sharded through forward_paged_verify's psum hooks;
    its logits all-gather over the vocab shards, after which the
    accept/EOS/freeze math is replicated per shard (deterministic, so
    identical everywhere)."""
    from tokenhawk_tpu.models.llama import forward_paged_verify
    from tokenhawk_tpu.runtime.speculative import _spec_round_greedy

    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg_target, tp)
    pspecs_t = param_specs_tp(params)
    cspecs_t = paged_cache_spec_tp()
    rep = P()

    def local_fn(params_d, params_t, cache_d, cache_t, table, last_tok,
                 lengths, done):
        def tgt_fwd(params_t, seq, cache_t, lengths, adv):
            return forward_paged_verify(
                cfg_target, params_t, seq, cache_t, table, lengths, adv,
                psum_axis=MODEL_AXIS, tp=tp)

        def tgt_logits(params_t, h):
            return _logits_tp(cfg_target, params_t, h)

        return _spec_round_greedy(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd, tgt_logits,
            params_d, params_t, cache_d, cache_t, last_tok, lengths, done)

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(rep, pspecs_t, rep, cspecs_t, rep, rep, rep, rep),
        out_specs=(rep, cspecs_t, rep, rep, rep, rep, rep),
    )

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, table, last_tok,
             lengths, done):
        return mapped(params_d, params_t, cache_d, cache_t, table,
                      last_tok, lengths, done)

    return step


def make_tp_spec_serving_fn_paged_sampled(cfg_draft: LlamaConfig,
                                          cfg_target: LlamaConfig,
                                          mesh: Mesh, gamma: int,
                                          eos_id: int = EOS_ID,
                                          params=None):
    """Sampled (rejection-sampling) speculative round under shard_map TP.

    Same replication story as the greedy twin; every random draw keys on
    per-slot (seed, counter) streams over replicated values, so draft
    proposals, accept tests, and residual draws are identical on every
    shard."""
    from tokenhawk_tpu.models.llama import forward_paged_verify
    from tokenhawk_tpu.runtime.speculative import _spec_round_sampled

    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg_target, tp)
    pspecs_t = param_specs_tp(params)
    cspecs_t = paged_cache_spec_tp()
    rep = P()
    sp_spec = jax.tree_util.tree_map(lambda _: rep, _sp_structure())

    def local_fn(params_d, params_t, cache_d, cache_t, table, last_tok,
                 lengths, done, last_n, sp, counters):
        def tgt_fwd(params_t, seq, cache_t, lengths, adv):
            return forward_paged_verify(
                cfg_target, params_t, seq, cache_t, table, lengths, adv,
                psum_axis=MODEL_AXIS, tp=tp)

        def tgt_logits(params_t, h):
            return _logits_tp(cfg_target, params_t, h)

        return _spec_round_sampled(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd,
            params_d, params_t, cache_d, cache_t, last_tok, lengths, done,
            last_n, sp, counters, target_logits=tgt_logits)

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(rep, pspecs_t, rep, cspecs_t, rep, rep, rep, rep, rep,
                  sp_spec, rep),
        out_specs=(rep, cspecs_t, rep, rep, rep, rep, rep, rep, rep),
    )

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, table, last_tok,
             lengths, done, last_n, sp, counters):
        return mapped(params_d, params_t, cache_d, cache_t, table,
                      last_tok, lengths, done, last_n, sp, counters)

    return step
