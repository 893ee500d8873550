"""Pipeline parallelism: layer-stage sharding with microbatched prefill.

The model's layers split into `pp` contiguous stages over the "stage"
mesh axis; stage boundaries exchange only the [*, T, D] activation via
`ppermute`, which is why this is the axis meant to cross hosts (70B,
SURVEY §2.6) — TP all-reduces per layer, PP hops once per stage.

Layout: params stay in the STACKED form (LlamaParams.layers leaves
[L, ...]) with the layer axis sharded P("stage"); inside shard_map each
stage sees its own [L/pp, ...] slab and runs the SAME per-layer body as
the single-chip model (models/llama._layer_forward — pallas kernels
included), looping its local layers with static-index writes into its
[L/pp, B, Hkv, S, Dh] cache shard.  Embedding/final-norm/head are
replicated (activation-sized work, weight-stream cost only on the
stages that use them — inactive stages skip them via lax.cond).

Schedules (all collectives outside the conds, so control flow may
diverge per device):

  * prefill — GPipe: the batch splits into M microbatches; tick t has
    stage s processing microbatch (t - s), so all stages are busy in
    the steady state and the bubble is (pp-1)/(M+pp-1).  Hidden states
    ride a stage ring (`ppermute` i -> i+1); stage 0 injects embeddings,
    the last stage collects last-token logits, masked-psum broadcasts
    them at the end.
  * decode — stage-serial ring: each token's hidden visits the stages
    in order (pp ticks); only the holding stage runs its layers
    (lax.cond skips both the FLOPs and the weight stream elsewhere) and
    only it writes its KV slot.  Logits compute on the last stage and
    masked-psum to all.  Single-token decode keeps 1/pp utilization by
    construction — PP earns its keep on prefill and on weight capacity,
    not decode latency; pair with TP for the latter.

The reference has no multi-device execution at all (SURVEY §2.6); PP is
listed there for the 70B-class multi-host config.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import (
    KVCache,
    LlamaParams,
    _layer_forward,
    logits_from_hidden,
)
from tokenhawk_tpu.ops import rope_cos_sin
from tokenhawk_tpu.parallel.mesh import DATA_AXIS, STAGE_AXIS
from tokenhawk_tpu.parallel.tp import shard_map
from tokenhawk_tpu.sampling import is_eos as _is_eos
from tokenhawk_tpu.sampling import normalize_eos, sample


def validate_pp(cfg: LlamaConfig, pp: int):
    if cfg.n_layer % pp:
        raise ValueError(f"pp={pp} must divide n_layer={cfg.n_layer}")


def param_specs_pp(params: LlamaParams) -> LlamaParams:
    """Stacked-layer leaves shard on the layer axis; the rest replicate."""
    lay = jax.tree_util.tree_map(lambda _: P(STAGE_AXIS), params.layers)
    return LlamaParams(
        tok_embd=P(), layers=lay, norm=P(),
        output=jax.tree_util.tree_map(lambda _: P(), params.output),
    )


def cache_specs_pp() -> KVCache:
    # [L, B, Hkv, S, Dh]: layers over stage, batch over data.
    spec = P(STAGE_AXIS, DATA_AXIS)
    return KVCache(spec, spec)


def shard_params_pp(cfg: LlamaConfig, params: LlamaParams, mesh: Mesh) -> LlamaParams:
    validate_pp(cfg, mesh.shape[STAGE_AXIS])
    if isinstance(params.layers, tuple):
        raise ValueError("PP path expects stacked params (not unstack_params)")
    specs = param_specs_pp(params)
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs
    )


def shard_cache_pp(cache: KVCache, mesh: Mesh) -> KVCache:
    sh = NamedSharding(mesh, P(STAGE_AXIS, DATA_AXIS))
    return KVCache(jax.device_put(cache.k, sh), jax.device_put(cache.v, sh))


def _ring(pp: int):
    return [(i, (i + 1) % pp) for i in range(pp)]


def _stage_layers(cfg, params, x, kc, vc, cos, sin, offsets, positions,
                  batch0=None):
    """Run this stage's local layers over x, updating the local cache.

    kc/vc: [L_loc, B, Hkv, S, Dh].  batch0 (traced scalar) selects a
    microbatch window of the cache matching x's batch; None = full batch.
    """
    layers = params.layers
    L_loc = layers.attn_norm.shape[0]
    mb = x.shape[0]
    for l in range(L_loc):
        lp = jax.tree_util.tree_map(lambda a: a[l], layers)
        if batch0 is None:
            lcache = (kc[l], vc[l])
        else:
            dims = kc.shape[2:]
            lcache = (
                jax.lax.dynamic_slice(kc, (l, batch0, 0, 0, 0), (1, mb, *dims))[0],
                jax.lax.dynamic_slice(vc, (l, batch0, 0, 0, 0), (1, mb, *dims))[0],
            )
        x, (k2, v2) = _layer_forward(
            cfg, x, lp, lcache, cos, sin, offsets, positions
        )
        b0 = 0 if batch0 is None else batch0
        kc = jax.lax.dynamic_update_slice(kc, k2[None], (l, b0, 0, 0, 0))
        vc = jax.lax.dynamic_update_slice(vc, v2[None], (l, b0, 0, 0, 0))
    return x, kc, vc


def _pick_microbatches(B: int, want: int) -> int:
    m = min(want, B)
    while B % m:
        m -= 1
    return m


def make_pp_prefill_fn(cfg: LlamaConfig, mesh: Mesh, params: LlamaParams,
                       n_micro: int = 4):
    """GPipe prefill over the (data, stage) mesh.

    (params, cache, tokens [B,T], lengths [B], offsets [B])
      -> (cache, last_logits [B,V])
    """
    pp = mesh.shape[STAGE_AXIS]
    validate_pp(cfg, pp)
    pspecs = param_specs_pp(params)
    cspecs = cache_specs_pp()
    bspec = P(DATA_AXIS)

    def local_fn(params, cache, tokens, lengths, offsets):
        B, T = tokens.shape
        M = _pick_microbatches(B, n_micro)
        mb = B // M
        sidx = jax.lax.axis_index(STAGE_AXIS)
        kc, vc = cache
        D = params.tok_embd.shape[1]
        V = cfg.n_vocab
        h = jnp.zeros((mb, T, D), params.tok_embd.dtype)
        logits_buf = jnp.zeros((B, V), jnp.float32)

        for t in range(M + pp - 1):
            m = t - sidx  # microbatch at this stage this tick
            active = (m >= 0) & (m < M)
            mc = jnp.clip(m, 0, M - 1)
            b0 = mc * mb
            toks_m = jax.lax.dynamic_slice(tokens, (b0, 0), (mb, T))
            off_m = jax.lax.dynamic_slice(offsets, (b0,), (mb,))
            len_m = jax.lax.dynamic_slice(lengths, (b0,), (mb,))
            positions = off_m[:, None] + jnp.arange(T)[None, :]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

            # Stage 0 injects the fresh microbatch's embeddings.
            inject = (sidx == 0) & (t < M)
            h0 = params.tok_embd[toks_m].astype(params.tok_embd.dtype)
            h = jnp.where(inject, h0, h)

            def run(ops):
                h, kc, vc = ops
                return _stage_layers(cfg, params, h, kc, vc, cos, sin,
                                     off_m, positions, batch0=b0)

            h, kc, vc = jax.lax.cond(active, run, lambda ops: ops, (h, kc, vc))

            # Last stage: collect this microbatch's last-token logits.
            def collect(buf):
                idx = jnp.clip(len_m - 1, 0, T - 1)
                h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
                lg = logits_from_hidden(cfg, params, h_last).astype(jnp.float32)
                return jax.lax.dynamic_update_slice(buf, lg, (b0, 0))

            logits_buf = jax.lax.cond(
                active & (sidx == pp - 1), collect, lambda b: b, logits_buf
            )

            h = jax.lax.ppermute(h, STAGE_AXIS, _ring(pp))

        # Only the last stage holds real logits; broadcast.
        mask = (sidx == pp - 1).astype(logits_buf.dtype)
        logits = jax.lax.psum(logits_buf * mask, STAGE_AXIS)
        return KVCache(kc, vc), logits

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, P(DATA_AXIS, None), bspec, bspec),
        out_specs=(cspecs, P(DATA_AXIS, None)),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def prefill(params, cache, tokens, lengths, offsets):
        return mapped(params, KVCache(*cache), tokens, lengths, offsets)

    return prefill


def make_pp_decode_fn(cfg: LlamaConfig, mesh: Mesh, sampling: SamplingConfig,
                      chunk: int, eos_id: int = 2,
                      params: LlamaParams = None):
    """Stage-serial PP decode chunk (Engine-compatible signature)."""
    eos0, eos_ids = normalize_eos(eos_id)
    pp = mesh.shape[STAGE_AXIS]
    validate_pp(cfg, pp)
    pspecs = param_specs_pp(params)
    cspecs = cache_specs_pp()
    bspec = P(DATA_AXIS)

    def local_fn(params, cache, last_tok, offsets, last_n, done, key):
        sidx = jax.lax.axis_index(STAGE_AXIS)
        V = cfg.n_vocab

        def step(carry, k):
            cache, tok, off, last_n, done = carry
            kc, vc = cache
            x = params.tok_embd[tok[:, None]].astype(params.tok_embd.dtype)
            positions = off[:, None]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

            for j in range(pp):
                def run(ops):
                    h, kc, vc = ops
                    return _stage_layers(cfg, params, h, kc, vc, cos, sin,
                                         off, positions)

                x, kc, vc = jax.lax.cond(
                    sidx == j, run, lambda ops: ops, (x, kc, vc)
                )
                if j < pp - 1:
                    x = jax.lax.ppermute(x, STAGE_AXIS, _ring(pp))

            B = tok.shape[0]
            logits = jax.lax.cond(
                sidx == pp - 1,
                lambda h: logits_from_hidden(cfg, params, h[:, 0]).astype(
                    jnp.float32),
                lambda h: jnp.zeros((B, V), jnp.float32),
                x,
            )
            logits = jax.lax.psum(logits, STAGE_AXIS)

            nxt = sample(logits, k, sampling, last_n)  # replicated: same key
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            off = off + jnp.where(done, 0, 1)
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (KVCache(kc, vc), nxt, off, last_n, done), nxt

        keys = jax.random.split(key, chunk)
        (cache, tok, offsets, last_n, done), toks = jax.lax.scan(
            step, (cache, last_tok, offsets, last_n, done), keys
        )
        return KVCache(*cache), toks.T, offsets, last_n, done

    mapped = shard_map(
        local_fn, mesh,
        in_specs=(pspecs, cspecs, bspec, bspec, P(DATA_AXIS, None),
                  bspec, P()),
        out_specs=(cspecs, P(DATA_AXIS, None), bspec,
                   P(DATA_AXIS, None), bspec),
    )

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, last_tok, offsets, last_n, done, key):
        return mapped(params, KVCache(*cache), last_tok, offsets, last_n,
                      done, key)

    return decode
