"""GSPMD sharding layout for LLaMA weights, activations, and KV cache.

Megatron-style tensor parallelism over the "model" axis:

  wq/wk/wv, w1/w3 : column-parallel  [D, N]    -> P(None, "model")
  wo, w2          : row-parallel     [N, D]    -> P("model", None)
  output (vocab)  : column-parallel  [D, V]    -> P(None, "model")
  tok_embd        : feature-sharded  [V, D]    -> P(None, "model")
  norms           : replicated
  KV cache        : heads on "model", batch on "data"

XLA inserts the all-reduce after the row-parallel contractions — the
multi-chip realization of the reference's split-GEMV + `vector_reduce`
pattern (th.cpp:3795-3912, :4042-4127), with the reduce riding NVLink
instead of a same-device buffer pass.

Quantized weights shard positionally identically: qs [K, N] and
scales/mins [K//32, N] take the same PartitionSpec (the group axis
divides along with K).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import KVCache, LayerParams, LlamaParams
from tokenhawk_tpu.ops.qweight import QWeight
from tokenhawk_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def layer_param_specs() -> LayerParams:
    """PartitionSpecs for the [L]-stacked layer weights."""
    col = P(None, None, MODEL_AXIS)
    row = P(None, MODEL_AXIS, None)
    vec = P(None, None)
    return LayerParams(
        wq=col, wk=col, wv=col, wo=row, w1=col, w2=row, w3=col,
        attn_norm=vec, ffn_norm=vec,
    )


def param_specs() -> LlamaParams:
    return LlamaParams(
        tok_embd=P(None, MODEL_AXIS),
        layers=layer_param_specs(),
        norm=P(None),
        output=P(None, MODEL_AXIS),
    )


def kv_cache_spec() -> P:
    # [L, B, Hkv, S, Dh]
    return P(None, DATA_AXIS, MODEL_AXIS, None, None)


def _place(leaf, spec: P, mesh: Mesh):
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


def shard_params(cfg: LlamaConfig, params: LlamaParams, mesh: Mesh) -> LlamaParams:
    """Place a parameter pytree onto the mesh with the TP layout."""
    tp = mesh.shape[MODEL_AXIS]
    if cfg.n_kv_head % tp:
        raise ValueError(
            f"tensor-parallel width {tp} must divide n_kv_head={cfg.n_kv_head}"
        )
    specs = param_specs()
    return jax.tree_util.tree_map(
        lambda leaf, spec: _place(leaf, spec, mesh),
        params,
        specs,
        is_leaf=lambda x: isinstance(x, (QWeight, jax.Array)) or hasattr(x, "shape"),
    )


def shard_kv_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    sh = NamedSharding(mesh, kv_cache_spec())
    return KVCache(jax.device_put(cache.k, sh), jax.device_put(cache.v, sh))
