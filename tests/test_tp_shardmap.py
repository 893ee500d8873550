"""shard_map tensor-parallel path vs single-device reference (CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.ggml.format import GGMLType
from tokenhawk_tpu.ggml.quants import quantize
from tokenhawk_tpu.models.llama import KVCache, params_from_ggml
from tokenhawk_tpu.parallel import make_mesh
from tokenhawk_tpu.parallel.tp import (
    make_tp_decode_fn,
    make_tp_prefill_fn,
    shard_params_tp,
)
from tokenhawk_tpu.runtime.engine import Engine, make_prefill_fn
from tokenhawk_tpu.tokenizer import byte_fallback_vocab

from helpers import make_ggml_weights

CFG = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=4, n_ctx=64, n_ff=512)
GREEDY = SamplingConfig(temperature=0.0)


@pytest.fixture(scope="module")
def tensors():
    return make_ggml_weights(CFG, np.random.default_rng(31))


def _quant(tensors, kind):
    return {
        k: (quantize(v, kind)
            if v.ndim == 2 and "norm" not in k and k != "tok_embeddings.weight"
            else v)
        for k, v in tensors.items()
    }


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 4), (1, 2)])
def test_tp_prefill_matches_reference(tensors, dp, tp):
    mesh = make_mesh(dp=dp, tp=tp)
    params = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    params_tp = shard_params_tp(
        CFG, params_from_ggml(CFG, tensors, dtype=jnp.float32,
                              row_parallel_shards=tp), mesh)

    B = dp * 2
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(1, CFG.n_vocab, (B, 16)), jnp.int32)
    lens = jnp.full((B,), 16, jnp.int32)
    offs = jnp.zeros((B,), jnp.int32)

    ref_prefill = make_prefill_fn(CFG)
    cache = KVCache.create(CFG, B, 64, jnp.float32)
    _, want = ref_prefill(params, cache, toks, lens, offs)

    tp_prefill = make_tp_prefill_fn(CFG, mesh)
    cache2 = KVCache.create(CFG, B, 64, jnp.float32)
    _, got = tp_prefill(params_tp, cache2, toks, lens, offs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=2e-4)


def test_tp_engine_generation_matches(tensors):
    mesh = make_mesh(dp=1, tp=4)
    params = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    params_tp = shard_params_tp(
        CFG, params_from_ggml(CFG, tensors, dtype=jnp.float32,
                              row_parallel_shards=4), mesh)
    tok = byte_fallback_vocab()

    e_ref = Engine(CFG, params, tokenizer=tok, sampling=GREEDY,
                   cache_dtype=jnp.float32, decode_chunk=4)
    e_tp = Engine(CFG, params_tp, tokenizer=tok, sampling=GREEDY,
                  cache_dtype=jnp.float32, decode_chunk=4,
                  mesh=mesh, parallel="tp")
    want = e_ref.generate([1, 9, 17, 33], max_new_tokens=8).tokens
    got = e_tp.generate([1, 9, 17, 33], max_new_tokens=8).tokens
    assert got == want


@pytest.mark.parametrize("kind", [GGMLType.Q8_0, GGMLType.Q4_0])
def test_tp_quantized_generation_matches(tensors, kind):
    """Quantized weights under shard_map TP (incl. per-shard q4 packing)."""
    tp = 4
    mesh = make_mesh(dp=1, tp=tp)
    qt = _quant(tensors, kind)
    params = params_from_ggml(CFG, qt, dtype=jnp.float32)
    params_tp = shard_params_tp(
        CFG, params_from_ggml(CFG, qt, dtype=jnp.float32,
                              row_parallel_shards=tp), mesh)
    tok = byte_fallback_vocab()

    e_ref = Engine(CFG, params, tokenizer=tok, sampling=GREEDY,
                   cache_dtype=jnp.float32, decode_chunk=4)
    e_tp = Engine(CFG, params_tp, tokenizer=tok, sampling=GREEDY,
                  cache_dtype=jnp.float32, decode_chunk=4,
                  mesh=mesh, parallel="tp")
    want = e_ref.generate([1, 5, 25], max_new_tokens=6).tokens
    got = e_tp.generate([1, 5, 25], max_new_tokens=6).tokens
    assert got == want


def test_tp_validation_rejects_bad_widths(tensors):
    mesh = make_mesh(dp=1, tp=8)  # 8 does not divide n_kv_head=4
    params = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    with pytest.raises(ValueError):
        shard_params_tp(CFG, params, mesh)


def test_tp_scheduler_matches(tensors):
    from tokenhawk_tpu.runtime.scheduler import Scheduler

    tp = 4
    mesh = make_mesh(dp=1, tp=tp)
    params = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    params_tp = shard_params_tp(
        CFG, params_from_ggml(CFG, tensors, dtype=jnp.float32,
                              row_parallel_shards=tp), mesh)

    s_ref = Scheduler(CFG, params, sampling=GREEDY, max_batch=2,
                      cache_dtype=jnp.float32, decode_chunk=4)
    s_tp = Scheduler(CFG, params_tp, sampling=GREEDY, max_batch=2,
                     cache_dtype=jnp.float32, decode_chunk=4,
                     mesh=mesh, parallel="tp")
    prompts = [[1, 8, 16], [1, 64, 128, 192]]
    want = [r.output for r in s_ref.generate_many(prompts, max_new_tokens=6)]
    got = [r.output for r in s_tp.generate_many(prompts, max_new_tokens=6)]
    assert got == want


def test_tp_per_request_sampling(tensors):
    """Per-request sampling params under shard_map TP: a greedy request
    keeps its solo-greedy output while its neighbour samples with a
    different temperature/seed, reproducibly (parallel/tp.py
    make_tp_decode_fn_dynamic)."""
    from tokenhawk_tpu.runtime.scheduler import Request, Scheduler

    tp = 4
    mesh = make_mesh(dp=1, tp=tp)
    params_tp = shard_params_tp(
        CFG, params_from_ggml(CFG, tensors, dtype=jnp.float32,
                              row_parallel_shards=tp), mesh)
    greedy_cfg = SamplingConfig(temperature=0.0)
    stoch_cfg = SamplingConfig(temperature=1.0, top_k=0, top_p=1.0,
                               repeat_penalty=1.0, seed=1234)

    solo = Scheduler(CFG, params_tp, sampling=greedy_cfg, max_batch=2,
                     cache_dtype=jnp.float32, decode_chunk=4,
                     mesh=mesh, parallel="tp")
    want_greedy = solo.generate_many([[1, 5, 9]], max_new_tokens=6)[0].output

    def run_pair(order):
        s = Scheduler(CFG, params_tp, sampling=greedy_cfg, max_batch=2,
                      cache_dtype=jnp.float32, decode_chunk=4,
                      mesh=mesh, parallel="tp")
        reqs = [Request(prompt=[1, 5, 9], max_new_tokens=6,
                        sampling=greedy_cfg),
                Request(prompt=[1, 7, 2, 9], max_new_tokens=6,
                        sampling=stoch_cfg)]
        for r in (reqs if order else reqs[::-1]):
            s.submit(r)
        s.run()
        return reqs

    a = run_pair(True)
    b = run_pair(False)
    assert a[0].output == want_greedy
    assert b[0].output == want_greedy
    assert a[1].output == b[1].output
    assert all(0 <= t < CFG.n_vocab for t in a[1].output)


def test_tp_gqa_generation_matches():
    """GQA (Llama-2-70B shape class): q heads share KV heads under TP."""
    cfg = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=8, n_kv_head=2,
                           n_ctx=64, n_ff=512)
    tensors = make_ggml_weights(cfg, np.random.default_rng(53))
    tp = 2  # tp must divide n_kv_head=2
    mesh = make_mesh(dp=1, tp=tp)
    params = params_from_ggml(cfg, tensors, dtype=jnp.float32)
    params_tp = shard_params_tp(
        cfg, params_from_ggml(cfg, tensors, dtype=jnp.float32,
                              row_parallel_shards=tp), mesh)
    tok = byte_fallback_vocab()
    e_ref = Engine(cfg, params, tokenizer=tok, sampling=GREEDY,
                   cache_dtype=jnp.float32, decode_chunk=4)
    e_tp = Engine(cfg, params_tp, tokenizer=tok, sampling=GREEDY,
                  cache_dtype=jnp.float32, decode_chunk=4,
                  mesh=mesh, parallel="tp")
    want = e_ref.generate([1, 11, 22, 33], max_new_tokens=6).tokens
    got = e_tp.generate([1, 11, 22, 33], max_new_tokens=6).tokens
    assert got == want


def _unrolled_tp_params(cfg, tensors, tp, mesh):
    from tokenhawk_tpu.models.llama import unstack_params
    from tokenhawk_tpu.parallel.tp import fuse_params_tp

    p = params_from_ggml(cfg, tensors, dtype=jnp.float32,
                         row_parallel_shards=tp)
    return shard_params_tp(cfg, unstack_params(fuse_params_tp(cfg, p, tp)),
                           mesh)


def test_tp_unrolled_fused_generation_matches(tensors):
    """Decode-fast TP form (interleaved fused wqkv/w13 + unrolled layers +
    in-place KV updates) produces the same tokens as the reference."""
    tp = 4
    mesh = make_mesh(dp=1, tp=tp)
    params = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    params_tp = _unrolled_tp_params(CFG, tensors, tp, mesh)
    tok = byte_fallback_vocab()
    e_ref = Engine(CFG, params, tokenizer=tok, sampling=GREEDY,
                   cache_dtype=jnp.float32, decode_chunk=4)
    e_tp = Engine(CFG, params_tp, tokenizer=tok, sampling=GREEDY,
                  cache_dtype=jnp.float32, decode_chunk=4,
                  mesh=mesh, parallel="tp")
    want = e_ref.generate([1, 9, 17, 33], max_new_tokens=8).tokens
    got = e_tp.generate([1, 9, 17, 33], max_new_tokens=8).tokens
    assert got == want


@pytest.mark.parametrize("kind", [GGMLType.Q8_0, GGMLType.Q4_0])
def test_tp_unrolled_fused_quantized_matches(tensors, kind):
    tp = 4
    mesh = make_mesh(dp=1, tp=tp)
    qt = _quant(tensors, kind)
    params = params_from_ggml(CFG, qt, dtype=jnp.float32)
    params_tp = _unrolled_tp_params(CFG, qt, tp, mesh)
    tok = byte_fallback_vocab()
    e_ref = Engine(CFG, params, tokenizer=tok, sampling=GREEDY,
                   cache_dtype=jnp.float32, decode_chunk=4)
    e_tp = Engine(CFG, params_tp, tokenizer=tok, sampling=GREEDY,
                  cache_dtype=jnp.float32, decode_chunk=4,
                  mesh=mesh, parallel="tp")
    want = e_ref.generate([1, 5, 25], max_new_tokens=6).tokens
    got = e_tp.generate([1, 5, 25], max_new_tokens=6).tokens
    assert got == want


def test_tp_unrolled_decode_updates_cache_in_place(tensors):
    """The unrolled TP decode step must not reallocate/rewrite the cache
    per step (the scan-ys rewrite fixed on one device).
    Criterion: compiled temp allocation is far below the cache footprint
    (measured: ~4 KB unrolled vs ~1.8x the whole local cache for the
    stacked-scan form, whose scan-ys rewrite allocates a fresh cache)."""
    from tokenhawk_tpu.models.llama import make_unrolled_cache
    from tokenhawk_tpu.parallel.tp import make_tp_decode_fn, shard_cache_tp

    tp, dp = 4, 2
    mesh = make_mesh(dp=dp, tp=tp)
    params_tp = _unrolled_tp_params(CFG, tensors, tp, mesh)
    B, S = 2, 256
    cache = shard_cache_tp(make_unrolled_cache(CFG, B, S, jnp.float32), mesh)
    decode = make_tp_decode_fn(CFG, mesh, GREEDY, 2, params=params_tp)
    args = (params_tp, cache, jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32), jnp.full((B, 4), -1, jnp.int32),
            jnp.zeros((B,), bool), jax.random.PRNGKey(0))
    compiled = decode.lower(*args).compile()
    temp = compiled.memory_analysis().temp_size_in_bytes
    layer_cache_bytes = 2 * (B // dp) * (CFG.n_kv_head // tp) * S * CFG.head_dim * 4
    assert temp < layer_cache_bytes, (
        f"decode temps {temp} B suggest a cache rewrite "
        f"(one layer's local cache = {layer_cache_bytes} B)"
    )


# ---------------------------------------------------------------------------
# Speculative serving under dense TP (parallel/tp.make_tp_spec_serving_fn*)
# ---------------------------------------------------------------------------

SPEC_DRAFT_CFG = LlamaConfig.tiny(n_vocab=512, n_embd=128, n_head=2,
                                  n_ctx=64, n_ff=128)


def _spec_pair(tensors, tp, draft_seed=0):
    """(single-device spec scheduler, TP spec scheduler), same weights."""
    from tokenhawk_tpu.models.llama import init_params
    from tokenhawk_tpu.runtime.scheduler import Scheduler

    mesh = make_mesh(dp=1, tp=tp)
    params = params_from_ggml(CFG, tensors, dtype=jnp.float32)
    params_tp = shard_params_tp(
        CFG, params_from_ggml(CFG, tensors, dtype=jnp.float32,
                              row_parallel_shards=tp), mesh)
    dparams = init_params(SPEC_DRAFT_CFG, jax.random.PRNGKey(draft_seed),
                          jnp.float32)
    kw = dict(sampling=GREEDY, max_batch=2, cache_dtype=jnp.float32,
              decode_chunk=4, draft_cfg=SPEC_DRAFT_CFG, draft_params=dparams,
              gamma=3)
    s_ref = Scheduler(CFG, params, **kw)
    s_tp = Scheduler(CFG, params_tp, mesh=mesh, parallel="tp", **kw)
    return s_ref, s_tp


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_dense_speculative_greedy(tensors, tp):
    """Dense-scheduler speculation under TP: draft replicated over the
    model axis, target verify head-sharded — greedy outputs bit-match
    the single-device speculative scheduler."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, CFG.n_vocab, n).tolist() for n in (5, 8)]
    s_ref, s_tp = _spec_pair(tensors, tp)
    want = [r.output for r in s_ref.generate_many(prompts, max_new_tokens=7)]
    got = [r.output for r in s_tp.generate_many(prompts, max_new_tokens=7)]
    assert got == want


def test_tp_dense_speculative_sampled(tensors):
    """Sampled (rejection-sampling) speculation under dense TP matches
    the single-device sampled speculative scheduler bit for bit (same
    per-slot seed/counter streams)."""
    from tokenhawk_tpu.runtime.scheduler import Request

    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, CFG.n_vocab, 6).tolist() for _ in range(2)]
    s_ref, s_tp = _spec_pair(tensors, 4, draft_seed=1)
    scfg = SamplingConfig(temperature=0.8, top_k=20, seed=13)

    def run(s):
        reqs = [Request(prompt=list(p), max_new_tokens=6, sampling=scfg)
                for p in prompts]
        for r in reqs:
            s.submit(r)
        s.run()
        return [r.output for r in reqs]

    assert run(s_tp) == run(s_ref)
