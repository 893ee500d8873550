"""int8-quantized paged KV (runtime/paged.py PagedQuantKVCache)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.runtime.paged import (
    PagedKVCache,
    PagedQuantKVCache,
    append_token_layer,
    attend_paged_layer,
    append_token_layer_int8,
    attend_paged_layer_int8,
    paginate_fragment_layer_int8,
)
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler

from helpers import make_ggml_weights

PS = 128
GREEDY = SamplingConfig(temperature=0.0)


def _fill_cache(rng, cfg, Hkv, Dh, B, n_toks, table):
    cache = PagedQuantKVCache.create(cfg, n_pages=6, page_size=PS)
    k_l, ks_l = cache.k_pages[0], cache.ks_pages[0]
    v_l, vs_l = cache.v_pages[0], cache.vs_pages[0]
    lengths = jnp.zeros((B,), jnp.int32)
    for i in range(max(n_toks)):
        k = jnp.asarray(rng.standard_normal((B, Hkv, Dh)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((B, Hkv, Dh)), jnp.float32)
        k_l, ks_l = append_token_layer_int8(k_l, ks_l, k, table, lengths)
        v_l, vs_l = append_token_layer_int8(v_l, vs_l, v, table, lengths)
        lengths = lengths + jnp.asarray([i < n for n in n_toks])
    return (k_l, ks_l, v_l, vs_l), lengths


def _fill_both(rng, cfg, Hkv, Dh, B, n_toks, table):
    """The same tokens appended to an int8 pool and an f32 pool."""
    q8 = PagedQuantKVCache.create(cfg, n_pages=6, page_size=PS)
    f32 = PagedKVCache.create(cfg, n_pages=6, page_size=PS,
                              dtype=jnp.float32)
    k_l, ks_l, v_l, vs_l = (q8.k_pages[0], q8.ks_pages[0], q8.v_pages[0],
                            q8.vs_pages[0])
    kf, vf = f32.k_pages[0], f32.v_pages[0]
    lengths = jnp.zeros((B,), jnp.int32)
    for i in range(max(n_toks)):
        k = jnp.asarray(rng.standard_normal((B, Hkv, Dh)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((B, Hkv, Dh)), jnp.float32)
        k_l, ks_l = append_token_layer_int8(k_l, ks_l, k, table, lengths)
        v_l, vs_l = append_token_layer_int8(v_l, vs_l, v, table, lengths)
        kf = append_token_layer(kf, k, table, lengths)
        vf = append_token_layer(vf, v, table, lengths)
        lengths = lengths + jnp.asarray([i < n for n in n_toks])
    return (k_l, ks_l, v_l, vs_l), (kf, vf), lengths


@pytest.mark.parametrize("rep_heads", [(4, 1), (2, 2)])
def test_paged_int8_attend_matches_f32_pages(rng, rep_heads):
    """int8 pages (plain gather + dequantize path) track f32 pages
    holding the same tokens, on ragged lengths incl. a one-token slot."""
    Hkv, rep = rep_heads
    cfg = LlamaConfig.tiny(n_layer=1, n_head=4, n_kv_head=Hkv)
    Dh = cfg.head_dim
    B = 3
    table = jnp.asarray([[5, 2], [1, 3], [4, 0]], jnp.int32)
    (k_l, ks_l, v_l, vs_l), (kf, vf), lengths = _fill_both(
        rng, cfg, Hkv, Dh, B, [PS + 40, 70, 1], table)
    q = jnp.asarray(rng.standard_normal((B, 1, cfg.n_head, Dh)),
                    jnp.float32)
    want = np.asarray(attend_paged_layer(q, kf, vf, table, lengths))
    got = np.asarray(attend_paged_layer_int8(
        q, k_l, ks_l, v_l, vs_l, table, lengths))
    # per-token int8 rounding of K and V (~0.4% relative each)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_paginate_fragment_int8_roundtrip(rng):
    """Fragment pagination stores the same codes the dense int8
    quantizer produces for the same vectors."""
    from tokenhawk_tpu.ops.kvquant import dequantize_kv, quantize_kv_block

    cfg = LlamaConfig.tiny(n_layer=1, n_head=4, n_kv_head=2)
    Dh, Hkv, B, T = cfg.head_dim, 2, 2, PS + 32
    cache = PagedQuantKVCache.create(cfg, n_pages=6, page_size=PS)
    table = jnp.asarray([[4, 1], [2, 5]], jnp.int32)
    frag = jnp.asarray(rng.standard_normal((B, Hkv, T, Dh)), jnp.float32)
    k_l, ks_l = paginate_fragment_layer_int8(
        cache.k_pages[0], cache.ks_pages[0], frag, table)

    from tokenhawk_tpu.runtime.paged import (
        gather_pool_payload,
        gather_pool_scales,
    )

    got = np.asarray(dequantize_kv(
        gather_pool_payload(k_l, table)[0].reshape(Hkv, 2 * PS, Dh)[:, :T],
        gather_pool_scales(ks_l, table)[0].reshape(Hkv, 2 * PS)[:, :T]))
    q8, sc = quantize_kv_block(frag)
    want = np.asarray(dequantize_kv(q8, sc))[0]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_paged_scheduler_int8_generates(rng):
    """PagedScheduler(kv int8) produces a healthy greedy stream close to
    the bf16 paged scheduler (int8 KV perturbs logits slightly)."""
    cfg = LlamaConfig.tiny(n_vocab=512, n_ctx=64)
    params = params_from_ggml(cfg, make_ggml_weights(
        cfg, np.random.default_rng(77)), dtype=jnp.float32)
    prompts = [[1, 5, 9, 13], [1, 30, 60, 90, 120, 150]]

    ref = PagedScheduler(cfg, params, sampling=GREEDY, max_batch=2,
                         cache_dtype=jnp.float32, decode_chunk=4,
                         page_size=16)
    want = [r.output for r in ref.generate_many(prompts, max_new_tokens=8)]

    s = PagedScheduler(cfg, params, sampling=GREEDY, max_batch=2,
                       cache_dtype="int8", decode_chunk=4, page_size=16)
    got = [r.output for r in s.generate_many(prompts, max_new_tokens=8)]
    for g, w in zip(got, want):
        assert len(g) > 0
        n_match = sum(a == b for a, b in zip(g, w))
        assert n_match >= min(len(g), len(w)) // 2, (g, w)
    # pages recycled on completion
    assert s.alloc.n_free == s.alloc.n_pages - 1
