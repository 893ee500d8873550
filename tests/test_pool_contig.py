"""Page-pool layout equivalence: head-major vs contig (page-major).

THAWK_POOL_LAYOUT selects the physical pool layout (runtime/paged.py
pool_layout()).  These tests pin that both layouts give identical
results in the decode kernel, the plain append/gather ops and
end-to-end through the paged scheduler.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.ops.pallas.paged_attention import paged_decode
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler

from helpers import make_ggml_weights

GREEDY = SamplingConfig(temperature=0.0)


def _pools(rng, npages, Hkv, ps, Dh, dtype):
    """Same logical page content in both physical layouts."""
    content = rng.standard_normal((npages, Hkv, ps, Dh)).astype(np.float32)
    con = jnp.asarray(content, dtype)
    head = jnp.swapaxes(con, 0, 1)
    return head, con


@pytest.mark.parametrize("rep_heads", [(2, 2), (4, 1)])
def test_decode_kernel_matches_across_layouts(rng, rep_heads):
    Hkv, rep = rep_heads
    B, mp, ps, npages, Dh = 2, 3, 64, 8, 64
    table = jnp.asarray(
        np.random.default_rng(3).permutation(npages)[: B * mp].reshape(B, mp),
        jnp.int32,
    )
    lengths = jnp.asarray([2 * ps + 5, 60], jnp.int32)
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, Dh)), jnp.bfloat16)
    k_head, k_con = _pools(rng, npages, Hkv, ps, Dh, jnp.bfloat16)
    v_head, v_con = _pools(rng, npages, Hkv, ps, Dh, jnp.bfloat16)

    o_head = paged_decode(q, k_head, v_head, table, lengths, contig=False,
                          interpret=True)
    o_con = paged_decode(q, k_con, v_con, table, lengths, contig=True,
                         interpret=True)
    np.testing.assert_array_equal(np.asarray(o_head), np.asarray(o_con))


@pytest.mark.parametrize("rep_heads", [(2, 2), (4, 1)])
def test_int8_attend_matches_across_layouts(rng, rep_heads, monkeypatch):
    from tokenhawk_tpu.runtime.paged import attend_paged_layer_int8

    Hkv, rep = rep_heads
    B, ps, npages, Dh = 2, 16, 6, 32
    table = jnp.asarray([[5, 2], [1, 3]], jnp.int32)
    lengths = jnp.asarray([ps + 4, 7], jnp.int32)
    q = jnp.asarray(rng.standard_normal((B, 1, Hkv * rep, Dh)), jnp.float32)
    k_head, k_con = _pools(rng, npages, Hkv, ps, Dh, jnp.int8)
    v_head, v_con = _pools(rng, npages, Hkv, ps, Dh, jnp.int8)
    sc = rng.standard_normal((npages, Hkv, ps)).astype(np.float32) ** 2
    ks_con = jnp.asarray(sc, jnp.float32)
    vs_con = jnp.asarray(sc * 0.5 + 0.1, jnp.float32)

    monkeypatch.setenv("THAWK_POOL_LAYOUT", "head")
    o_head = attend_paged_layer_int8(
        q, k_head, jnp.swapaxes(ks_con, 0, 1), v_head,
        jnp.swapaxes(vs_con, 0, 1), table, lengths)
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "contig")
    o_con = attend_paged_layer_int8(q, k_con, ks_con, v_con, vs_con, table,
                                    lengths)
    np.testing.assert_array_equal(np.asarray(o_head), np.asarray(o_con))


def test_append_and_gather_match_across_layouts(rng, monkeypatch):
    from tokenhawk_tpu.runtime.paged import (
        append_token_layer,
        gather_pool_payload,
    )

    B, mp, ps, npages, Hkv, Dh = 2, 3, 16, 8, 2, 32
    table = jnp.asarray(
        np.random.default_rng(5).permutation(npages)[: B * mp].reshape(B, mp),
        jnp.int32,
    )
    k_head, k_con = _pools(rng, npages, Hkv, ps, Dh, jnp.bfloat16)
    new = jnp.asarray(rng.standard_normal((B, Hkv, Dh)), jnp.bfloat16)
    positions = jnp.asarray([17, 9], jnp.int32)

    monkeypatch.setenv("THAWK_POOL_LAYOUT", "head")
    a_head = append_token_layer(k_head, new, table, positions)
    g_head = gather_pool_payload(a_head, table)
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "contig")
    a_con = append_token_layer(k_con, new, table, positions)
    g_con = gather_pool_payload(a_con, table)
    np.testing.assert_array_equal(
        np.asarray(a_head), np.asarray(jnp.swapaxes(a_con, 0, 1)))
    np.testing.assert_array_equal(np.asarray(g_head), np.asarray(g_con))


def _serve(layout, params, cfg, prompts, monkeypatch, **kw):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", layout)
    jax.clear_caches()
    s = PagedScheduler(cfg, params, sampling=GREEDY, max_batch=2,
                       cache_dtype=kw.pop("cache_dtype", jnp.float32),
                       decode_chunk=4, page_size=16, **kw)
    out = [r.output for r in s.generate_many(prompts, max_new_tokens=6)]
    jax.clear_caches()
    return out


@pytest.mark.parametrize("cache_dtype", ["f32", "int8"])
def test_paged_scheduler_output_identical_across_layouts(
        monkeypatch, cache_dtype):
    cfg = LlamaConfig.tiny(n_vocab=512, n_ctx=64)
    rng = np.random.default_rng(77)
    params = params_from_ggml(cfg, make_ggml_weights(cfg, rng),
                              dtype=jnp.float32)
    dt = jnp.float32 if cache_dtype == "f32" else "int8"
    prompts = [[1, 5, 9, 13], [1, 30, 60, 90, 120, 150]]
    out_head = _serve("head", params, cfg, prompts, monkeypatch,
                      cache_dtype=dt)
    out_con = _serve("contig", params, cfg, prompts, monkeypatch,
                     cache_dtype=dt)
    assert out_head == out_con


def test_pool_shapes_follow_layout(monkeypatch):
    from tokenhawk_tpu.runtime.paged import (
        PagedKVCache,
        PagedQuantKVCache,
        make_unrolled_pool,
        make_unrolled_quant_pool,
        pool_n_pages,
        pool_page_size,
    )

    cfg = LlamaConfig.tiny(n_layer=2, n_head=4, n_kv_head=2)
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "head")
    c = PagedKVCache.create(cfg, n_pages=6, page_size=16)
    assert c.k_pages.shape == (2, 2, 6, 16, cfg.head_dim)
    assert c.n_pages == 6 and c.page_size == 16
    u = make_unrolled_pool(cfg, 6, 16)
    assert u[0][0].shape == (2, 6, 16, cfg.head_dim)
    assert pool_n_pages(u) == 6 and pool_page_size(u) == 16

    monkeypatch.setenv("THAWK_POOL_LAYOUT", "contig")
    c = PagedQuantKVCache.create(cfg, n_pages=6, page_size=16)
    assert c.k_pages.shape == (2, 6, 2, 16, cfg.head_dim)
    assert c.ks_pages.shape == (2, 6, 2, 16)
    assert c.n_pages == 6 and c.page_size == 16
    uq = make_unrolled_quant_pool(cfg, 6, 16)
    assert uq[0][0].shape == (6, 2, 16, cfg.head_dim)
    assert uq[0][1].shape == (6, 2, 16)
    assert pool_n_pages(uq) == 6 and pool_page_size(uq) == 16
