"""Paged decode attention: the kernel (ops/pallas/paged_attention.py) in
the Pallas interpreter and the plain gather path, both against a numpy
reference over page tables with holes and shared pages, GQA ratios and
lengths at the page boundaries (1, ps-1, ps, ps+1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.models.reference_numpy import attention_np
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops.pallas import paged_attention
from tokenhawk_tpu.runtime import paged
from tokenhawk_tpu.runtime.paged import attend_paged_layer

S = jax.ShapeDtypeStruct


def make_case(rng, rep, ps, contig, Hkv=2, Dh=32):
    """Five sequences of lengths 1, ps-1, ps, ps+1, 2ps+3 in a shuffled
    pool.  Table entries past a sequence's live pages are holes (-1);
    sequences 2 and 3 share their first page (a prefix-cache hit)."""
    lengths = np.array([1, ps - 1, ps, ps + 1, 2 * ps + 3], np.int32)
    B, mp = len(lengths), 4
    n_pages = 24
    perm = rng.permutation(n_pages)
    table = np.full((B, mp), -1, np.int32)
    nxt = 0
    for b in range(B):
        for p in range(-(-lengths[b] // ps)):
            table[b, p] = perm[nxt]
            nxt += 1
    table[3, 0] = table[2, 0]
    shape = (n_pages, Hkv, ps, Dh) if contig else (Hkv, n_pages, ps, Dh)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((B, 1, Hkv * rep, Dh)).astype(np.float32)
    return q, k, v, table, lengths


def numpy_reference(q, k, v, table, lengths, contig):
    out = []
    for b, n in enumerate(lengths):
        pages = [table[b, p] for p in range(-(-n // k.shape[2]))]
        if contig:
            kb = np.concatenate([k[p] for p in pages], axis=1)  # [Hkv, S, Dh]
            vb = np.concatenate([v[p] for p in pages], axis=1)
        else:
            kb = np.concatenate([k[:, p] for p in pages], axis=1)
            vb = np.concatenate([v[:, p] for p in pages], axis=1)
        kb, vb = kb.swapaxes(0, 1)[:n], vb.swapaxes(0, 1)[:n]  # [S, Hkv, Dh]
        out.append(attention_np(q[b], kb, vb, [n - 1]))
    return np.stack(out)  # [B, 1, H, Dh]


@pytest.fixture(params=[True, False], ids=["contig", "head"])
def layout(request, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT",
                       "contig" if request.param else "head")
    return request.param


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_kernel_matches_numpy(rng, layout, rep, ps):
    q, k, v, table, lengths = make_case(rng, rep, ps, layout)
    Dh = q.shape[-1]
    got = paged_attention.paged_decode(
        jnp.asarray(q[:, 0] / np.sqrt(Dh)), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(lengths), contig=layout,
        interpret=True)
    want = numpy_reference(q, k, v, table, lengths, layout)[:, 0]
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("rep", [1, 4])
def test_attend_paged_layer_matches_numpy(rng, monkeypatch, layout, rep,
                                          backend):
    """The serving entry point under both choices: the kernel and the
    plain gather path (holes clamp to a real page there, masked out)."""
    monkeypatch.setattr(dispatch, "_BACKEND", backend)
    q, k, v, table, lengths = make_case(rng, rep, 16, layout)
    tbl = np.maximum(table, 0) if backend == "xla" else table
    got = attend_paged_layer(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(tbl), jnp.asarray(lengths))
    want = numpy_reference(q, k, v, table, lengths, layout)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5, rtol=2e-5)


def test_bf16_pages(rng, layout):
    """Serving dtype: bf16 operands, f32 accumulation and softmax."""
    q, k, v, table, lengths = make_case(rng, 2, 16, layout)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    got = attend_paged_layer(jnp.asarray(q, jnp.bfloat16), kb, vb,
                             jnp.asarray(np.maximum(table, 0)),
                             jnp.asarray(lengths))
    want = numpy_reference(q, np.asarray(kb, np.float32),
                           np.asarray(vb, np.float32), table, lengths, layout)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("args, expect", [
    ((32, 128, 128, 8, 32), True),  # LLaMA-7B
    ((64, 128, 128, 8, 8), True),  # GQA 8:1 (70B)
    ((4, 32, 16, 4, 2), True),
    ((32, 96, 128, 8, 32), False),  # head_dim not a power of two
    ((32, 128, 24, 8, 32), False),  # page size not a power of two
    ((32, 8, 128, 8, 32), False),  # head_dim under the 16-wide dot
    ((6, 32, 4, 1, 4), False),  # one 4-token page per step: too few rows
    ((6, 32, 16, 4, 4), False),  # H not a multiple of Hkv
])
def test_supported_rule(args, expect):
    assert paged_attention.supported(*args) is expect


@pytest.mark.parametrize("ps, mp, n", [(128, 8, 1), (16, 8, 4), (16, 6, 2),
                                       (32, 3, 1), (8, 16, 8)])
def test_pages_per_step(ps, mp, n):
    assert paged_attention.pages_per_step(ps, mp) == n


@pytest.mark.parametrize("B, Hkv, n_steps", [(8, 32, 8), (1, 32, 16),
                                             (1, 8, 6), (64, 32, 8)])
def test_splits_divide_the_table(B, Hkv, n_steps):
    s = paged_attention._num_splits(B, Hkv, n_steps)
    assert n_steps % s == 0
    if B * Hkv >= paged_attention._TARGET_BLOCKS:
        assert s == 1


@pytest.mark.parametrize("contig", [True, False], ids=["contig", "head"])
def test_7b_decode_takes_the_kernel_on_gpu(monkeypatch, contig):
    """B=8, 32 heads, Dh 128, page size 128, 1024-token tables lowered
    for CUDA: one Triton call, no gather of the table's pages."""
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "contig" if contig else "head")
    monkeypatch.setattr(dispatch, "_BACKEND", "auto")
    monkeypatch.setattr(dispatch, "platform", lambda: "gpu")
    pool = (72, 32, 128, 128) if contig else (32, 72, 128, 128)
    text = jax.jit(attend_paged_layer).trace(
        S((8, 1, 32, 128), jnp.bfloat16), S(pool, jnp.bfloat16),
        S(pool, jnp.bfloat16), S((8, 8), jnp.int32), S((8,), jnp.int32),
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("xla.gpu.triton") == 1
    assert "gather" not in text


def test_pool_layout_is_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "head")
    assert not paged._contig() and paged.pool_head_axis() == 0
    monkeypatch.setenv("THAWK_POOL_LAYOUT", "contig")
    assert paged._contig() and paged.pool_head_axis() == 1
