"""Paged decode attention (Pallas, Triton route).

One query token per sequence attends to the KV pages its page table
maps, reading only live pages: a step costs the bytes of the tokens
actually stored, not of the whole table (which the plain gather path
copies every step, for every layer).

Grid (B, Hkv, splits).  A block owns one sequence, one KV head and one
contiguous run of its page-table entries (flash-decoding split over the
sequence so that short batches still fill the card).  It loads its own
page ids from the table, walks the live pages of its run with an online
softmax in f32 (bf16 operands on the tensor cores), and writes the
unnormalised partial (o, m, l); XLA merges the splits.  The query rows
of one KV head (the GQA group) are zero-padded to 16, the tensor-core
minimum.

Pool layouts (runtime/paged.py): page-major [n_pages, Hkv, ps, Dh]
(default) or head-major [Hkv, n_pages, ps, Dh]; the BlockSpec picks the
head's strided view, so neither needs a transpose.  Modelled on the
Triton-route paged attention that ships with JAX
(jax/experimental/pallas/ops/gpu/paged_attention.py), which takes the
head-major layout only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_MIN_ROWS = 16  # dot rows (tensor-core minimum)
_BLOCK_TOKENS = 64  # at least this many tokens per inner step
_TARGET_BLOCKS = 264  # ~2 blocks per SM on a 132-SM card
_M_INIT = float(jnp.finfo(jnp.float32).min)
_MASK = -0.7 * float(jnp.finfo(jnp.float32).max)


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def pages_per_step(page_size: int, max_pages: int) -> int:
    """Pages per inner step: up to _BLOCK_TOKENS tokens, a power of two
    that divides the table width."""
    n = max(1, _BLOCK_TOKENS // page_size)
    while max_pages % n:
        n //= 2
    return n


def supported(q_heads: int, head_dim: int, page_size: int,
              max_pages: int, kv_heads: int) -> bool:
    """The kernel-choice rule for paged decode attention."""
    return (head_dim >= 16 and _pow2(head_dim) and _pow2(page_size)
            and page_size * pages_per_step(page_size, max_pages) >= 16
            and q_heads % kv_heads == 0)


def _num_splits(batch: int, kv_heads: int, n_steps: int) -> int:
    want = max(1, -(-_TARGET_BLOCKS // (batch * kv_heads)))
    best = 1
    for d in range(1, n_steps + 1):
        if n_steps % d == 0 and d <= want:
            best = d
    return best


def _kernel(len_ref, pt_ref, q_ref, k_ref, v_ref, o_ref, m_ref, l_ref, *,
            page_size, ppcb, pages_per_split, n_pages):
    length = len_ref[0]
    p0 = pl.program_id(2) * pages_per_split
    live = pl.cdiv(length, page_size)
    p1 = jnp.minimum(p0 + pages_per_split, live)
    n_steps = pl.cdiv(jnp.maximum(p1 - p0, 0), ppcb)
    q = q_ref[...]  # [R, Dh]
    R, Dh = q.shape
    bk = ppcb * page_size

    def body(i, carry):
        o, m, l = carry
        first = p0 + i * ppcb
        ids = pt_ref[pl.ds(first, ppcb)]
        ids = jnp.minimum(jnp.maximum(ids, 0), n_pages - 1)
        k = k_ref[ids].reshape(bk, Dh)
        v = v_ref[ids].reshape(bk, Dh)
        s = pl.dot(q, k, trans_b=True)  # [R, bk] f32
        tok = first * page_size + jnp.arange(bk)
        s = jnp.where((tok < length)[None, :], s, _MASK)
        m_new = jnp.maximum(m, s.max(axis=-1))
        corr = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[:, None])
        l = l * corr + p.sum(axis=-1)
        o = o * corr[:, None] + pl.dot(p.astype(v.dtype), v)
        return o, m_new, l

    init = (jnp.zeros((R, Dh), jnp.float32),
            jnp.full((R,), _M_INIT, jnp.float32),
            jnp.zeros((R,), jnp.float32))
    o, m, l = lax.fori_loop(0, n_steps, body, init)
    o_ref[...] = o
    m_ref[...] = m
    l_ref[...] = l


@functools.partial(jax.jit, static_argnames=("contig", "interpret"))
def paged_decode(q, k_pages, v_pages, page_table, lengths, *, contig,
                 interpret=False):
    """q [B, H, Dh] (already scaled) over one layer's pool -> [B, H, Dh].

    lengths [B] counts the valid tokens of each sequence (>= 1)."""
    B, H, Dh = q.shape
    if contig:
        n_pages, Hkv, ps, _ = k_pages.shape
        pool_spec = pl.BlockSpec((n_pages, None, ps, Dh),
                                 lambda b, h, s: (0, h, 0, 0))
    else:
        Hkv, n_pages, ps, _ = k_pages.shape
        pool_spec = pl.BlockSpec((None, n_pages, ps, Dh),
                                 lambda b, h, s: (h, 0, 0, 0))
    mp = page_table.shape[1]
    rep = H // Hkv
    R = max(_MIN_ROWS, 1 << (rep - 1).bit_length())
    ppcb = pages_per_step(ps, mp)
    splits = _num_splits(B, Hkv, mp // ppcb)
    qg = q.reshape(B, Hkv, rep, Dh).astype(k_pages.dtype)
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, R - rep), (0, 0)))
    kernel = functools.partial(
        _kernel, page_size=ps, ppcb=ppcb, pages_per_split=mp // splits,
        n_pages=n_pages)
    o, m, l = pl.pallas_call(
        kernel,
        grid=(B, Hkv, splits),
        in_specs=[
            pl.BlockSpec((None, 1), lambda b, h, s: (b, 0)),
            pl.BlockSpec((None, mp), lambda b, h, s: (b, 0)),
            pl.BlockSpec((None, None, R, Dh), lambda b, h, s: (b, h, 0, 0)),
            pool_spec,
            pool_spec,
        ],
        out_specs=[
            pl.BlockSpec((None, None, None, R, Dh),
                         lambda b, h, s: (s, b, h, 0, 0)),
            pl.BlockSpec((None, None, None, R), lambda b, h, s: (s, b, h, 0)),
            pl.BlockSpec((None, None, None, R), lambda b, h, s: (s, b, h, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, B, Hkv, R, Dh), jnp.float32),
            jax.ShapeDtypeStruct((splits, B, Hkv, R), jnp.float32),
            jax.ShapeDtypeStruct((splits, B, Hkv, R), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="paged_decode_attention",
    )(lengths.astype(jnp.int32).reshape(B, 1), page_table.astype(jnp.int32),
      qg, k_pages, v_pages)
    m_g = m.max(axis=0)
    alpha = jnp.exp(m - m_g[None])
    l_g = (l * alpha).sum(axis=0)
    o_g = (o * alpha[..., None]).sum(axis=0)
    out = o_g / jnp.where(l_g == 0.0, 1.0, l_g)[..., None]
    return out[:, :, :rep].reshape(B, H, Dh).astype(q.dtype)
