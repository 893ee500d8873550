"""Paged KV cache: virtual-memory block allocation for KV state.

The dense per-slot cache (`KVCache`) reserves max_seq for every slot;
under continuous batching with mixed sequence lengths that wastes HBM.
The paged cache allocates fixed-size pages on demand and maps them
through a per-sequence page table — the vLLM/paged-attention design:

  k_pages / v_pages : [L, n_pages, Hkv, page_size, Dh]   (contig, default)
                      [L, Hkv, n_pages, page_size, Dh]   (head — THAWK_POOL_LAYOUT=head)
  page_table        : [B, max_pages]  int32 physical page ids
  lengths           : [B]             tokens currently stored

The contig (page-major) layout keeps all of a page's heads adjacent in
device memory; the head-major layout keeps one head's pages adjacent.
The decode kernel reads either through a strided per-head view.

This replaces the reference's dense per-conversation KV buffers sized
n_ctx (/root/reference/th-llama-loader.cpp:428-429).

Layer-sliced ops (`*_layer`) take one layer's pages
[Hkv, n_pages, ps, Dh] so they compose with lax.scan over layers; the
layer-indexed wrappers operate on the full [L, ...] arrays.  Decode
attention uses the Pallas paged decode kernel on the GPU
(ops/pallas/paged_attention.py) and an XLA gather fallback elsewhere;
appends and page gathers are plain XLA (dynamic_update_slice / take on
the page axis).

Host-side page allocation is a free list (`PageAllocator`), owned by the
scheduler.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig


def pool_layout() -> str:
    """Physical page-pool layout, process-global (THAWK_POOL_LAYOUT).

    "head"   — [.., Hkv, n_pages, ps, Dh]: head-major.
    "contig" — [.., n_pages, Hkv, ps, Dh]: page-major (default); all
               heads of a page are adjacent.

    The layout is read at pool creation AND at trace time inside the
    paged ops, so it must not change mid-process."""
    v = os.environ.get("THAWK_POOL_LAYOUT", "contig")
    if v not in ("head", "contig"):
        raise ValueError(f"THAWK_POOL_LAYOUT must be head|contig, got {v!r}")
    return v


def _contig() -> bool:
    return pool_layout() == "contig"


def pool_head_axis(pages_ndim: int = 4) -> int:
    """Index of the KV-head axis in a pool array of `pages_ndim` dims
    (4 = per-layer payload, 5 = stacked payload, 3/4 for scale pages)."""
    lead = pages_ndim - 4 if pages_ndim >= 4 else pages_ndim - 3
    return lead + (1 if _contig() else 0)


class PagedKVCache(NamedTuple):
    k_pages: jax.Array  # [L, Hkv, n_pages, ps, Dh] | [L, n_pages, Hkv, ps, Dh]
    v_pages: jax.Array

    @staticmethod
    def create(cfg: LlamaConfig, n_pages: int, page_size: int = 128,
               dtype=jnp.bfloat16) -> "PagedKVCache":
        if _contig():
            shape = (cfg.n_layer, n_pages, cfg.n_kv_head, page_size,
                     cfg.head_dim)
        else:
            shape = (cfg.n_layer, cfg.n_kv_head, n_pages, page_size,
                     cfg.head_dim)
        return PagedKVCache(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1 if _contig() else 2]


def make_unrolled_pool(cfg: LlamaConfig, n_pages: int, page_size: int = 128,
                       dtype=jnp.bfloat16):
    """Per-layer tuple page pool: tuple of (k_l, v_l), each
    [Hkv, n_pages, ps, Dh].

    THE decode-fast form: the stacked [L, ...] pool must ride
    `lax.scan` as xs/ys, and scan ys reallocate and rewrite the whole
    pool every step, so serve decode cost would scale with the pool
    size instead of the live tokens.  Per-layer donated arrays updated
    by dynamic_update_slice chains alias in place."""
    if _contig():
        shape = (n_pages, cfg.n_kv_head, page_size, cfg.head_dim)
    else:
        shape = (cfg.n_kv_head, n_pages, page_size, cfg.head_dim)
    return tuple(
        (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
        for _ in range(cfg.n_layer)
    )


def make_unrolled_quant_pool(cfg: LlamaConfig, n_pages: int,
                             page_size: int = 128):
    """int8 per-layer pool: tuple of (k, ks, v, vs) per layer (payloads
    int8 [Hkv, n_pages, ps, Dh], scales f32 [Hkv, n_pages, ps])."""
    if _contig():
        shape = (n_pages, cfg.n_kv_head, page_size, cfg.head_dim)
        sshape = (n_pages, cfg.n_kv_head, page_size)
    else:
        shape = (cfg.n_kv_head, n_pages, page_size, cfg.head_dim)
        sshape = (cfg.n_kv_head, n_pages, page_size)
    return tuple(
        (jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.float32),
         jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.float32))
        for _ in range(cfg.n_layer)
    )


def is_unrolled_pool(cache) -> bool:
    """True for the per-layer tuple pool form (elements are tuples of
    per-layer arrays); False for the stacked NamedTuple caches."""
    return (isinstance(cache, tuple) and len(cache) > 0
            and isinstance(cache[0], tuple))


def pool_page_size(cache) -> int:
    """page_size for a stacked PagedKVCache/PagedQuantKVCache or an
    unrolled tuple pool."""
    if isinstance(cache, tuple) and not hasattr(cache, "page_size"):
        return cache[0][0].shape[2]
    return cache.page_size


def pool_n_pages(cache) -> int:
    if isinstance(cache, tuple) and not hasattr(cache, "n_pages"):
        return cache[0][0].shape[0 if _contig() else 1]
    return cache.n_pages


def gather_pool_payload(pages: jax.Array, page_table: jax.Array) -> jax.Array:
    """Gather payload pages by table -> [B, Hkv, mp, ps, Dh] regardless
    of the physical pool layout (XLA fallback paths)."""
    if _contig():
        return jnp.swapaxes(pages[page_table], 1, 2)
    return jnp.swapaxes(pages[:, page_table], 0, 1)


def gather_pool_scales(spages: jax.Array, page_table: jax.Array) -> jax.Array:
    """Gather scale pages by table -> [B, Hkv, mp, ps]."""
    if _contig():
        return jnp.swapaxes(spages[page_table], 1, 2)
    return jnp.swapaxes(spages[:, page_table], 0, 1)


class PageAllocator:
    """Host-side free-list allocator over physical pages."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV: need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p < 0 or p >= self.n_pages:
                raise ValueError(f"bad page id {p}")
            self._free.append(p)


# ---------------------------------------------------------------------------
# Layer-sliced ops (compose with lax.scan over layers)
# ---------------------------------------------------------------------------


def append_token_layer(
    pages: jax.Array,  # [Hkv, n_pages, ps, Dh]
    new: jax.Array,  # [B, Hkv, Dh] one token per sequence
    page_table: jax.Array,  # [B, max_pages]
    positions: jax.Array,  # [B] token positions to write
) -> jax.Array:
    ps = pages.shape[2]
    page = jnp.take_along_axis(page_table, (positions // ps)[:, None], axis=1)[:, 0]
    slot = positions % ps

    B = new.shape[0]
    contig = _contig()

    def body(b, pages):
        if contig:
            return jax.lax.dynamic_update_slice(
                pages,
                new[b].astype(pages.dtype)[None, :, None, :],  # [1, Hkv, 1, Dh]
                (page[b], 0, slot[b], 0),
            )
        return jax.lax.dynamic_update_slice(
            pages,
            new[b].astype(pages.dtype)[:, None, None, :],  # [Hkv, 1, 1, Dh]
            (0, page[b], slot[b], 0),
        )

    return jax.lax.fori_loop(0, B, body, pages)


def paginate_fragment_layer(
    pages: jax.Array,  # [Hkv, n_pages, ps, Dh]
    frag: jax.Array,  # [B, Hkv, Tb, Dh] head-major dense fragment (from seq 0)
    page_table: jax.Array,  # [B, max_pages]
) -> jax.Array:
    """Copy a freshly-prefilled dense fragment into pages (page-sized DMAs).

    The fragment starts at position 0; Tb must be a multiple of ps or the
    tail page is partially filled (extra rows are dead until overwritten)."""
    start = jnp.zeros((frag.shape[0],), jnp.int32)
    return paginate_fragment_layer_at(pages, frag, page_table, start)


def paginate_fragment_layer_at(
    pages: jax.Array,  # [Hkv, n_pages, ps, Dh]
    frag: jax.Array,  # [B, Hkv, C, Dh] head-major dense fragment
    page_table: jax.Array,  # [B, max_pages]
    start_page: jax.Array,  # [B] int32: logical page of frag's first row
) -> jax.Array:
    """paginate_fragment_layer at a page-aligned offset (chunked prefill:
    chunk c of a long prompt lands at pages [c*C/ps, ...))."""
    B, Hkv, C, Dh = frag.shape
    ps = pages.shape[2]
    contig = _contig()
    n_frag_pages = -(-C // ps)
    for p in range(n_frag_pages):
        chunk = frag[:, :, p * ps : (p + 1) * ps, :]
        pad = ps - chunk.shape[2]
        if pad:
            chunk = jnp.pad(chunk, ((0, 0), (0, 0), (0, pad), (0, 0)))
        page = jnp.take_along_axis(
            page_table, (start_page + p)[:, None], axis=1)[:, 0]

        def write(b, pages):
            if contig:
                return jax.lax.dynamic_update_slice(
                    pages,
                    chunk[b].astype(pages.dtype)[None, :, :, :],
                    (page[b], 0, 0, 0),
                )
            return jax.lax.dynamic_update_slice(
                pages,
                chunk[b].astype(pages.dtype)[:, None, :, :],
                (0, page[b], 0, 0),
            )

        pages = jax.lax.fori_loop(0, B, write, pages)
    return pages


def attend_paged_layer(
    q: jax.Array,  # [B, 1, H, Dh]
    k_pages_l: jax.Array,  # [Hkv, n_pages, ps, Dh]
    v_pages_l: jax.Array,
    page_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,  # [B] valid tokens (including the current one)
    scale: Optional[float] = None,
) -> jax.Array:
    B, T, H, Dh = q.shape
    Hkv = k_pages_l.shape[pool_head_axis()]
    if scale is None:
        scale = 1.0 / (Dh**0.5)

    from tokenhawk_tpu.ops.dispatch import kernel_mode
    from tokenhawk_tpu.ops.pallas import paged_attention

    mode = kernel_mode("paged_attention")
    ps = k_pages_l.shape[2]
    if mode is not None and paged_attention.supported(
            H, Dh, ps, page_table.shape[1], Hkv):
        out = paged_attention.paged_decode(
            q[:, 0] * scale, k_pages_l, v_pages_l, page_table, lengths,
            contig=_contig(), interpret=(mode == "interpret"))
        return out[:, None].astype(q.dtype)

    # XLA gather fallback: copies every page of the table
    from tokenhawk_tpu.ops.attention import attend_cache

    kg = gather_pool_payload(k_pages_l, page_table)  # [B, Hkv, mp, ps, Dh]
    vg = gather_pool_payload(v_pages_l, page_table)
    mp, ps = kg.shape[2], kg.shape[3]
    kg = kg.reshape(B, Hkv, mp * ps, Dh)
    vg = vg.reshape(B, Hkv, mp * ps, Dh)
    return attend_cache(q, kg, vg, (lengths - 1)[:, None], scale=scale)


# ---------------------------------------------------------------------------
# Layer-indexed wrappers (single-layer use / tests)
# ---------------------------------------------------------------------------


def append_kv(cache: PagedKVCache, k_new, v_new, page_table, lengths, layer):
    """Append a [B, T, Hkv, Dh] block at `lengths` into layer `layer`."""
    B, T, Hkv, Dh = k_new.shape
    k_l = cache.k_pages[layer]
    v_l = cache.v_pages[layer]
    for t in range(T):
        pos = lengths + t
        k_l = append_token_layer(k_l, k_new[:, t], page_table, pos)
        v_l = append_token_layer(v_l, v_new[:, t], page_table, pos)
    k_pages = jax.lax.dynamic_update_slice(
        cache.k_pages, k_l[None].astype(cache.k_pages.dtype), (layer, 0, 0, 0, 0))
    v_pages = jax.lax.dynamic_update_slice(
        cache.v_pages, v_l[None].astype(cache.v_pages.dtype), (layer, 0, 0, 0, 0))
    return PagedKVCache(k_pages, v_pages)


def gather_kv(cache: PagedKVCache, page_table, layer):
    """Materialize [B, Hkv, max_pages*ps, Dh] views (XLA reference path)."""
    k = cache.k_pages[layer]
    v = cache.v_pages[layer]
    kg = gather_pool_payload(k, page_table)
    vg = gather_pool_payload(v, page_table)
    B, Hkv, mp, ps, Dh = kg.shape
    return kg.reshape(B, Hkv, mp * ps, Dh), vg.reshape(B, Hkv, mp * ps, Dh)


def paged_attend_decode(cache: PagedKVCache, q, page_table, lengths, layer,
                        scale: Optional[float] = None):
    """Decode attention over one layer of the paged cache."""
    return attend_paged_layer(
        q, cache.k_pages[layer], cache.v_pages[layer], page_table, lengths,
        scale=scale,
    )


# ---------------------------------------------------------------------------
# int8-quantized pages (the paged twin of ops/kvquant.py)
# ---------------------------------------------------------------------------


class PagedQuantKVCache(NamedTuple):
    """int8 paged KV: payload pages + per-token f32 scale pages
    (token-innermost, ops/kvquant.py layout); the scales cost ~3% of the
    payload bytes."""

    k_pages: jax.Array  # int8 [L, Hkv, n_pages, ps, Dh]
    ks_pages: jax.Array  # f32 [L, Hkv, n_pages, ps]
    v_pages: jax.Array
    vs_pages: jax.Array

    @staticmethod
    def create(cfg: LlamaConfig, n_pages: int,
               page_size: int = 128) -> "PagedQuantKVCache":
        if _contig():
            shape = (cfg.n_layer, n_pages, cfg.n_kv_head, page_size,
                     cfg.head_dim)
            sshape = (cfg.n_layer, n_pages, cfg.n_kv_head, page_size)
        else:
            shape = (cfg.n_layer, cfg.n_kv_head, n_pages, page_size,
                     cfg.head_dim)
            sshape = (cfg.n_layer, cfg.n_kv_head, n_pages, page_size)
        return PagedQuantKVCache(
            jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.float32),
            jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.float32),
        )

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1 if _contig() else 2]


def append_token_layer_int8(
    pages: jax.Array,  # int8 [Hkv, n_pages, ps, Dh]
    spages: jax.Array,  # bf16 [Hkv, n_pages, ps]
    new: jax.Array,  # [B, Hkv, Dh] one token per sequence
    page_table: jax.Array,  # [B, max_pages]
    positions: jax.Array,  # [B]
):
    from tokenhawk_tpu.ops.kvquant import quantize_kv_block

    ps = pages.shape[2]
    page = jnp.take_along_axis(page_table, (positions // ps)[:, None], axis=1)[:, 0]
    slot = positions % ps
    B = new.shape[0]
    q8, sc = quantize_kv_block(new)  # int8 [B, Hkv, Dh], bf16 [B, Hkv]

    contig = _contig()

    def body(b, carry):
        pages, spages = carry
        if contig:
            pages = jax.lax.dynamic_update_slice(
                pages, q8[b].astype(pages.dtype)[None, :, None, :],
                (page[b], 0, slot[b], 0),
            )
            spages = jax.lax.dynamic_update_slice(
                spages, sc[b].astype(spages.dtype)[None, :, None],
                (page[b], 0, slot[b]),
            )
        else:
            pages = jax.lax.dynamic_update_slice(
                pages, q8[b].astype(pages.dtype)[:, None, None, :],
                (0, page[b], slot[b], 0),
            )
            spages = jax.lax.dynamic_update_slice(
                spages, sc[b].astype(spages.dtype)[:, None, None],
                (0, page[b], slot[b]),
            )
        return pages, spages

    return jax.lax.fori_loop(0, B, body, (pages, spages))


def paginate_fragment_layer_int8(
    pages: jax.Array,  # int8 [Hkv, n_pages, ps, Dh]
    spages: jax.Array,  # bf16 [Hkv, n_pages, ps]
    frag: jax.Array,  # [B, Hkv, Tb, Dh] dense fragment (from seq 0)
    page_table: jax.Array,  # [B, max_pages]
):
    """Quantize a dense K/V fragment and write it page-by-page."""
    start = jnp.zeros((frag.shape[0],), jnp.int32)
    return paginate_fragment_layer_int8_at(pages, spages, frag, page_table,
                                           start)


def paginate_fragment_layer_int8_at(
    pages: jax.Array,  # int8 [Hkv, n_pages, ps, Dh]
    spages: jax.Array,  # f32 [Hkv, n_pages, ps]
    frag: jax.Array,  # [B, Hkv, C, Dh] dense fragment
    page_table: jax.Array,  # [B, max_pages]
    start_page: jax.Array,  # [B] logical page of frag's first row
):
    """paginate_fragment_layer_int8 at a page-aligned offset (chunked
    prefill over int8 pages)."""
    from tokenhawk_tpu.ops.kvquant import quantize_kv_block

    B, Hkv, C, Dh = frag.shape
    ps = pages.shape[2]
    q8, sc = quantize_kv_block(frag)
    n_frag_pages = -(-C // ps)
    for p in range(n_frag_pages):
        chunk = q8[:, :, p * ps : (p + 1) * ps, :]
        schunk = sc[:, :, p * ps : (p + 1) * ps]
        pad = ps - chunk.shape[2]
        if pad:
            chunk = jnp.pad(chunk, ((0, 0), (0, 0), (0, pad), (0, 0)))
            schunk = jnp.pad(schunk, ((0, 0), (0, 0), (0, pad)))
        page = jnp.take_along_axis(
            page_table, (start_page + p)[:, None], axis=1)[:, 0]

        def write(b, carry):
            pages, spages = carry
            if _contig():
                pages = jax.lax.dynamic_update_slice(
                    pages, chunk[b].astype(pages.dtype)[None, :, :, :],
                    (page[b], 0, 0, 0),
                )
                spages = jax.lax.dynamic_update_slice(
                    spages, schunk[b].astype(spages.dtype)[None, :, :],
                    (page[b], 0, 0),
                )
            else:
                pages = jax.lax.dynamic_update_slice(
                    pages, chunk[b].astype(pages.dtype)[:, None, :, :],
                    (0, page[b], 0, 0),
                )
                spages = jax.lax.dynamic_update_slice(
                    spages, schunk[b].astype(spages.dtype)[:, None, :],
                    (0, page[b], 0),
                )
            return pages, spages

        pages, spages = jax.lax.fori_loop(0, B, write, (pages, spages))
    return pages, spages


def attend_paged_layer_int8(
    q: jax.Array,  # [B, 1, H, Dh]
    k_pages_l: jax.Array,  # int8 [Hkv, n_pages, ps, Dh]
    ks_pages_l: jax.Array,  # bf16 [Hkv, n_pages, ps]
    v_pages_l: jax.Array,
    vs_pages_l: jax.Array,
    page_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,  # [B] valid tokens (including the current one)
    scale: Optional[float] = None,
) -> jax.Array:
    B, T, H, Dh = q.shape
    Hkv = k_pages_l.shape[pool_head_axis()]
    if scale is None:
        scale = 1.0 / (Dh**0.5)

    # XLA gather + dequantize fallback
    from tokenhawk_tpu.ops.attention import attend_cache
    from tokenhawk_tpu.ops.kvquant import dequantize_kv

    kg = gather_pool_payload(k_pages_l, page_table)  # [B, Hkv, mp, ps, Dh]
    ksg = gather_pool_scales(ks_pages_l, page_table)  # [B, Hkv, mp, ps]
    vg = gather_pool_payload(v_pages_l, page_table)
    vsg = gather_pool_scales(vs_pages_l, page_table)
    mp, ps = kg.shape[2], kg.shape[3]
    kf = dequantize_kv(kg.reshape(B, Hkv, mp * ps, Dh),
                       ksg.reshape(B, Hkv, mp * ps))
    vf = dequantize_kv(vg.reshape(B, Hkv, mp * ps, Dh),
                       vsg.reshape(B, Hkv, mp * ps))
    return attend_cache(q, kf.astype(q.dtype), vf.astype(q.dtype),
                        (lengths - 1)[:, None], scale=scale)
