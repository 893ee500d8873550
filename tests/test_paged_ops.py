"""Plain XLA page-pool ops (runtime/paged.py) against numpy: token
append, fragment pagination at a page offset, and page gathers, in both
pool layouts."""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.runtime.paged import (
    append_token_layer,
    gather_pool_payload,
    gather_pool_scales,
    paginate_fragment_layer_at,
)

Hkv, PS, DH, N_PAGES = 2, 8, 4, 10


@pytest.fixture(params=[True, False], ids=["contig", "head"])
def contig(request, monkeypatch):
    monkeypatch.setenv("THAWK_POOL_LAYOUT",
                       "contig" if request.param else "head")
    return request.param


def logical(pool, contig):
    """Pool -> numpy [n_pages, Hkv, ps, Dh] whatever the layout."""
    a = np.asarray(pool)
    return a if contig else a.swapaxes(0, 1)


def physical(a, contig):
    return jnp.asarray(a if contig else a.swapaxes(0, 1))


@pytest.mark.parametrize("positions", [[0, 7, 8], [15, 1, 9]])
def test_append_token_writes_one_slot(rng, contig, positions):
    pool = rng.standard_normal((N_PAGES, Hkv, PS, DH)).astype(np.float32)
    table = np.array([[4, 1], [0, 7], [9, 2]], np.int32)
    new = rng.standard_normal((3, Hkv, DH)).astype(np.float32)
    got = append_token_layer(physical(pool, contig), jnp.asarray(new),
                             jnp.asarray(table),
                             jnp.asarray(positions, jnp.int32))
    want = pool.copy()
    for b, pos in enumerate(positions):
        want[table[b, pos // PS], :, pos % PS] = new[b]
    np.testing.assert_array_equal(logical(got, contig), want)


@pytest.mark.parametrize("C, start", [(PS, [0, 1]), (2 * PS + 3, [0, 0]),
                                      (PS, [2, 0])])
def test_paginate_fragment_at_page_offset(rng, contig, C, start):
    pool = rng.standard_normal((N_PAGES, Hkv, PS, DH)).astype(np.float32)
    table = np.array([[3, 5, 8, 0], [6, 2, 1, 9]], np.int32)
    frag = rng.standard_normal((2, Hkv, C, DH)).astype(np.float32)
    got = paginate_fragment_layer_at(physical(pool, contig), jnp.asarray(frag),
                                     jnp.asarray(table),
                                     jnp.asarray(start, jnp.int32))
    want = pool.copy()
    n_frag_pages = -(-C // PS)
    padded = np.zeros((2, Hkv, n_frag_pages * PS, DH), np.float32)
    padded[:, :, :C] = frag
    for b in range(2):
        for p in range(n_frag_pages):
            want[table[b, start[b] + p]] = padded[b, :, p * PS:(p + 1) * PS]
    np.testing.assert_array_equal(logical(got, contig), want)


def test_gather_payload_follows_the_table(rng, contig):
    pool = rng.standard_normal((N_PAGES, Hkv, PS, DH)).astype(np.float32)
    table = np.array([[3, 3, 0], [9, 1, 4]], np.int32)  # shared, repeated
    got = np.asarray(gather_pool_payload(physical(pool, contig),
                                         jnp.asarray(table)))
    assert got.shape == (2, Hkv, 3, PS, DH)
    np.testing.assert_array_equal(got, pool[table].swapaxes(1, 2))


def test_gather_scales_follows_the_table(rng, contig):
    spool = rng.standard_normal((N_PAGES, Hkv, PS)).astype(np.float32)
    table = np.array([[2, 7], [7, 5]], np.int32)
    got = np.asarray(gather_pool_scales(physical(spool, contig),
                                        jnp.asarray(table)))
    assert got.shape == (2, Hkv, 2, PS)
    np.testing.assert_array_equal(got, spool[table].swapaxes(1, 2))
