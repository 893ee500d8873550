"""Plain XLA attention (ops/attention.py attend_cache) against the numpy
reference (models/reference_numpy.attention_np): prefill blocks and
decode steps, GQA ratios, f32 and bf16 caches."""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.models.reference_numpy import attention_np
from tokenhawk_tpu.ops.attention import attend_cache, update_kv_cache


def reference(q, k, v, positions):
    """Per sequence; k, v are [B, Hkv, S, Dh] head-major caches."""
    return np.stack([attention_np(q[b], k[b].swapaxes(0, 1),
                                  v[b].swapaxes(0, 1), positions[b])
                     for b in range(q.shape[0])])


@pytest.mark.parametrize("dtype, tol", [(jnp.float32, 2e-5),
                                        (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("T, offsets", [(1, [0, 5, 40]), (6, [0, 9, 26])],
                         ids=["decode", "prefill"])
def test_attend_cache_matches_numpy(rng, T, offsets, rep, dtype, tol):
    B, Hkv, S, Dh = 3, 2, 48, 32
    q = rng.standard_normal((B, T, Hkv * rep, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    # round to the cache dtype first: the reference sees the same values
    kq, vq = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    positions = np.asarray(offsets)[:, None] + np.arange(T)[None, :]
    got = attend_cache(jnp.asarray(q, dtype), kq, vq, jnp.asarray(positions))
    assert got.dtype == dtype and got.shape == q.shape
    want = reference(np.asarray(jnp.asarray(q, dtype), np.float32),
                     np.asarray(kq, np.float32), np.asarray(vq, np.float32),
                     positions)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("T", [1, 4])
def test_update_then_attend_matches_numpy(rng, T):
    """Write a block at ragged offsets, then attend: only written slots
    at or before each query's position contribute."""
    B, Hkv, rep, S, Dh = 2, 2, 2, 32, 16
    offsets = np.array([3, 11])
    kc = jnp.zeros((B, Hkv, S, Dh), jnp.float32)
    vc = jnp.zeros((B, Hkv, S, Dh), jnp.float32)
    hist_k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    hist_v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    kc, vc = jnp.asarray(hist_k), jnp.asarray(hist_v)
    k_new = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    v_new = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    kc, vc = update_kv_cache(kc, vc, jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(offsets, jnp.int32))
    for b in range(B):
        hist_k[b, :, offsets[b]:offsets[b] + T] = k_new[b].swapaxes(0, 1)
        hist_v[b, :, offsets[b]:offsets[b] + T] = v_new[b].swapaxes(0, 1)
    np.testing.assert_array_equal(np.asarray(kc), hist_k)
    np.testing.assert_array_equal(np.asarray(vc), hist_v)
    q = rng.standard_normal((B, T, Hkv * rep, Dh)).astype(np.float32)
    positions = offsets[:, None] + np.arange(T)[None, :]
    got = attend_cache(jnp.asarray(q), kc, vc, jnp.asarray(positions))
    np.testing.assert_allclose(np.asarray(got),
                               reference(q, hist_k, hist_v, positions),
                               atol=2e-5, rtol=2e-5)
