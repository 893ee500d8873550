"""Ring attention / context-parallel decode vs single-device reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from tokenhawk_tpu.ops.attention import attend_cache
from tokenhawk_tpu.parallel.ring import decode_attend_cp, ring_attention
from tokenhawk_tpu.parallel.tp import shard_map


def _ctx_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("ctx",))


@pytest.mark.parametrize("n_shards,Hkv,rep", [(4, 2, 1), (2, 1, 4), (8, 2, 2)])
def test_ring_attention_matches_dense(rng, n_shards, Hkv, rep):
    B, T_local, Dh = 2, 8, 64
    H = Hkv * rep
    T = n_shards * T_local
    q = rng.standard_normal((B, H, T, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)

    # dense causal reference via attend_cache ([B, T, H, Dh] layout)
    want = np.asarray(attend_cache(
        jnp.asarray(np.transpose(q, (0, 2, 1, 3))), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(np.arange(T)[None, :].repeat(B, 0)),
    ))  # [B, T, H, Dh]

    mesh = _ctx_mesh(n_shards)
    fn = shard_map(
        lambda ql, kl, vl: ring_attention(ql, kl, vl, "ctx", n_shards),
        mesh,
        in_specs=(P(None, None, "ctx", None),) * 3,
        out_specs=P(None, None, "ctx", None),
    )
    got = np.asarray(jax.jit(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(
        np.transpose(got, (0, 2, 1, 3)), want, atol=3e-5, rtol=1e-4
    )


@pytest.mark.parametrize("n_shards", [2, 4])
def test_decode_cp_matches_dense(rng, n_shards):
    B, Hkv, rep, Dh = 2, 2, 2, 64
    H = Hkv * rep
    S_local = 16
    S = n_shards * S_local
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    lengths = np.array([S - 5, 20], np.int32)  # ragged; seq 1 spans 2 shards

    want = np.asarray(attend_cache(
        jnp.asarray(q[:, None].transpose(0, 1, 2, 3).reshape(B, 1, H, Dh)),
        jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths - 1)[:, None],
    ))[:, 0]  # [B, H, Dh]

    # per-shard valid lengths
    def local_lengths(lengths, shard):
        lo = shard * S_local
        return np.clip(lengths - lo, 0, S_local)

    mesh = _ctx_mesh(n_shards)

    def local(q, kl, vl, lens_all):
        idx = jax.lax.axis_index("ctx")
        lo = idx * S_local
        shard_lens = jnp.clip(lens_all - lo, 0, S_local)
        return decode_attend_cp(q, kl, vl, shard_lens, "ctx")

    fn = shard_map(
        local, mesh,
        in_specs=(P(), P(None, None, "ctx", None), P(None, None, "ctx", None), P()),
        out_specs=P(),
    )
    got = np.asarray(jax.jit(fn)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)
    ))
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", ["block", "cyclic"])
def test_ring_attention_dh128_layouts(rng, layout):
    """Ring attention at the 7B head width (Dh=128) in both position
    layouts vs dense causal attention."""
    n_shards, Hkv, rep = 4, 2, 2
    B, T_local, Dh = 2, 8, 128
    H = Hkv * rep
    T = n_shards * T_local
    q = rng.standard_normal((B, H, T, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)

    want = np.asarray(attend_cache(
        jnp.asarray(np.transpose(q, (0, 2, 1, 3))), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(np.arange(T)[None, :].repeat(B, 0)),
    ))  # [B, T, H, Dh]

    if layout == "cyclic":
        # shard i owns global positions {i, i+n, ...}: gather the
        # interleaved rows so shard-local slot j = global i + j*n.
        order = np.arange(T).reshape(T_local, n_shards).T.reshape(-1)
        q_in, k_in, v_in = q[:, :, order], k[:, :, order], v[:, :, order]
    else:
        order = np.arange(T)
        q_in, k_in, v_in = q, k, v

    mesh = _ctx_mesh(n_shards)
    fn = shard_map(
        lambda ql, kl, vl: ring_attention(
            ql, kl, vl, "ctx", n_shards, layout=layout
        ),
        mesh,
        in_specs=(P(None, None, "ctx", None),) * 3,
        out_specs=P(None, None, "ctx", None),
    )
    got = np.asarray(
        jax.jit(fn)(jnp.asarray(q_in), jnp.asarray(k_in), jnp.asarray(v_in))
    )
    inv = np.argsort(order)
    np.testing.assert_allclose(
        np.transpose(got[:, :, inv], (0, 2, 1, 3)), want, atol=3e-5, rtol=1e-4
    )
