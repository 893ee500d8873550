"""Int8 KV-cache codec + attention vs the bf16 reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.ops.attention import attend_cache, update_kv_cache
from tokenhawk_tpu.ops.kvquant import (
    attend_cache_int8,
    dequantize_kv,
    quantize_kv_block,
    update_kv_cache_int8,
)


def test_quantize_roundtrip_error(rng):
    x = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    q, s = quantize_kv_block(jnp.asarray(x))
    assert q.dtype == jnp.int8 and s.shape == (2, 3, 4)
    y = np.asarray(dequantize_kv(q, s))
    amax = np.abs(x).max(-1, keepdims=True)
    # half a quantization step + bf16 rounding of the scale (~0.4% of value)
    assert np.abs(y - x).max() <= (amax / 254 + amax * 0.005 + 1e-6).max()


def test_update_and_attend_matches_bf16_path(rng):
    B, T, S, Hkv, Dh = 2, 1, 64, 2, 64
    H = 4
    k_new = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    v_new = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    offsets = jnp.asarray([3, 10], jnp.int32)

    kq = jnp.zeros((B, Hkv, S, Dh), jnp.int8)
    ks = jnp.zeros((B, Hkv, S), jnp.bfloat16)
    vq = jnp.zeros_like(kq)
    vs = jnp.zeros_like(ks)
    kq, ks, vq, vs = update_kv_cache_int8(
        kq, ks, vq, vs, jnp.asarray(k_new), jnp.asarray(v_new), offsets
    )
    # stored vectors dequantize close to the originals
    got = np.asarray(dequantize_kv(kq, ks))[1, :, 10, :]
    np.testing.assert_allclose(got, k_new[1, 0], atol=2e-2, rtol=2e-2)

    # attention over a fuller quantized cache tracks the f32 reference
    k_all = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v_all = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    kq2, ks2 = quantize_kv_block(jnp.asarray(k_all))
    vq2, vs2 = quantize_kv_block(jnp.asarray(v_all))
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    positions = jnp.asarray([[40], [55]], jnp.int32)
    want = np.asarray(attend_cache(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all), positions))
    got = np.asarray(attend_cache_int8(
        jnp.asarray(q), kq2, ks2, vq2, vs2, positions))
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("Hkv,rep", [(2, 2), (1, 4)])
def test_attend_cache_int8_decode_matches_f32(rng, Hkv, rep):
    """Plain int8 decode attention tracks f32 attention over the same
    (unquantized) cache at ragged positions."""
    B, S, Dh = 2, 128, 64
    H = Hkv * rep
    k_all = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v_all = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    kq, ks = quantize_kv_block(jnp.asarray(k_all))
    vq, vs = quantize_kv_block(jnp.asarray(v_all))
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    positions = jnp.asarray([[100], [37]], jnp.int32)

    want = np.asarray(attend_cache(jnp.asarray(q), jnp.asarray(k_all),
                                   jnp.asarray(v_all), positions))
    got = np.asarray(attend_cache_int8(
        jnp.asarray(q), kq, ks, vq, vs, positions))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_engine_int8_kv_cache_generates(rng):
    """End-to-end generation with cache_dtype='int8' (opt-in path)."""
    import jax
    from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
    from tokenhawk_tpu.models.llama import params_from_ggml
    from tokenhawk_tpu.runtime.engine import Engine
    import sys
    sys.path.insert(0, "tests")
    from helpers import make_ggml_weights

    cfg = LlamaConfig.tiny(n_vocab=512, n_ctx=64)
    tensors = make_ggml_weights(cfg, np.random.default_rng(71))
    params = params_from_ggml(cfg, tensors, dtype=jnp.float32)
    greedy = SamplingConfig(temperature=0.0)

    e_ref = Engine(cfg, params, sampling=greedy, cache_dtype=jnp.float32,
                   decode_chunk=4)
    e_q = Engine(cfg, params, sampling=greedy, cache_dtype="int8",
                 decode_chunk=4)
    want = e_ref.generate([1, 9, 42, 7], max_new_tokens=8).tokens
    got = e_q.generate([1, 9, 42, 7], max_new_tokens=8).tokens
    # int8 KV perturbs logits slightly; require a matching prefix at least.
    assert len(got) > 0
    n_match = sum(a == b for a, b in zip(got, want))
    assert n_match >= min(len(got), len(want)) // 2, (got, want)


def test_attend_cache_int8_prefill_matches_f32(rng):
    """Plain int8 prefill attention (whole-block causal) vs f32."""
    B, T, Hkv, rep, Dh, S = 2, 16, 2, 2, 128, 128
    H = Hkv * rep
    q = jnp.asarray(rng.standard_normal((B, T, H, Dh)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, Dh)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, Dh)), jnp.float32)
    kq, ks = quantize_kv_block(k)
    vq, vs = quantize_kv_block(v)
    positions = jnp.broadcast_to(jnp.arange(16, 16 + T)[None], (B, T))

    want = attend_cache(q, k, v, positions)
    got = attend_cache_int8(q, kq, ks, vq, vs, positions)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=3e-2, rtol=3e-2)


def test_int8_decode_update_is_dus_chain(rng):
    """Decode-time int8 cache updates must not lower to scatter (whole
    cache rewrite): temp allocation of a jitted step stays tiny."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from tokenhawk_tpu.ops.kvquant import update_kv_cache_int8

    B, Hkv, S, Dh = 2, 2, 256, 128

    kc = jnp.zeros((B, Hkv, S, Dh), jnp.int8)
    ks = jnp.zeros((B, Hkv, S), jnp.bfloat16)
    vc, vs = kc, ks
    k_new = jnp.ones((B, 1, Hkv, Dh), jnp.float32)
    offs = jnp.asarray([3, 7], jnp.int32)

    @partial(jax.jit, donate_argnums=(0, 1, 2, 3))
    def step(kc, ks, vc, vs):
        return update_kv_cache_int8(kc, ks, vc, vs, k_new, k_new, offs)

    compiled = step.lower(kc, ks, vc, vs).compile()
    temp = compiled.memory_analysis().temp_size_in_bytes
    assert temp < kc.nbytes, (temp, kc.nbytes)
