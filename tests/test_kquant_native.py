"""Native k-quant device path: extract -> QWeight -> qk Pallas kernel.

Round 2 served Q4_K/Q5_K/Q6_K files by requantizing to Q8_0 at load
(double rounding + ~2x the HBM bytes).  The native path reduces the
super-block structure to per-group affine int codes served directly by
the generic qk kernel — these tests pin bit-exactness of the reduction
(device dequant == host codec output) and the kernel/model plumbing,
including llama.cpp *_M-style per-layer kind mixing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.ggml.format import GGMLType
from tokenhawk_tpu.ggml.gguf import GGUFFile, RawTensor, write_gguf
from tokenhawk_tpu.ggml.kquants import (
    QK_K,
    dequant_kquant,
    quantize_q2_k,
    quantize_q3_k,
    quantize_q4_k,
    quantize_q5_k,
    quantize_q6_k,
)
from tokenhawk_tpu.ops.qweight import from_kquant_raw, to_qk16

from helpers import make_ggml_weights
from test_gguf import _metadata, _to_gguf_name

_QFN = {
    GGMLType.Q2_K: quantize_q2_k,
    GGMLType.Q3_K: quantize_q3_k,
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q5_K: quantize_q5_k,
    GGMLType.Q6_K: quantize_q6_k,
}


@pytest.mark.parametrize("kind", list(_QFN))
def test_from_kquant_raw_bit_exact(rng, kind):
    """Device QWeight.dequantize() == host codec output, bit for bit."""
    out_dim, in_dim = 8, 2 * QK_K
    x = rng.standard_normal(out_dim * in_dim).astype(np.float32)
    raw = _QFN[kind](x)
    host = dequant_kquant(kind, raw, (out_dim, in_dim))  # [out, in]
    w = from_kquant_raw(kind, raw, (out_dim, in_dim))
    dev = np.asarray(w.dequantize(), np.float32)  # [in, out]
    np.testing.assert_array_equal(dev, host.T)


@pytest.mark.parametrize("kind", list(_QFN))
def test_qk_matmul_matches_dequant(rng, kind):
    from tokenhawk_tpu.ops.pallas.qgemv import qgemv, supported

    out_dim, in_dim = 384, 2 * QK_K
    raw = _QFN[kind](
        (rng.standard_normal(out_dim * in_dim) * 0.05).astype(np.float32))
    w = from_kquant_raw(kind, raw, (out_dim, in_dim))
    x = jnp.asarray(rng.standard_normal((3, in_dim)), jnp.bfloat16)
    assert supported(3, w)
    y = qgemv(x, w, interpret=True)
    ref = np.asarray(x, np.float32) @ np.asarray(w.dequantize(), np.float32)
    np.testing.assert_allclose(
        np.asarray(y, np.float32), ref, atol=2e-2, rtol=2e-2)


def test_qk_matmul_fused_norm(rng, monkeypatch):
    """matmul(x, w, norm_gain) == rms_norm(x) @ w through the GEMV."""
    from tokenhawk_tpu.ops import dispatch
    from tokenhawk_tpu.ops.linear import matmul

    monkeypatch.setattr(dispatch, "_BACKEND", "interpret")

    out_dim, in_dim = 384, 2 * QK_K
    raw = quantize_q4_k(
        (rng.standard_normal(out_dim * in_dim) * 0.05).astype(np.float32))
    w = from_kquant_raw(GGMLType.Q4_K, raw, (out_dim, in_dim))
    gain = jnp.asarray(1.0 + 0.1 * rng.standard_normal(in_dim), jnp.float32)
    x = jnp.asarray(rng.standard_normal((2, in_dim)), jnp.bfloat16)
    y = matmul(x, w, gain)
    xf = np.asarray(x, np.float32)
    xn = xf / np.sqrt((xf * xf).mean(-1, keepdims=True) + 1e-6)
    xn = xn * np.asarray(gain, np.float32)
    ref = xn @ np.asarray(w.dequantize(), np.float32)
    np.testing.assert_allclose(
        np.asarray(y, np.float32), ref, atol=2e-2, rtol=2e-2)


def test_to_qk16_exact(rng):
    for kind in _QFN:
        out_dim, in_dim = 8, QK_K
        raw = _QFN[kind](rng.standard_normal(out_dim * in_dim).astype(
            np.float32))
        w = from_kquant_raw(kind, raw, (out_dim, in_dim))
        w16 = to_qk16(w)
        assert w16.kind == "qk_i8" and w16.group == 16
        assert w16.mins is not None
        np.testing.assert_array_equal(
            np.asarray(w16.dequantize()), np.asarray(w.dequantize()))


def test_gguf_mixed_kind_layers_load_and_generate(tmp_path):
    """A GGUF file mixing Q4_K and Q6_K across layers in one family
    (the llama.cpp Q4_K_M recipe) loads natively: the mixed family
    stacks via the exact group-16 re-encode, fusion skips mixed
    attention weights, and the engine generates."""
    from tokenhawk_tpu.ops.qweight import QWeight
    from tokenhawk_tpu.runtime.engine import Engine
    from tokenhawk_tpu.runtime.loader import load_model

    CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=4, n_layer=2,
                           n_ff=256)
    rng = np.random.default_rng(11)
    tensors = make_ggml_weights(CFG, rng)
    out = {}
    for name, v in tensors.items():
        if v.ndim == 2 and "norm" not in name and \
                name != "tok_embeddings.weight" and v.size % QK_K == 0:
            # alternate kinds per layer for w2/wv (the _M pattern)
            kind = GGMLType.Q4_K
            if ("feed_forward.w2" in name or "attention.wv" in name) and \
                    name.startswith("layers.1."):
                kind = GGMLType.Q6_K
            out[_to_gguf_name(name)] = RawTensor(
                kind, v.shape, _QFN[kind](v.reshape(-1)))
        else:
            out[_to_gguf_name(name)] = v
    md = _metadata(CFG.n_vocab)
    md["llama.embedding_length"] = CFG.n_embd
    md["llama.rope.dimension_count"] = CFG.head_dim
    path = tmp_path / "mixed.gguf"
    write_gguf(path, md, out)

    cfg, params, tok = load_model(str(path), n_ctx=64)
    lp = params.layers[0] if isinstance(params.layers, tuple) else params.layers
    # wv mixed across layers -> attention fusion skipped, w2 re-encoded
    assert lp.wqkv is None and isinstance(lp.wq, QWeight)
    assert isinstance(lp.w2, QWeight) and lp.w2.kind == "qk_i8"
    assert lp.w2.group == 16 and lp.w2.mins is not None
    # w1/w3 homogeneous -> still fused
    assert lp.w13 is not None

    eng = Engine(cfg, params, tokenizer=tok,
                 sampling=SamplingConfig(temperature=0.0), decode_chunk=4)
    res = eng.generate("hello", max_new_tokens=4)
    assert len(res.tokens) <= 4


def test_gguf_native_forward_matches_dequant_reference(tmp_path):
    """Native k-quant engine forward == forward over the dequantized
    dense weights (small tolerances: the kernels compute the same
    affine dequant in f32)."""
    from tokenhawk_tpu.models import llama as M
    from tokenhawk_tpu.runtime.loader import load_model

    CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=4, n_layer=2,
                           n_ff=256)
    rng = np.random.default_rng(12)
    tensors = make_ggml_weights(CFG, rng)
    out = {}
    for name, v in tensors.items():
        if v.ndim == 2 and "norm" not in name and \
                name != "tok_embeddings.weight" and v.size % QK_K == 0:
            out[_to_gguf_name(name)] = RawTensor(
                GGMLType.Q4_K, v.shape, quantize_q4_k(v.reshape(-1)))
        else:
            out[_to_gguf_name(name)] = v
    md = _metadata(CFG.n_vocab)
    md["llama.embedding_length"] = CFG.n_embd
    md["llama.rope.dimension_count"] = CFG.head_dim
    path = tmp_path / "q4k.gguf"
    write_gguf(path, md, out)

    cfg, params, _ = load_model(str(path), n_ctx=32)

    # dense reference params: dequantize the same file's tensors
    f = GGUFFile(path)
    dense = {n: np.asarray(f.load_tensor(n), np.float32)
             for n in f.tensors}
    f.close()
    ref_params = M.params_from_ggml(cfg, dense, dtype=jnp.float32)
    cfg_ref = cfg
    if cfg.rope_style == "half":
        import dataclasses as _dc

        cfg_i = _dc.replace(cfg, rope_style="interleaved")
        cfg_ref, ref_params = M.rope_half_params(cfg_i, ref_params)

    toks = jnp.asarray([[5, 9, 23]], jnp.int32)
    off = jnp.zeros((1,), jnp.int32)
    if isinstance(params.layers, tuple):
        cache = M.make_unrolled_cache(cfg, 1, 32, jnp.bfloat16)
    else:
        cache = M.KVCache.create(cfg, 1, 32)
    h, _ = M.forward(cfg, params, toks, cache, off)
    cache_r = M.KVCache.create(cfg_ref, 1, 32, jnp.float32)
    h_ref, _ = M.forward(cfg_ref, ref_params, toks, cache_r, off)
    np.testing.assert_allclose(
        np.asarray(h, np.float32), np.asarray(h_ref, np.float32),
        atol=8e-2, rtol=8e-2)


@pytest.mark.parametrize("kind,tol", [
    (GGMLType.Q2_K, 0.40),  # 2-bit: coarse by design
    # 3-bit symmetric: +absmax is representable only at 3/4 scale
    (GGMLType.Q3_K, 0.26),
])
def test_q2_q3_roundtrip(rng, kind, tol):
    x = rng.standard_normal(4 * QK_K).astype(np.float32)
    y = dequant_kquant(kind, _QFN[kind](x), (x.size,))
    assert np.abs(y - x).max() <= tol * np.abs(x).max()


def test_q5_0_q5_1_gguf_roundtrip_and_device(rng):
    """GGUF Q5_0/Q5_1 blocks parse, dequantize within codec error, and
    the device QWeight (qk_i8) matmul matches the dequantized weights."""
    from tokenhawk_tpu.ggml.format import QK
    from tokenhawk_tpu.ggml.gguf import (
        from_blocks_gguf,
        pack_q5_0_blocks,
        pack_q5_1_blocks,
    )
    from tokenhawk_tpu.ops.pallas.qgemv import qgemv
    from tokenhawk_tpu.ops.qweight import from_quantized_tensor

    out_dim, in_dim = 16, 8 * QK
    x = (rng.standard_normal((out_dim, in_dim)) * 0.5).astype(np.float32)
    for kind, pack in ((GGMLType.Q5_0, pack_q5_0_blocks),
                       (GGMLType.Q5_1, pack_q5_1_blocks)):
        raw = pack(x.reshape(-1))
        qt = from_blocks_gguf(kind, raw, (out_dim, in_dim))
        dense = np.asarray(
            __import__("tokenhawk_tpu.ggml.quants",
                       fromlist=["dequantize"]).dequantize(qt))
        # 5-bit codec: ~3-4% worst-case error
        assert np.abs(dense - x).max() <= 0.06 * np.abs(x).max()

        w = from_quantized_tensor(qt)
        assert w.kind == "qk_i8"
        np.testing.assert_array_equal(
            np.asarray(w.dequantize(), np.float32), dense.T)
        a = jnp.asarray(rng.standard_normal((2, in_dim)), jnp.bfloat16)
        y = qgemv(a, w, interpret=True)
        ref = np.asarray(a, np.float32) @ dense.T
        np.testing.assert_allclose(np.asarray(y, np.float32), ref,
                                   atol=5e-2, rtol=5e-2)


def test_q2k_gguf_load_and_generate(tmp_path):
    """A Q2_K GGUF file loads natively (qk kernel, group 16, affine) and
    generates."""
    from tokenhawk_tpu.config import SamplingConfig
    from tokenhawk_tpu.runtime.engine import Engine
    from tokenhawk_tpu.runtime.loader import load_model

    CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=4, n_layer=2,
                           n_ff=256)
    rng = np.random.default_rng(13)
    tensors = make_ggml_weights(CFG, rng)
    out = {}
    for name, v in tensors.items():
        if v.ndim == 2 and "norm" not in name and \
                name != "tok_embeddings.weight" and v.size % QK_K == 0:
            out[_to_gguf_name(name)] = RawTensor(
                GGMLType.Q2_K, v.shape, quantize_q2_k(v.reshape(-1)))
        else:
            out[_to_gguf_name(name)] = v
    md = _metadata(CFG.n_vocab)
    md["llama.embedding_length"] = CFG.n_embd
    md["llama.rope.dimension_count"] = CFG.head_dim
    path = tmp_path / "q2k.gguf"
    write_gguf(path, md, out)
    cfg, params, tok = load_model(str(path), n_ctx=64)
    lp = params.layers[0] if isinstance(params.layers, tuple) else params.layers
    eng = Engine(cfg, params, tokenizer=tok,
                 sampling=SamplingConfig(temperature=0.0), decode_chunk=4)
    res = eng.generate("hello", max_new_tokens=4)
    assert len(res.tokens) <= 4
