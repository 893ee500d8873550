"""Device-side quantized weight container.

The host loader produces `tokenhawk_tpu.ggml.quants.QuantizedTensor`
(unpacked int8 + f32 scales).  On device we keep:

  qs:     int8 [K, N]   quantized integers, K = input dim (contraction)
  scales: f32  [K//G, N] per-(group-of-G input rows, output col) scale
  mins:   f32  [K//G, N] affine offset (Q4_1 only)

i.e. weights are stored *transposed* relative to GGML ([out, in] on disk
-> [in, out] on device) so activations contract with `x @ W` directly,
and the quantization groups run down the contraction dimension — the
layout the dequantizing GEMV kernel (ops/pallas/qgemv.py) walks.

This replaces the reference's packed-f16-in-u32 buffers + in-shader
decode (th.cpp:363-394).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.ggml.format import GGMLType, QK
from tokenhawk_tpu.ggml.quants import QuantizedTensor


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QWeight:
    """Quantized weight.

    q8_0:  qs int8 [K, N]
    q4_0:  qs uint8 [K//2, N] PACKED — byte row j holds logical row j in
           its low nibble and row j + K//2 in its high nibble, both
           offset-binary (+8).  Both halves dequantize from contiguous
           slices of one byte tile (ops/pallas/qgemv.py).
    q4_1:  qs int8 [K, N] in [0, 15] with affine mins.
    qk_i4 / qk_i8: int4 / int8 codes [K, N] with per-group scales and
           optional affine mins (native k-quant loads).
    """

    qs: jax.Array
    scales: jax.Array  # [K//G, N]; q4_0: LOW-half scales [K//(2G), N]
    mins: Optional[jax.Array]  # [K//G, N] or None
    # q4_0 only: scales of the high-half rows [K//(2G), N], kept apart
    # so each half's scales are one contiguous array.
    scales_hi: Optional[jax.Array] = None
    kind: str = dataclasses.field(metadata=dict(static=True), default="q8_0")
    group: int = dataclasses.field(metadata=dict(static=True), default=QK)

    @property
    def shape(self):
        if self.kind == "q4_0":
            s = self.qs.shape
            return (*s[:-2], s[-2] * 2, s[-1])
        return self.qs.shape

    @property
    def dtype(self):
        return self.scales.dtype

    @property
    def nbytes(self) -> int:
        def nb(a):
            if a is None:
                return 0
            # sub-byte dtypes pack 2/byte in HBM but report itemsize 1
            if a.dtype in (jnp.int4, jnp.uint4):
                return a.size // 2
            return a.nbytes

        return nb(self.qs) + nb(self.scales) + nb(self.mins) + nb(self.scales_hi)

    def full_scales(self) -> jax.Array:
        """Scales at logical group order [..., K//G, N]."""
        if self.scales_hi is None:
            return self.scales
        return jnp.concatenate([self.scales, self.scales_hi], axis=-2)

    def unpacked_qs(self) -> jax.Array:
        """Integer codes at logical shape [..., K, N] (sign already applied)."""
        if self.kind == "qk_i4":
            return self.qs.astype(jnp.int8)
        if self.kind != "q4_0":
            return self.qs
        lo = (self.qs & 0x0F).astype(jnp.int8) - 8
        hi = (self.qs >> 4).astype(jnp.int8) - 8
        return jnp.concatenate([lo, hi], axis=-2)

    def dequantize(self, dtype=jnp.float32) -> jax.Array:
        """Materialize the dense [K, N] matrix (plain matmul path, tests)."""
        qs = self.unpacked_qs()
        K, N = qs.shape[-2:]
        g = self.group
        lead = qs.shape[:-2]
        q = qs.astype(jnp.float32).reshape(*lead, K // g, g, N)
        w = q * self.full_scales().astype(jnp.float32)[..., :, None, :]
        if self.mins is not None:
            w = w + self.mins.astype(jnp.float32)[..., :, None, :]
        return w.reshape(*lead, K, N).astype(dtype)


ArrayOrQ = Union[jax.Array, QWeight]

def pack_q4_rows(qs_t: np.ndarray, k_shards: int = 1) -> np.ndarray:
    """int8 [K, N] in [-8,7] -> packed uint8 [K//2, N].

    Packing is per K-shard: within each of `k_shards` contiguous row
    blocks, row j pairs with row j + block//2 (offset-binary +8).  With
    k_shards == tp, slicing the packed array into tp row chunks yields
    exactly the pack of each shard's local rows — required when the
    contraction dim is sharded (row-parallel wo/w2 under shard_map TP).
    """
    K = qs_t.shape[0]
    if K % (64 * k_shards):
        raise ValueError(f"q4_0 input dim {K} must be a multiple of {64 * k_shards}")
    u = (qs_t.astype(np.int16) + 8).astype(np.uint8)
    blk = K // k_shards
    parts = []
    for s in range(k_shards):
        b = u[s * blk : (s + 1) * blk]
        parts.append(b[: blk // 2] | (b[blk // 2 :] << 4))
    return np.concatenate(parts, axis=0)


def concat_qweights(ws, axis: int = -1) -> QWeight:
    """Concatenate QWeights along the output (column) axis.

    Column-wise concatenation is always valid for group-quantized
    weights: each column's groups quantize independently.  Used to fuse
    wq|wk|wv and w1|w3 into single matmuls.
    """
    kinds = {w.kind for w in ws}
    if len(kinds) != 1:
        raise ValueError(f"cannot concat mixed kinds {kinds}")

    def cat(field):
        vals = [getattr(w, field) for w in ws]
        if vals[0] is None:
            return None
        return jnp.concatenate(vals, axis=axis)

    return QWeight(
        qs=cat("qs"), scales=cat("scales"), mins=cat("mins"),
        scales_hi=cat("scales_hi"), kind=ws[0].kind, group=ws[0].group,
    )


def split_q4_scales(scales_t: np.ndarray, k_shards: int = 1):
    """[K//32, N] group scales -> (lo, hi) halves matching pack_q4_rows.

    Per K-shard block, the first half of its group rows scales the low
    nibbles and the second half the high nibbles.  With k_shards > 1 the
    returned arrays are ordered shard-major, so slicing them into
    k_shards row chunks yields each shard's local lo/hi scales (the
    layout shard_map sees).
    """
    G = scales_t.shape[0]
    blk = G // k_shards
    lo_parts, hi_parts = [], []
    for s in range(k_shards):
        b = scales_t[s * blk : (s + 1) * blk]
        lo_parts.append(b[: blk // 2])
        hi_parts.append(b[blk // 2 :])
    return np.concatenate(lo_parts, 0), np.concatenate(hi_parts, 0)


def from_kquant_raw(
    gtype, raw: bytes, shape, scale_dtype=jnp.float32,
    use_i4: bool | None = None,
) -> QWeight:
    """GGUF k-quant block stream ([out, in] tensor) -> native device
    QWeight (bit-exact with scale_dtype=f32).

    Exactness caveat: the derived per-group scale s = d*sc (an f16 x
    6-bit product, exactly representable in f32 but usually not in
    bf16) and the affine bias 8s-m / 16s-m are rounded to
    `scale_dtype`.  The loader's default bf16 sides therefore carry
    ~0.2% relative side rounding — the same class as the bf16 scale
    rounding q4_0/q8_0 take for the halved side traffic; pass
    scale_dtype=f32 for bit-exact dequantization.

    The k-quant super-block structure (ggml/kquants.py) reduces to
    per-group affine codes:  w = s[g]*code - m[g].  On device that is
      Q4_K: int4 qs = code-8,  scales = s, mins = 8*s  - m  (group 32)
      Q5_K: int8 qs = code-16, scales = s, mins = 16*s - m  (group 32)
      Q6_K: int8 qs = code,    scales = s, mins = None      (group 16)
    with dequant w = qs*scales + mins — exactly QWeight.dequantize's
    affine form, so the GEMV kernel serves these at native bandwidth
    (~5 bpw for Q4_K) instead of a requantize-to-Q8_0 detour (~8.5 bpw
    on device plus a second rounding).

    use_i4: keep 4-bit codes as int4 (default: ops.dispatch.int4_codes).
    """
    from tokenhawk_tpu.ggml.format import GGMLType
    from tokenhawk_tpu.ggml.kquants import (
        extract_q2_k,
        extract_q3_k,
        extract_q4_k,
        extract_q5_k,
        extract_q6_k,
    )

    out_dim, in_dim = shape
    n = out_dim * in_dim
    if use_i4 is None:
        from tokenhawk_tpu.ops.dispatch import int4_codes

        use_i4 = int4_codes()

    if gtype == GGMLType.Q4_K:
        group = 32
        codes, s, m = extract_q4_k(raw, n)
        if use_i4:
            qs_np = (codes.astype(np.int16) - 8).astype(np.int8)
            qdtype = jnp.int4
            bias = 8.0 * s - m
        else:
            qs_np = codes.astype(np.int8)
            qdtype = jnp.int8
            bias = -m
    elif gtype == GGMLType.Q5_K:
        codes, s, m = extract_q5_k(raw, n)
        group = 32
        qs_np = (codes.astype(np.int16) - 16).astype(np.int8)
        qdtype = jnp.int8
        bias = 16.0 * s - m
    elif gtype == GGMLType.Q6_K:
        codes, s = extract_q6_k(raw, n)
        group = 16
        qs_np = codes
        qdtype = jnp.int8
        bias = None
    elif gtype == GGMLType.Q2_K:
        codes, s, m = extract_q2_k(raw, n)
        group = 16
        if use_i4:
            qs_np = (codes.astype(np.int16) - 2).astype(np.int8)
            qdtype = jnp.int4
            bias = 2.0 * s - m
        else:
            qs_np = codes.astype(np.int8)
            qdtype = jnp.int8
            bias = -m
    elif gtype == GGMLType.Q3_K:
        codes, s = extract_q3_k(raw, n)
        group = 16
        qs_np = codes  # already [-4, 3]
        qdtype = jnp.int4 if use_i4 else jnp.int8
        bias = None
    else:
        raise ValueError(f"not a supported k-quant: {gtype!r}")

    # [out, in] -> [in, out] device orientation; groups run down `in`.
    qs_t = np.ascontiguousarray(qs_np.reshape(out_dim, in_dim).T)
    s_t = np.ascontiguousarray(
        s.reshape(out_dim, in_dim // group).T).astype(np.float32)
    qs_dev = jnp.asarray(qs_t, dtype=qdtype)
    mins_dev = None
    if bias is not None:
        m_t = np.ascontiguousarray(
            bias.reshape(out_dim, in_dim // group).T).astype(np.float32)
        mins_dev = jnp.asarray(m_t, dtype=scale_dtype)
    return QWeight(
        qs=qs_dev, scales=jnp.asarray(s_t, dtype=scale_dtype),
        mins=mins_dev, scales_hi=None,
        kind="qk_i4" if qdtype == jnp.int4 else "qk_i8", group=group,
    )


def to_qk16(w: QWeight) -> QWeight:
    """EXACT re-encode of an affine/symmetric int-code QWeight to the
    common (int8 codes, group 16, with mins) form.

    Used to stack per-layer weights when a GGUF file mixes kinds within
    one tensor family across layers (llama.cpp's *_M recipes put Q6_K in
    attention.wv / feed_forward.w2 on some layers): group-32 scales
    repeat to group-16, missing mins become zeros, int4 codes widen to
    int8 — every represented value is unchanged, only the container
    grows (group-16 affine int8 = 1.25 B/elt)."""
    if w.kind == "qk_i8" and w.group == 16 and w.mins is not None:
        return w
    if w.kind in ("qk_i4", "qk_i8", "q8_0"):
        qs = w.qs.astype(jnp.int8)
        rep = w.group // 16
        if rep > 1:
            scales = jnp.repeat(w.scales, rep, axis=-2)
            mins = (jnp.repeat(w.mins, rep, axis=-2)
                    if w.mins is not None else None)
        else:
            scales = w.scales
            mins = w.mins
        if mins is None:
            mins = jnp.zeros_like(scales)
        return QWeight(qs=qs, scales=scales, mins=mins, scales_hi=None,
                       kind="qk_i8", group=16)
    raise ValueError(f"cannot re-encode kind {w.kind!r} to qk16")


def from_quantized_tensor(
    qt: QuantizedTensor, scale_dtype=jnp.float32, k_shards: int = 1
) -> QWeight:
    """GGML host tensor [out, in] -> device QWeight [in, out] (q4_0 packed)."""
    if qt.qs.ndim != 2:
        raise ValueError(f"expected 2-D weight, got {qt.shape}")
    if qt.kind in (GGMLType.Q5_0, GGMLType.Q5_1):
        # 5-bit codes don't pack into int4; serve as the affine int8
        # layout (qk_i8): Q5_0 symmetric [-16,15], Q5_1 affine
        # [0,31] with per-group mins.
        qs_t = jnp.asarray(np.ascontiguousarray(qt.qs.T))  # int8 [in, out]
        s_t = jnp.asarray(np.ascontiguousarray(qt.scales.T),
                          dtype=scale_dtype)
        m_t = None
        if qt.mins is not None:
            m_t = jnp.asarray(np.ascontiguousarray(qt.mins.T),
                              dtype=scale_dtype)
        return QWeight(qs=qs_t, scales=s_t, mins=m_t, scales_hi=None,
                       kind="qk_i8", group=QK)
    kind = {GGMLType.Q8_0: "q8_0", GGMLType.Q4_0: "q4_0", GGMLType.Q4_1: "q4_1"}[
        qt.kind
    ]
    qs_t = np.ascontiguousarray(qt.qs.T)  # [in, out] int8
    scales_t = np.ascontiguousarray(qt.scales.T).astype(np.float32)
    scales_hi = None
    if kind == "q4_0":
        qs = jnp.asarray(pack_q4_rows(qs_t, k_shards))
        lo, hi = split_q4_scales(scales_t, k_shards)
        scales = jnp.asarray(lo, dtype=scale_dtype)
        scales_hi = jnp.asarray(hi, dtype=scale_dtype)
    else:
        qs = jnp.asarray(qs_t)
        scales = jnp.asarray(scales_t, dtype=scale_dtype)
    mins = None
    if qt.mins is not None:
        mins = jnp.asarray(np.ascontiguousarray(qt.mins.T), dtype=scale_dtype)
    return QWeight(qs=qs, scales=scales, mins=mins, scales_hi=scales_hi, kind=kind)


def quantize_array(
    w, kind: str, group: int = QK, scale_dtype=jnp.float32, k_shards: int = 1
) -> QWeight:
    """Quantize a dense [K, N] device/host array into a QWeight (tests)."""
    from tokenhawk_tpu.ggml import quants as hq

    w = np.asarray(w, dtype=np.float32).T  # -> [N, K]: groups along last axis
    gk = {"q8_0": GGMLType.Q8_0, "q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1}[kind]
    qt = hq.quantize(w, gk)
    return from_quantized_tensor(qt, scale_dtype=scale_dtype, k_shards=k_shards)
