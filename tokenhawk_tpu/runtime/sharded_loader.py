"""Host-local sharded weight loading for multi-host TP.

`runtime.loader.load_model` materializes every tensor in host RAM before
`device_put` — fine for one host, fatal for a 70B multi-host slice.
Here each weight becomes a `jax.make_array_from_callback` whose callback
reads ONLY the byte ranges of the mmap'd GGML file that the requesting
shard covers (the multi-host generalization of the reference's
128 MB-scratch streaming loader, /root/reference/th-llama-loader.cpp:571-621):

  * on an N-process slice, each process materializes 1/tp of every
    column/row-parallel weight (its own devices' shards) plus the small
    replicated norms;
  * disk reads are numpy views into the mmap, so the OS pages in only
    the touched ranges.

70B memory math (q4_0, tp=16 over 2 hosts x 8 cards): weights ~36.5 GB
packed -> 2.3 GB per card, 18.2 GB materialized per host during load
(vs 36.5 GB/host through the dense loader); f16 doubles to ~69 GB total,
4.3 GB/card, and host RSS stays at the per-host shard total instead of
the full model.

Layout contracts match params_from_ggml/parallel.tp exactly:
2-D weights transpose to [in, out]; q4_0 packs nibbles per K-shard
(ops.qweight.pack_q4_rows semantics) so row-parallel shards slice clean.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.ggml.format import GGMLType, TYPE_BLOCK_BYTES
from tokenhawk_tpu.ggml.quants import from_blocks
from tokenhawk_tpu.models.llama import LayerParams, LlamaParams
from tokenhawk_tpu.ops.qweight import QWeight, pack_q4_rows
from tokenhawk_tpu.parallel.mesh import MODEL_AXIS
from tokenhawk_tpu.parallel.tp import param_specs_tp, validate_tp
from tokenhawk_tpu.runtime.loader import config_from_hparams
from tokenhawk_tpu.tokenizer import Tokenizer

QK = 32


class ShardReader:
    """Slice-wise reads from a GGML mmap; counts bytes actually decoded."""

    def __init__(self, f):
        self.f = f
        self.bytes_read = 0

    def _dense_view(self, rec, raw):
        dt = {GGMLType.F16: np.float16, GGMLType.F32: np.float32}[rec.ggml_type]
        shape = rec.shape if len(rec.shape) == 2 else (1, *rec.shape)
        return np.frombuffer(raw, dt).reshape(shape)

    def dense_slice(self, name: str, rows: slice, cols: slice) -> np.ndarray:
        """Disk-layout ([out, in]) f32 slice; decodes quant blocks if needed."""
        rec = self.f.tensors[name]
        raw = self.f.raw(name)
        if rec.ggml_type in (GGMLType.F16, GGMLType.F32):
            out = np.asarray(self._dense_view(rec, raw)[rows, cols], np.float32)
            self.bytes_read += out.size * (2 if rec.ggml_type == GGMLType.F16 else 4)
            return out
        # quantized: decode only the covering block range of the sliced rows
        _, cols_total = rec.shape
        c0 = 0 if cols.start is None else cols.start
        c1 = cols_total if cols.stop is None else cols.stop
        qs_t, scales_t = self.quant_slices(name, slice(c0 - c0 % QK, c1), rows)
        qt_rows = qs_t.T  # [n, k]
        dense = qt_rows.astype(np.float32).reshape(
            qt_rows.shape[0], -1, QK
        ) * scales_t.T[:, :, None]
        dense = dense.reshape(qt_rows.shape[0], -1)
        return dense[:, (c0 % QK):(c0 % QK) + (c1 - c0)]

    def quant_slices(self, name: str, krange: slice, nrange: slice):
        """Decode only blocks [krange) x disk rows [nrange).

        Disk layout: row n holds K columns as K/32 blocks.  Returns
        transposed slices (qs_t [k_local, n_local] int8 codes with sign
        applied for q4_0, scales_t [k_local/32, n_local] f32).
        """
        rec = self.f.tensors[name]
        rows_total, cols_total = rec.shape
        bb = TYPE_BLOCK_BYTES[rec.ggml_type]
        nb = cols_total // QK
        raw = np.frombuffer(self.f.raw(name), np.uint8).reshape(rows_total, nb, bb)
        blo = (0 if krange.start is None else krange.start) // QK
        bhi = (cols_total if krange.stop is None else krange.stop) // QK
        chunk = np.ascontiguousarray(raw[nrange, blo:bhi])
        self.bytes_read += chunk.nbytes
        qt = from_blocks(rec.ggml_type, chunk.tobytes(),
                         (chunk.shape[0], (bhi - blo) * QK))
        return (
            np.ascontiguousarray(qt.qs.T),
            np.ascontiguousarray(qt.scales.T).astype(np.float32),
        )


def _norm(s: slice, total: int) -> Tuple[int, int]:
    return (0 if s.start is None else s.start,
            total if s.stop is None else s.stop)


def _layer_names(fmt: str, lsl: slice, L: int):
    lo, hi = _norm(lsl, L)
    return [fmt.format(i) for i in range(lo, hi)]


def load_model_sharded(
    path: str,
    mesh: Mesh,
    n_ctx: int = 2048,
    dtype=jnp.bfloat16,
    scale_dtype=jnp.bfloat16,
    **config_overrides,
) -> Tuple[LlamaConfig, LlamaParams, Tokenizer, ShardReader]:
    """GGML file -> TP-sharded params, each shard's bytes read locally.

    Produces the stacked UNFUSED TP layout (param_specs_tp); apply
    fusion on-device afterwards if desired.  Returns the ShardReader for
    byte-accounting (tests assert no shard over-reads).
    """
    from tokenhawk_tpu.ggml.reader import GGMLFile

    f = GGMLFile(path)
    w1 = f.tensors.get("layers.0.feed_forward.w1.weight")
    if w1 is not None:
        config_overrides.setdefault("n_ff", w1.shape[0])
    cfg = config_from_hparams(f.hparams, n_ctx=n_ctx, **config_overrides)
    tokenizer = Tokenizer.from_vocab(f.vocab)
    tp = mesh.shape[MODEL_AXIS]
    validate_tp(cfg, tp)
    rd = ShardReader(f)
    specs = param_specs_tp()
    L = cfg.n_layer

    def dense_leaf(global_shape, spec, cb):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(global_shape, sh, cb)

    def stacked_2d(fmt: str, K: int, N: int, spec: P):
        """Stacked [L, K, N] device-layout ([in, out]) dense bf16 leaf."""

        def cb(index):
            lsl, ksl, nsl = index
            parts = [
                rd.dense_slice(n, nsl, ksl).T  # disk [out, in] -> [in, out]
                for n in _layer_names(fmt, lsl, L)
            ]
            return np.stack(parts).astype(jnp.bfloat16 if dtype == jnp.bfloat16
                                          else np.float32)

        return dense_leaf((L, K, N), spec, cb)

    def stacked_q8(fmt: str, K: int, N: int, col_parallel: bool):
        qspec = P(None, None, MODEL_AXIS) if col_parallel else P(None, MODEL_AXIS, None)

        def qs_cb(index):
            lsl, ksl, nsl = index
            return np.stack([
                rd.quant_slices(n, ksl, nsl)[0]
                for n in _layer_names(fmt, lsl, L)
            ])

        def sc_cb(index):
            lsl, ssl, nsl = index
            s0, s1 = _norm(ssl, K // QK)
            kr = slice(s0 * QK, s1 * QK)
            return np.stack([
                rd.quant_slices(n, kr, nsl)[1]
                for n in _layer_names(fmt, lsl, L)
            ]).astype(np.float32 if scale_dtype == jnp.float32 else jnp.bfloat16)

        qs = dense_leaf((L, K, N), qspec, qs_cb)
        scales = dense_leaf((L, K // QK, N), qspec, sc_cb)
        return QWeight(qs=qs, scales=scales, mins=None, kind="q8_0")

    def stacked_q4(fmt: str, K: int, N: int, col_parallel: bool):
        """q4_0: packed [L, K/2, N] + lo/hi scales [L, K/64, N].

        Row-parallel K-shards each pack their own rows (pack_q4_rows
        k_shards semantics), so a packed-dim slice [p0, p1) maps to disk
        k rows: shard extent per = K/(2 tp); shard i = p0 // per; its k
        rows start at i*K/tp."""
        qspec = P(None, None, MODEL_AXIS) if col_parallel else P(None, MODEL_AXIS, None)
        KP, SG = K // 2, K // 64
        per_p = KP if col_parallel else KP // tp
        per_s = SG if col_parallel else SG // tp

        def qs_cb(index):
            lsl, psl, nsl = index
            p0, p1 = _norm(psl, KP)
            if col_parallel:
                klo, khi = 0, K
            else:
                i = p0 // per_p
                klo = i * (K // tp)
                khi = klo + 2 * (p1 - p0)
            parts = []
            for n in _layer_names(fmt, lsl, L):
                qs_t, _ = rd.quant_slices(n, slice(klo, khi), nsl)
                parts.append(pack_q4_rows(qs_t, k_shards=1))
            return np.stack(parts)

        def sc_cb(index, hi_half: bool):
            lsl, ssl, nsl = index
            s0, s1 = _norm(ssl, SG)
            if col_parallel:
                base = 0
                span = K // 2
            else:
                i = s0 // per_s
                base = i * (K // tp)
                span = K // (2 * tp)
            off = base + (span if hi_half else 0)
            kr = slice(off + (s0 % per_s) * QK,
                       off + (s0 % per_s) * QK + (s1 - s0) * QK)
            return np.stack([
                rd.quant_slices(n, kr, nsl)[1]
                for n in _layer_names(fmt, lsl, L)
            ]).astype(np.float32 if scale_dtype == jnp.float32 else jnp.bfloat16)

        qs = dense_leaf((L, KP, N), qspec, qs_cb)
        lo = dense_leaf((L, SG, N), qspec, lambda i: sc_cb(i, False))
        hi = dense_leaf((L, SG, N), qspec, lambda i: sc_cb(i, True))
        return QWeight(qs=qs, scales=lo, mins=None, scales_hi=hi, kind="q4_0")

    def weight(fmt: str, K: int, N: int, spec: P, col_parallel: bool):
        kind = f.tensors[fmt.format(0)].ggml_type
        if kind == GGMLType.Q8_0:
            return stacked_q8(fmt, K, N, col_parallel)
        if kind == GGMLType.Q4_0:
            return stacked_q4(fmt, K, N, col_parallel)
        return stacked_2d(fmt, K, N, spec)

    D, F, V, Dkv = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_embd_kv
    col, row = P(None, None, MODEL_AXIS), P(None, MODEL_AXIS, None)
    layers = LayerParams(
        wq=weight("layers.{}.attention.wq.weight", D, D, col, True),
        wk=weight("layers.{}.attention.wk.weight", D, Dkv, col, True),
        wv=weight("layers.{}.attention.wv.weight", D, Dkv, col, True),
        wo=weight("layers.{}.attention.wo.weight", D, D, row, False),
        w1=weight("layers.{}.feed_forward.w1.weight", D, F, col, True),
        w2=weight("layers.{}.feed_forward.w2.weight", F, D, row, False),
        w3=weight("layers.{}.feed_forward.w3.weight", D, F, col, True),
        attn_norm=dense_leaf(
            (L, D), P(None, None),
            lambda idx: np.stack([
                rd.dense_slice(n, slice(None), idx[1])[0]
                for n in _layer_names("layers.{}.attention_norm.weight",
                                      idx[0], L)
            ]).astype(jnp.bfloat16 if dtype == jnp.bfloat16 else np.float32),
        ),
        ffn_norm=dense_leaf(
            (L, D), P(None, None),
            lambda idx: np.stack([
                rd.dense_slice(n, slice(None), idx[1])[0]
                for n in _layer_names("layers.{}.ffn_norm.weight", idx[0], L)
            ]).astype(jnp.bfloat16 if dtype == jnp.bfloat16 else np.float32),
        ),
    )

    def embd_cb(index):
        vsl, dsl = index
        # embedding stays [V, D] (gather table) and densifies
        rec = f.tensors["tok_embeddings.weight"]
        if rec.ggml_type in (GGMLType.F16, GGMLType.F32):
            out = rd.dense_slice("tok_embeddings.weight", vsl, dsl)
        else:
            qs_t, sc_t = rd.quant_slices("tok_embeddings.weight",
                                         slice(None), vsl)
            rows = qs_t.T
            out = (rows.astype(np.float32).reshape(rows.shape[0], -1, QK)
                   * sc_t.T[:, :, None]).reshape(rows.shape[0], -1)
            d0, d1 = _norm(dsl, cfg.n_embd)
            out = out[:, d0:d1]
        return out.astype(jnp.bfloat16 if dtype == jnp.bfloat16 else np.float32)

    def out_cb(index):
        dsl, vsl = index
        return rd.dense_slice("output.weight", vsl, dsl).T.astype(
            jnp.bfloat16 if dtype == jnp.bfloat16 else np.float32
        )

    def output_weight():
        kind = f.tensors["output.weight"].ggml_type
        if kind not in (GGMLType.Q8_0, GGMLType.Q4_0):
            return dense_leaf((D, V), P(None, MODEL_AXIS), out_cb)
        # vocab-column-parallel quantized head: qs [D(,or D/2), V]
        sdt = np.float32 if scale_dtype == jnp.float32 else jnp.bfloat16
        if kind == GGMLType.Q8_0:
            qs = dense_leaf(
                (D, V), P(None, MODEL_AXIS),
                lambda i: rd.quant_slices("output.weight", i[0], i[1])[0])
            sc = dense_leaf(
                (D // QK, V), P(None, MODEL_AXIS),
                lambda i: rd.quant_slices(
                    "output.weight",
                    slice(_norm(i[0], D // QK)[0] * QK,
                          _norm(i[0], D // QK)[1] * QK), i[1])[1].astype(sdt))
            return QWeight(qs=qs, scales=sc, mins=None, kind="q8_0")
        qs = dense_leaf(
            (D // 2, V), P(None, MODEL_AXIS),
            lambda i: pack_q4_rows(
                rd.quant_slices("output.weight", slice(0, D), i[1])[0],
                k_shards=1))
        lo = dense_leaf(
            (D // 64, V), P(None, MODEL_AXIS),
            lambda i: rd.quant_slices(
                "output.weight", slice(0, D // 2), i[1])[1].astype(sdt))
        hi = dense_leaf(
            (D // 64, V), P(None, MODEL_AXIS),
            lambda i: rd.quant_slices(
                "output.weight", slice(D // 2, D), i[1])[1].astype(sdt))
        return QWeight(qs=qs, scales=lo, mins=None, scales_hi=hi, kind="q4_0")

    params = LlamaParams(
        tok_embd=dense_leaf((V, D), P(MODEL_AXIS, None), embd_cb),
        layers=layers,
        norm=dense_leaf(
            (D,), P(None),
            lambda idx: rd.dense_slice("norm.weight", slice(None), idx[0])[0]
            .astype(jnp.bfloat16 if dtype == jnp.bfloat16 else np.float32),
        ),
        output=output_weight(),
    )
    return cfg, params, tokenizer, rd
