"""Matmul over dense or quantized weights.

Decode row counts (<= 16 rows) of a supported quantized kind take the
dequantizing GEMV kernel (ops/pallas/qgemv.py) on the GPU: it reads the
codes once instead of writing and re-reading a dense copy.  Everything
else is plain XLA: the codes dequantize as codes x broadcast scale
feeding one dot, a form XLA can fuse into its GEMM operand (the
analogue of the reference's `vector_mat_mul_trans` GEMV family,
th.cpp:2839-3139, for the prefill-sized products).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tokenhawk_tpu.ops.qweight import ArrayOrQ, QWeight


def matmul(x: jax.Array, w: ArrayOrQ, norm_gain: jax.Array | None = None,
           *, eps: float = 1e-6, accum_dtype=jnp.float32) -> jax.Array:
    """x [..., K] @ w [K, N] -> [..., N] in x.dtype, f32 accumulation.

    With `norm_gain`, computes rms_norm(x, norm_gain) @ w (XLA fuses the
    norm into the producer of x)."""
    if norm_gain is not None:
        from tokenhawk_tpu.ops.norms import rms_norm

        x = rms_norm(x, norm_gain, eps)
    if isinstance(w, QWeight):
        from tokenhawk_tpu.ops.dispatch import kernel_mode
        from tokenhawk_tpu.ops.pallas import qgemv

        mode = kernel_mode("qgemv")
        rows = x.size // x.shape[-1]
        if mode is not None and qgemv.supported(rows, w):
            return qgemv.qgemv(x, w, interpret=(mode == "interpret"))
        return _matmul_quant(x, w, accum_dtype=accum_dtype)
    return jnp.dot(x, w.astype(x.dtype), preferred_element_type=accum_dtype).astype(
        x.dtype
    )


def _matmul_quant(x: jax.Array, w: QWeight, *, accum_dtype=jnp.float32) -> jax.Array:
    """Dequantizing matmul: y = x @ (codes * broadcast scales [+ mins]).

    The dequantized operand is one elementwise expression of the codes,
    so XLA can fuse it into the dot instead of materialising per-group
    partial products."""
    wd = w.dequantize(x.dtype)
    return jnp.dot(x, wd, preferred_element_type=accum_dtype).astype(x.dtype)


def dense_weight(w: ArrayOrQ, dtype=jnp.float32) -> jax.Array:
    return w.dequantize(dtype) if isinstance(w, QWeight) else w.astype(dtype)
