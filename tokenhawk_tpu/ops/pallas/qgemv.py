"""Dequantizing GEMV for decode row counts (Pallas, Triton route).

y[M, N] = x[M, K] @ dequant(W)[K, N] for M <= MAX_ROWS, reading the
quantized codes and their scales once and never writing a dense copy of
the weight.  Decode is bound by the weight stream (3.72 GB per token at
7B q4_0), so the kernel's job is to keep every byte it reads at 0.56 B
per weight instead of the 0.56 + 2 + 2 B of a dequantize-then-GEMV.

Layouts (ops/qweight.py):
  q4_0   qs uint8 [K//2, N]: byte row j holds logical row j (low nibble)
         and row j + K//2 (high nibble), offset-binary; scales [K//64, N]
         for the low half and scales_hi [K//64, N] for the high half.
  q8_0   qs int8 [K, N], scales [K//32, N].
  qk_i4  qs int4 [K, N], scales and mins [K//g, N] (k-quant affine form).
  qk_i8  qs int8 [K, N], scales [K//g, N], optional mins.

One block owns a BN-column slab and a contiguous run of quantization
groups.  Per group it does one tensor-core dot of the (zero-padded)
[16, g] activation slice with the integer codes (exact in bf16) and
scales the [16, BN] partial by the group's scale row in f32.  The affine
term of the k-quant kinds, sum_g (sum_k x) * mins[g], is a small XLA
GEMV outside the kernel.  When the column slabs alone would leave the
card's SMs idle, the groups split across blocks (split-K) and XLA sums
the f32 partials.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_ROWS = 16  # decode rows the kernel takes; more rows go to XLA's GEMM
_M = 16  # dot rows (the tensor-core minimum); x is zero-padded to it
_TARGET_BLOCKS = 256  # ~2 blocks per SM on a 132-SM card
_MAX_SPLITS = 8
KINDS = ("q4_0", "q8_0", "qk_i4", "qk_i8")


def block_n(n: int) -> int | None:
    for bn in (64, 32, 16):
        if n % bn == 0:
            return bn
    return None


def supported(rows: int, w) -> bool:
    """The kernel-choice rule: which (rows, weight) the kernel takes."""
    if w.kind not in KINDS or w.qs.ndim != 2 or not 1 <= rows <= MAX_ROWS:
        return False
    if w.kind == "q4_0" and w.scales_hi is None:
        return False
    # code rows: K, or K/2 for q4_0's two nibbles per byte
    return (block_n(w.qs.shape[-1]) is not None
            and w.group >= 16 and w.qs.shape[-2] % w.group == 0)


def _splits(n_blocks: int, n_groups: int) -> int:
    s = 1
    while (n_blocks * s < _TARGET_BLOCKS and s < _MAX_SPLITS
           and n_groups % (2 * s) == 0):
        s *= 2
    return s


def _unroll(n: int) -> int:
    return next(u for u in (4, 2, 1) if n % u == 0)


def _kernel(x_ref, qs_ref, s_ref, *rest, packed, group, half, n_iter,
            unroll):
    if packed:
        sh_ref, o_ref = rest
    else:
        (o_ref,) = rest
    g0 = pl.program_id(1) * (n_iter * unroll)

    def body(i, acc):
        for u in range(unroll):
            g = g0 + i * unroll + u
            r = pl.multiple_of(g * group, group)
            codes = qs_ref[pl.ds(r, group), :]
            s = s_ref[pl.ds(g, 1), :].astype(jnp.float32)
            if packed:
                lo = (codes & 0x0F).astype(jnp.bfloat16) - 8.0
                hi = (codes >> 4).astype(jnp.bfloat16) - 8.0
                sh = sh_ref[pl.ds(g, 1), :].astype(jnp.float32)
                xh = x_ref[:, pl.ds(r + half, group)]
                acc += pl.dot(x_ref[:, pl.ds(r, group)], lo) * s
                acc += pl.dot(xh, hi) * sh
            else:
                w = codes.astype(jnp.bfloat16)
                acc += pl.dot(x_ref[:, pl.ds(r, group)], w) * s
        return acc

    acc = jnp.zeros(o_ref.shape, jnp.float32)
    o_ref[...] = lax.fori_loop(0, n_iter, body, acc)


@functools.partial(jax.jit, static_argnames=("interpret",))
def qgemv(x: jax.Array, w, interpret: bool = False) -> jax.Array:
    """x [..., K] @ w -> [..., N] in x.dtype (f32 accumulation).

    Callers check `supported(rows, w)` first."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    M = x.size // K
    N = w.qs.shape[-1]
    g = w.group
    packed = w.kind == "q4_0"
    code_rows = w.qs.shape[-2]
    n_groups = code_rows // g
    bn = block_n(N)
    n_blocks = N // bn
    splits = _splits(n_blocks, n_groups)
    per_split = n_groups // splits
    unroll = _unroll(per_split)

    x2 = x.reshape(M, K)
    xp = jnp.zeros((_M, K), jnp.bfloat16).at[:M].set(x2.astype(jnp.bfloat16))
    kernel = functools.partial(
        _kernel, packed=packed, group=g, half=K // 2,
        n_iter=per_split // unroll, unroll=unroll)
    side = pl.BlockSpec((n_groups, bn), lambda j, s: (0, j))
    in_specs = [
        pl.BlockSpec((_M, K), lambda j, s: (0, 0)),
        pl.BlockSpec((code_rows, bn), lambda j, s: (0, j)),
        side,
    ]
    args = [xp, w.qs, w.scales]
    if packed:
        in_specs.append(side)
        args.append(w.scales_hi)
    part = pl.pallas_call(
        kernel,
        grid=(n_blocks, splits),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((None, _M, bn), lambda j, s: (s, 0, j)),
        out_shape=jax.ShapeDtypeStruct((splits, _M, N), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=4),
        interpret=interpret,
        name=f"qgemv_{w.kind}_g{g}",
    )(*args)
    y = jnp.sum(part, axis=0)[:M]
    if w.mins is not None:
        xs = x2.astype(jnp.float32).reshape(M, K // g, g).sum(-1)
        y = y + jnp.dot(xs, w.mins.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
    return y.reshape(*lead, N).astype(x.dtype)
