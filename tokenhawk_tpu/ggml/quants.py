"""Block quantization codecs (numpy, host-side).

The reference detects Q4_0/Q4_1 records and rejects them
(/root/reference/th-llama-loader.cpp:157-160); supporting them (plus
Q8_0) weight-only is a core capability extension of this framework.

On-disk block layouts follow the ggjt-v1 era of llama.cpp (f32 block
scales, 32-element blocks, adjacent-pair nibble packing for Q4).  The
in-memory canonical form keeps the quantized integers *unpacked* as int8
plus separate f32 per-block scales; the device upload path re-packs them
(int4 / int8 payload + bf16 scales) for the dequantizing matmul paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from tokenhawk_tpu.ggml.format import GGMLType, QK, TYPE_BLOCK_BYTES


@dataclasses.dataclass
class QuantizedTensor:
    """Canonical host-side quantized tensor.

    qs:     int8, logical shape; Q4_0 values in [-8, 7], Q4_1 in [0, 15]
            (unsigned offsets), Q8_0 in [-127, 127].
    scales: float32, shape[:-1] + (shape[-1] // 32,)
    mins:   float32 like scales; only for Q4_1 (affine zero-point).
    """

    kind: GGMLType
    shape: Tuple[int, ...]
    qs: np.ndarray
    scales: np.ndarray
    mins: Optional[np.ndarray] = None

    @property
    def nbytes_packed(self) -> int:
        """Bytes this tensor occupies in its packed on-disk form."""
        n = int(np.prod(self.shape))
        return (n // QK) * TYPE_BLOCK_BYTES[self.kind]


def _blockify(x: np.ndarray) -> np.ndarray:
    """[..., N] float32 -> [..., N//QK, QK] blocks."""
    if x.shape[-1] % QK:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of {QK}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // QK, QK)


def quantize_q8_0(x: np.ndarray) -> QuantizedTensor:
    x = np.asarray(x, dtype=np.float32)
    b = _blockify(x)
    amax = np.max(np.abs(b), axis=-1)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(np.round(b * inv[..., None]), -127, 127).astype(np.int8)
    return QuantizedTensor(
        kind=GGMLType.Q8_0,
        shape=x.shape,
        qs=q.reshape(x.shape),
        scales=d.astype(np.float32),
    )


def quantize_q4_0(x: np.ndarray) -> QuantizedTensor:
    x = np.asarray(x, dtype=np.float32)
    b = _blockify(x)
    # Signed-absmax trick: keep the sign of the largest-magnitude element so
    # that it maps exactly onto the -8 end of the int4 range.
    idx = np.argmax(np.abs(b), axis=-1)
    amax_signed = np.take_along_axis(b, idx[..., None], axis=-1)[..., 0]
    d = amax_signed / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.round(b * inv[..., None]), -8, 7).astype(np.int8)
    return QuantizedTensor(
        kind=GGMLType.Q4_0,
        shape=x.shape,
        qs=q.reshape(x.shape),
        scales=d.astype(np.float32),
    )


def quantize_q4_1(x: np.ndarray) -> QuantizedTensor:
    x = np.asarray(x, dtype=np.float32)
    b = _blockify(x)
    mn = np.min(b, axis=-1)
    mx = np.max(b, axis=-1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.round((b - mn[..., None]) * inv[..., None]), 0, 15).astype(np.int8)
    return QuantizedTensor(
        kind=GGMLType.Q4_1,
        shape=x.shape,
        qs=q.reshape(x.shape),
        scales=d.astype(np.float32),
        mins=mn.astype(np.float32),
    )


def quantize(x: np.ndarray, kind: GGMLType) -> QuantizedTensor:
    if kind == GGMLType.Q8_0:
        return quantize_q8_0(x)
    if kind == GGMLType.Q4_0:
        return quantize_q4_0(x)
    if kind == GGMLType.Q4_1:
        return quantize_q4_1(x)
    raise ValueError(f"cannot quantize to {kind!r}")


def dequantize(t: QuantizedTensor) -> np.ndarray:
    qb = _blockify(t.qs.astype(np.float32))
    out = qb * t.scales[..., None]
    if t.mins is not None:  # affine kinds (Q4_1, Q5_1)
        out = out + t.mins[..., None]
    return out.reshape(t.shape).astype(np.float32)


# ---------------------------------------------------------------------------
# On-disk block (de)serialization
# ---------------------------------------------------------------------------


def to_blocks(t: QuantizedTensor) -> bytes:
    """Serialize to the ggjt-v1 packed block stream (row-major)."""
    n = int(np.prod(t.shape))
    nb = n // QK
    qs = t.qs.reshape(nb, QK)
    d = t.scales.reshape(nb)
    if t.kind == GGMLType.Q8_0:
        out = np.zeros((nb, 4 + QK), dtype=np.uint8)
        out[:, :4] = d.astype("<f4").view(np.uint8).reshape(nb, 4)
        out[:, 4:] = qs.view(np.uint8)
        return out.tobytes()
    if t.kind == GGMLType.Q4_0:
        u = (qs + 8).astype(np.uint8)  # [0, 15]
        packed = (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)
        out = np.zeros((nb, 4 + QK // 2), dtype=np.uint8)
        out[:, :4] = d.astype("<f4").view(np.uint8).reshape(nb, 4)
        out[:, 4:] = packed
        return out.tobytes()
    if t.kind == GGMLType.Q4_1:
        u = qs.astype(np.uint8)
        packed = (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)
        mn = t.mins.reshape(nb)
        out = np.zeros((nb, 8 + QK // 2), dtype=np.uint8)
        out[:, :4] = d.astype("<f4").view(np.uint8).reshape(nb, 4)
        out[:, 4:8] = mn.astype("<f4").view(np.uint8).reshape(nb, 4)
        out[:, 8:] = packed
        return out.tobytes()
    raise ValueError(f"to_blocks: unsupported {t.kind!r}")


def from_blocks(kind: GGMLType, raw: bytes, shape: Tuple[int, ...]) -> QuantizedTensor:
    """Parse a ggjt-v1 packed block stream into the canonical form."""
    n = int(np.prod(shape))
    nb = n // QK
    bb = TYPE_BLOCK_BYTES[kind]
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * bb).reshape(nb, bb)
    if kind == GGMLType.Q8_0:
        d = buf[:, :4].copy().view("<f4").reshape(nb)
        qs = buf[:, 4:].copy().view(np.int8).reshape(nb, QK)
        return QuantizedTensor(kind, tuple(shape), qs.reshape(shape),
                               d.astype(np.float32).reshape(*shape[:-1], -1))
    if kind == GGMLType.Q4_0:
        d = buf[:, :4].copy().view("<f4").reshape(nb)
        packed = buf[:, 4:]
        qs = np.zeros((nb, QK), dtype=np.int8)
        qs[:, 0::2] = (packed & 0x0F).astype(np.int8) - 8
        qs[:, 1::2] = (packed >> 4).astype(np.int8) - 8
        return QuantizedTensor(kind, tuple(shape), qs.reshape(shape),
                               d.astype(np.float32).reshape(*shape[:-1], -1))
    if kind == GGMLType.Q4_1:
        d = buf[:, :4].copy().view("<f4").reshape(nb)
        mn = buf[:, 4:8].copy().view("<f4").reshape(nb)
        packed = buf[:, 8:]
        qs = np.zeros((nb, QK), dtype=np.int8)
        qs[:, 0::2] = (packed & 0x0F).astype(np.int8)
        qs[:, 1::2] = (packed >> 4).astype(np.int8)
        return QuantizedTensor(
            kind, tuple(shape), qs.reshape(shape),
            d.astype(np.float32).reshape(*shape[:-1], -1),
            mn.astype(np.float32).reshape(*shape[:-1], -1),
        )
    raise ValueError(f"from_blocks: unsupported {kind!r}")
