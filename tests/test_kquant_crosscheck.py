"""k-quant layout cross-validation.

No llama.cpp binary, `gguf` package, or real weight file exists in this
environment (zero egress), so layout correctness is validated by the
strongest available proxy: TWO independently written implementations —
the vectorized numpy codecs (ggml/kquants.py) and the scalar C
dequantizers in native/thawk_native.cpp (element-at-a-time, the shape of
llama.cpp's scalar reference code) — must agree BIT FOR BIT on random
block streams, plus a hand-derived byte fixture for the trickiest
packing (the 6-bit get_scale_min_k4 split fields).
"""

from __future__ import annotations

import numpy as np
import pytest

from tokenhawk_tpu.ggml import native
from tokenhawk_tpu.ggml import kquants as kq
from tokenhawk_tpu.ggml.format import GGMLType

_CODECS = {
    GGMLType.Q2_K: (kq.quantize_q2_k, kq.dequant_q2_k),
    GGMLType.Q3_K: (kq.quantize_q3_k, kq.dequant_q3_k),
    GGMLType.Q4_K: (kq.quantize_q4_k, kq.dequant_q4_k),
    GGMLType.Q5_K: (kq.quantize_q5_k, kq.dequant_q5_k),
    GGMLType.Q6_K: (kq.quantize_q6_k, kq.dequant_q6_k),
}


@pytest.mark.parametrize("kind", list(_CODECS))
def test_numpy_vs_c_bit_exact(rng, kind):
    if not native.available():
        pytest.skip("native library unavailable")
    enc, dec = _CODECS[kind]
    x = rng.standard_normal(8 * kq.QK_K).astype(np.float32) * 3.0
    raw = enc(x)
    a = dec(raw, x.size)
    b = native.dequant_kquant_c(kind, raw, x.size)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", list(_CODECS))
def test_numpy_vs_c_on_random_bytes(rng, kind):
    """Agreement must hold for ARBITRARY byte streams, not only streams
    our own encoder produces — this catches layout misreads the encoder
    round-trip cannot (both sides of a self-consistent pair can share a
    transposed field)."""
    if not native.available():
        pytest.skip("native library unavailable")
    _, dec = _CODECS[kind]
    nb = 6
    bb = kq.KQUANT_BLOCK_BYTES[kind]
    raw = rng.integers(0, 256, nb * bb, dtype=np.uint8)
    # keep the f16 fields finite so NaN != NaN cannot mask a layout bug:
    # zero every f16 exponent's top bit
    raw = raw.copy()
    if kind in (GGMLType.Q4_K, GGMLType.Q5_K):
        for i in range(nb):
            raw[i * bb + 1] &= 0x3F
            raw[i * bb + 3] &= 0x3F
    elif kind == GGMLType.Q6_K:
        for i in range(nb):
            raw[i * bb + 209] &= 0x3F
    elif kind == GGMLType.Q2_K:
        for i in range(nb):
            raw[i * bb + 81] &= 0x3F
            raw[i * bb + 83] &= 0x3F
    elif kind == GGMLType.Q3_K:
        for i in range(nb):
            raw[i * bb + 109] &= 0x3F
    n = nb * kq.QK_K
    a = dec(raw.tobytes(), n)
    b = native.dequant_kquant_c(kind, raw.tobytes(), n)
    np.testing.assert_array_equal(a, b)


def test_q4k_hand_fixture():
    """One Q4_K block built byte by byte; expected values derived by
    hand from the struct spec:

      d = 0.5 (f16 0x3800), dmin = 0.25 (f16 0x3400)
      scales[12]: sub-block 0 -> (sc=3, mn=5); sub-block 5 -> the
        split-field encoding with sc=35 (0b100011), mn=49 (0b110001):
        low 4 bits of sc in scales[9]&0xF, high 2 in scales[1]>>6;
        low 4 of mn in scales[9]>>4, high 2 in scales[5]>>6.
      qs[0] = 0xB2: element 0 = low nibble 2, element 32 = high nibble 11
        (elements 0-31 = low nibbles of bytes 0-31, 32-63 = high).

      y[0]   = d*sc0*2 - dmin*mn0 = 0.5*3*2 - 0.25*5 = 1.75
      y[32]  = d*sc1*11 - dmin*mn1 (sub-block 1: sc=0, mn=0) = 0
      element 160 (sub-block 5, chunk 2 high nibbles): qs[2*32+0]=0x40
        -> code 4; y[160] = 0.5*35*4 - 0.25*49 = 70 - 12.25 = 57.75
    """
    blk = np.zeros(144, np.uint8)
    blk[0:2] = (0x00, 0x38)  # d = 0.5
    blk[2:4] = (0x00, 0x34)  # dmin = 0.25
    scales = np.zeros(12, np.uint8)
    scales[0] = 3   # sc0 low bits
    scales[4] = 5   # mn0 low bits
    # sub-block 5 (j=5 >= 4): sc5 = 35 = 0b10_0011, mn5 = 49 = 0b11_0001
    scales[9] = (35 & 0x0F) | ((49 & 0x0F) << 4)
    scales[1] |= (35 >> 4) << 6
    scales[5] |= (49 >> 4) << 6
    blk[4:16] = scales
    qs = np.zeros(128, np.uint8)
    qs[0] = 0xB2        # chunk 0: elem 0 = 2 (low), elem 32 = 11 (high)
    qs[2 * 32 + 0] = 0x40  # chunk 2: elem 128 = 0 (low), elem 160 = 4 (high)
    blk[16:144] = qs

    y = kq.dequant_q4_k(blk.tobytes(), kq.QK_K)
    assert y[0] == pytest.approx(1.75)
    assert y[32] == pytest.approx(0.0)
    assert y[160] == pytest.approx(57.75)
    # unset elements of sub-block 0 decode to code 0: -dmin*mn0 = -1.25
    assert y[1] == pytest.approx(0.5 * 3 * 0 - 0.25 * 5)
    if native.available():
        c = native.dequant_kquant_c(GGMLType.Q4_K, blk.tobytes(), kq.QK_K)
        np.testing.assert_array_equal(y, c)
