"""GGML (ggjt v1) on-disk format constants.

Layout (mirrors the parsing the reference performs, without copying it —
/root/reference/th-llama-loader.cpp:47-119 for the header and 121-265 for
tensor records):

    uint32 magic   = 0x67676a74 ('ggjt', little-endian)
    uint32 version = 1
    uint32 n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, ftype
    n_vocab * { uint32 len; bytes token[len]; float32 score; }
    repeated tensor records until EOF:
        int32 n_dims; int32 name_len; int32 ftype
        int32 dims[n_dims]          # fastest-varying (columns) first
        bytes name[name_len]
        <pad to 32-byte file alignment>
        bytes data[row-major, dims reversed]

The reference only accepts F32/F16 and rejects quantized records
(/root/reference/th-llama-loader.cpp:157-160); this framework additionally
implements Q4_0/Q4_1/Q8_0 (weight-only quant, f32 block scales as in the
ggjt-v1 era of llama.cpp).
"""

from __future__ import annotations

import enum

GGML_MAGIC = 0x67676A74  # 'ggjt'
GGML_MAGIC_UNVERSIONED = 0x67676D6C  # 'ggml' (rejected, like the reference)
GGML_VERSION = 1

# TH chunk container used by the reference's streaming web loader
# (/root/reference/th-llama-loader.cpp:275-328).
TH_CHUNK_MAGIC = 0x1737
TH_CHUNK_VERSION = 1


class THChunkType(enum.IntEnum):
    HEADER = 0
    WEIGHTS = 1
    FOOTER = 2


class GGMLType(enum.IntEnum):
    """Tensor data types (ggml_type numbering)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    # k-quants (GGUF only; 256-element super-blocks).  Parsed by
    # ggml/kquants.py; served natively by the GEMV kernel
    # (ops/qweight.from_kquant_raw).
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14


# Bytes per block and elements per block for each type.
QK = 32  # quantization block length (elements)

TYPE_BLOCK_BYTES = {
    GGMLType.F32: 4,
    GGMLType.F16: 2,
    GGMLType.Q4_0: 4 + QK // 2,  # f32 scale + 32 nibbles   = 20 B / 32 elems
    GGMLType.Q4_1: 8 + QK // 2,  # f32 scale+min + nibbles  = 24 B / 32 elems
    GGMLType.Q8_0: 4 + QK,  # f32 scale + 32 int8      = 36 B / 32 elems
}

TYPE_BLOCK_ELEMS = {
    GGMLType.F32: 1,
    GGMLType.F16: 1,
    GGMLType.Q4_0: QK,
    GGMLType.Q4_1: QK,
    GGMLType.Q8_0: QK,
}


def tensor_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    be = TYPE_BLOCK_ELEMS[ggml_type]
    if n_elements % be:
        raise ValueError(
            f"{ggml_type.name} tensor size {n_elements} not a multiple of {be}"
        )
    return (n_elements // be) * TYPE_BLOCK_BYTES[ggml_type]


def is_quantized(ggml_type: GGMLType) -> bool:
    return ggml_type in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q8_0)
