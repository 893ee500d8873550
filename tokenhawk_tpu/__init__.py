"""tokenhawk_tpu — a quantized LLM inference engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
kayvr/token-hawk (a hand-written WebGPU LLaMA inference engine):

  - GGML weight loading (f16, Q8_0, Q4_0, Q4_1) streamed into a
    GSPMD-sharded weight layout                      (`tokenhawk_tpu.ggml`)
  - SentencePiece-style BPE tokenizer                (`tokenhawk_tpu.tokenizer`)
  - Pallas (Triton route) dequantizing GEMV and paged
    decode-attention kernels                         (`tokenhawk_tpu.ops`)
  - a jit-compiled generation loop with on-device
    sampling and continuous batching                 (`tokenhawk_tpu.runtime`)
  - tensor/data-parallel sharding over a device mesh (`tokenhawk_tpu.parallel`)
  - CLI + streaming HTTP chat frontend               (`tokenhawk_tpu.cli`,
                                                      `tokenhawk_tpu.serving`)

The WebGPU reference keeps model state in C++ structs and encodes one
command buffer per token; here the whole decode step (embedding lookup ->
32 layers -> logits -> sampling -> KV append) is a single jitted XLA
program with donated KV buffers, so there is no per-token host round-trip.
"""

__version__ = "0.1.0"

from tokenhawk_tpu.config import LlamaConfig  # noqa: F401
