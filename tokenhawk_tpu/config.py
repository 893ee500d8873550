"""Model and runtime configuration.

The reference hard-codes LLaMA-7B hyper-parameters in its model struct
(/root/reference/th-llama.hpp:104-112: n_vocab 32000, n_ctx 512, n_embd
4096, n_head/n_layer 32) and derives n_ff at load time
(/root/reference/th-llama-loader.cpp:397).  Here the config is a frozen
dataclass so it can be closed over statically by jitted functions, and it
covers the whole LLaMA family (7B/13B/30B/65B and Llama-2 incl. GQA 70B)
plus tiny configs for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def llama_ffn_dim(n_embd: int, n_mult: int) -> int:
    """LLaMA-1 feed-forward width rule.

    Mirrors the derivation the reference performs at load time
    (/root/reference/th-llama-loader.cpp:397):
    n_ff = ((2*(4*n_embd)/3 + n_mult - 1)/n_mult)*n_mult  -> 11008 for 7B.
    """
    return ((2 * (4 * n_embd) // 3 + n_mult - 1) // n_mult) * n_mult


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Static hyper-parameters of a LLaMA-family model."""

    n_vocab: int = 32000
    n_embd: int = 4096
    n_head: int = 32
    n_layer: int = 32
    n_ctx: int = 2048
    n_mult: int = 256
    # Feed-forward width; None -> derived with the LLaMA-1 rule.
    n_ff: Optional[int] = None
    # Number of KV heads; None -> n_head (MHA). Llama-2-70B uses 8 (GQA).
    n_kv_head: Optional[int] = None
    # RoPE settings. The reference rotates adjacent (x0, x1) pairs with
    # theta = 10000^(-x/dims) (/root/reference/th.cpp:1457-1492); GGML
    # weights are pre-permuted for this "interleaved" convention.
    rope_theta: float = 10000.0
    # "interleaved" (GGML convention) or "half" (HF/Meta convention).
    rope_style: str = "interleaved"
    rms_norm_eps: float = 1e-6

    def __post_init__(self):
        if self.n_ff is None:
            object.__setattr__(self, "n_ff", llama_ffn_dim(self.n_embd, self.n_mult))
        if self.n_kv_head is None:
            object.__setattr__(self, "n_kv_head", self.n_head)
        if self.n_embd % self.n_head:
            raise ValueError("n_embd must be divisible by n_head")
        if self.n_head % self.n_kv_head:
            raise ValueError("n_head must be divisible by n_kv_head")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_embd_kv(self) -> int:
        return self.n_kv_head * self.head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

    # ---- presets -------------------------------------------------------

    @staticmethod
    def llama_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_embd=4096, n_head=32, n_layer=32, **kw)

    @staticmethod
    def llama_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_embd=5120, n_head=40, n_layer=40, **kw)

    @staticmethod
    def llama_30b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_embd=6656, n_head=52, n_layer=60, **kw)

    @staticmethod
    def llama_65b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_embd=8192, n_head=64, n_layer=80, **kw)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_embd=4096, n_head=32, n_layer=32, n_ctx=4096, **kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        kw.setdefault("n_ctx", 4096)
        return LlamaConfig(n_embd=5120, n_head=40, n_layer=40, **kw)

    @staticmethod
    def llama2_70b(**kw) -> "LlamaConfig":
        kw.setdefault("n_ff", 28672)
        kw.setdefault("n_ctx", 4096)
        return LlamaConfig(
            n_embd=8192, n_head=64, n_layer=80, n_kv_head=8, **kw
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small config for unit tests (CPU-runnable)."""
        kw.setdefault("n_vocab", 512)
        kw.setdefault("n_embd", 256)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_ctx", 128)
        kw.setdefault("n_ff", 512)
        return LlamaConfig(**kw)

    def from_hparams(self):  # pragma: no cover - convenience alias
        return self


# Generation-time knobs. The reference hard-codes these at two call sites
# (/root/reference/th-llama.cpp:719-722, 780-783).
@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.80
    top_k: int = 40
    top_p: float = 0.95
    repeat_penalty: float = 1.10
    repeat_last_n: int = 64
    seed: int = 780658349  # reference fixed seed (/root/reference/th-llama-loader.cpp:332)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0
