"""Independent numpy oracle for the LLaMA forward pass.

Used only by tests (SURVEY.md §4: the reference ships no tests, so the
correctness strategy is golden comparison against a separately-written
f32/f64 implementation).  Mirrors the math of
th-llama.cpp:270-452 step by step — materialized scores,
explicit causal mask — with none of the device-side structure.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tokenhawk_tpu.config import LlamaConfig


def rms_norm_np(x, gain, eps=1e-6):
    x = x.astype(np.float64)
    ms = (x * x).mean(-1, keepdims=True)
    return (x / np.sqrt(ms + eps)) * gain.astype(np.float64)


def rope_np(x, positions, base=10000.0, style="interleaved"):
    # x: [T, H, Dh]; positions: [T]
    T, H, Dh = x.shape
    half = Dh // 2
    x = x.astype(np.float64)
    freqs = base ** (-2.0 * np.arange(half) / Dh)
    ang = positions.astype(np.float64)[:, None] * freqs  # [T, half]
    c = np.cos(ang)[:, None, :]
    s = np.sin(ang)[:, None, :]
    out = np.empty_like(x)
    if style == "interleaved":
        x0, x1 = x[..., 0::2], x[..., 1::2]
        out[..., 0::2] = x0 * c - x1 * s
        out[..., 1::2] = x0 * s + x1 * c
    else:
        x0, x1 = x[..., :half], x[..., half:]
        out[..., :half] = x0 * c - x1 * s
        out[..., half:] = x0 * s + x1 * c
    return out


def softmax_np(x, axis=-1):
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def attention_np(q, k, v, q_positions, kv_len=None):
    """Causal GQA attention of one sequence, one query head at a time.

    q [T, H, Dh] at absolute positions q_positions [T]; k, v [S, Hkv, Dh]
    for positions 0..S-1.  Query head j reads KV head j // (H // Hkv);
    a query at position p sees keys at positions <= p (and < kv_len when
    given).  Returns f64 [T, H, Dh]."""
    T, H, Dh = q.shape
    S, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    kpos = np.arange(S)
    mask = kpos[None, :] <= np.asarray(q_positions)[:, None]  # [T, S]
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    ctx = np.zeros((T, H, Dh))
    for j in range(H):
        kj = k[:, j // rep, :].astype(np.float64)
        vj = v[:, j // rep, :].astype(np.float64)
        scores = (q[:, j, :].astype(np.float64) @ kj.T) / np.sqrt(Dh)
        scores = np.where(mask, scores, -np.inf)
        ctx[:, j, :] = softmax_np(scores) @ vj
    return ctx


def forward_np(cfg: LlamaConfig, weights: Dict[str, np.ndarray], tokens: np.ndarray):
    """Full forward of one unbatched sequence.

    weights: GGML-named dict of *dense* f32 arrays in GGML [out, in]
    orientation.  tokens: [T] int.  Returns f64 logits [T, V].
    """
    T = len(tokens)
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    pos = np.arange(T)

    x = weights["tok_embeddings.weight"][tokens].astype(np.float64)  # [T, D]

    for i in range(cfg.n_layer):
        pfx = f"layers.{i}."
        h = rms_norm_np(x, weights[pfx + "attention_norm.weight"], cfg.rms_norm_eps)
        q = (h @ weights[pfx + "attention.wq.weight"].astype(np.float64).T).reshape(T, H, Dh)
        k = (h @ weights[pfx + "attention.wk.weight"].astype(np.float64).T).reshape(T, Hkv, Dh)
        v = (h @ weights[pfx + "attention.wv.weight"].astype(np.float64).T).reshape(T, Hkv, Dh)
        q = rope_np(q, pos, cfg.rope_theta, cfg.rope_style)
        k = rope_np(k, pos, cfg.rope_theta, cfg.rope_style)

        ctx = attention_np(q, k, v, pos)
        x = x + ctx.reshape(T, H * Dh) @ weights[pfx + "attention.wo.weight"].astype(np.float64).T

        h2 = rms_norm_np(x, weights[pfx + "ffn_norm.weight"], cfg.rms_norm_eps)
        g = h2 @ weights[pfx + "feed_forward.w1.weight"].astype(np.float64).T
        g = g / (1.0 + np.exp(-g))  # silu
        u = h2 @ weights[pfx + "feed_forward.w3.weight"].astype(np.float64).T
        x = x + (g * u) @ weights[pfx + "feed_forward.w2.weight"].astype(np.float64).T

    h = rms_norm_np(x, weights["norm.weight"], cfg.rms_norm_eps)
    return h @ weights["output.weight"].astype(np.float64).T  # [T, V]
