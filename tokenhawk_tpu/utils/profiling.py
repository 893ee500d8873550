"""Profiling and roofline accounting.

The reference's only instrumentation is wall-clock timing
(/root/reference/th.cpp:23-28; GPU timestamp queries are disabled,
cli/main.cpp:92).  Here:

  - `trace()` wraps `jax.profiler` for real device traces (TensorBoard
    or xprof-compatible);
  - roofline accounting: bytes a decode step must move vs the device's
    published memory bandwidth (and prefill FLOPs vs its bf16 peak),
    from one table keyed by `device_kind`.
"""

from __future__ import annotations

import contextlib
import subprocess

import jax

# Published peaks per device, keyed by `jax.Device.device_kind`.
# Source: NVIDIA H100 data sheet (SXM part, dense, no sparsity), at the
# full 700 W power limit.  A card set to a lower limit cannot hold these
# rates under load, so every share is reported beside the card's limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_gbps=3350.0, bf16_tflops=989.0),
}


def device_peaks(device_kind: str | None = None) -> dict:
    """{"hbm_gbps", "bf16_tflops"} of `device_kind` (default: the first
    JAX device).  A device missing from PEAKS is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def card_description() -> str:
    """The first GPU's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"); every measured number is
    reported beside it, since a card below its full power limit runs
    slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: `with trace('/tmp/trace'): step()`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def weight_stream_bytes(params) -> int:
    """Bytes of parameters streamed from device memory per decoded token.

    Every weight is read exactly once per token except the embedding
    table (a single-row gather).
    """
    from tokenhawk_tpu.ops.qweight import QWeight

    total = 0
    for leaf in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, QWeight)
    ):
        total += leaf.nbytes
    total -= params.tok_embd.nbytes
    return total


def kv_stream_bytes(cfg, n_past: int, batch: int = 1, dtype_bytes: int = 2) -> int:
    """KV-cache bytes read per decode step at a given context depth."""
    return 2 * cfg.n_layer * batch * cfg.n_kv_head * n_past * cfg.head_dim * dtype_bytes


def decode_speed_of_light(
    params, cfg=None, n_past: int = 0, batch: int = 1,
    device_kind: str | None = None, kv_dtype_bytes: int = 2,
) -> float:
    """Roofline decode tok/s: device memory bandwidth / bytes-per-token.

    kv_dtype_bytes: 1 for int8 KV caches — using bf16 bytes for an int8
    cache overstates the roofline's denominator and once printed a
    nonsensical 102%-of-SoL line."""
    bw = device_peaks(device_kind)["hbm_gbps"] * 1e9
    bytes_per_tok = weight_stream_bytes(params)
    if cfg is not None and n_past:
        bytes_per_tok += (kv_stream_bytes(cfg, n_past, batch, kv_dtype_bytes)
                          // max(batch, 1))
    return bw / bytes_per_tok


def roofline_fraction(achieved_tok_s: float, params, **kw) -> float:
    return achieved_tok_s / decode_speed_of_light(params, **kw)


def prefill_flops(cfg, n_tokens: int, batch: int = 1) -> float:
    """Matrix FLOPs one prefill pass must spend (matmuls + attention).

    Weight matmuls: 2 * T * (all projection params).  Attention:
    causal QK^T + PV ≈ 2 * 2 * H * T^2/2 * Dh per layer (flash kernels
    skip the masked half).  The embedding gather and elementwise work
    are not matrix FLOPs."""
    d, f, v = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    dq = cfg.n_head * cfg.head_dim
    dkv = cfg.n_kv_head * cfg.head_dim
    per_tok = 2 * cfg.n_layer * (d * (dq + 2 * dkv)  # wq/wk/wv
                                 + dq * d            # wo
                                 + 3 * d * f)        # w1/w2/w3
    per_tok += 2 * d * v  # logits head (bench prefill computes last-token
    # logits only; keep it in — it is <2% at T>=128 and conservative)
    attn = 2 * cfg.n_layer * 2 * cfg.n_head * (n_tokens ** 2 / 2) * cfg.head_dim
    return batch * (per_tok * n_tokens + attn)


def prefill_speed_of_light(cfg, n_tokens: int, batch: int = 1,
                           device_kind: str | None = None) -> float:
    """Roofline prefill seconds: matrix FLOPs over the bf16 peak.

    Prefill is compute-bound beyond a few hundred tokens (one weight pass
    amortizes over T tokens); callers wanting the bytes bound of short
    prompts compare against weight_stream_bytes."""
    return prefill_flops(cfg, n_tokens, batch) / (
        device_peaks(device_kind)["bf16_tflops"] * 1e12)


def prefill_roofline_fraction(cfg, n_tokens: int, seconds: float,
                              batch: int = 1,
                              device_kind: str | None = None) -> float:
    """Fraction of the bf16 compute roofline a measured prefill achieved."""
    return prefill_speed_of_light(cfg, n_tokens, batch, device_kind) / seconds
