import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import init_params
import pytest

from tokenhawk_tpu.utils.profiling import (
    PEAKS,
    decode_speed_of_light,
    device_peaks,
    kv_stream_bytes,
    prefill_flops,
    prefill_roofline_fraction,
    prefill_speed_of_light,
    roofline_fraction,
    weight_stream_bytes,
)

H100 = "NVIDIA H100 80GB HBM3"
from tokenhawk_tpu.utils.timing import TokenTimer, descriptive_stats

import jax


def test_weight_stream_bytes_counts_everything_but_embedding():
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    total = sum(x.nbytes for x in jax.tree_util.tree_leaves(params))
    got = weight_stream_bytes(params)
    assert got == total - params.tok_embd.nbytes


def test_speed_of_light_math():
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    sol = decode_speed_of_light(params, device_kind=H100)
    assert sol == 3350e9 / weight_stream_bytes(params)
    assert abs(roofline_fraction(sol / 2, params, device_kind=H100)
               - 0.5) < 1e-9


def test_h100_peaks_are_the_data_sheet_values():
    assert PEAKS[H100] == dict(hbm_gbps=3350.0, bf16_tflops=989.0)


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB",
                                  ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)


def test_roofline_on_the_cpu_device_raises():
    """The default device here is the CPU, which has no peak entry: a
    roofline share is never computed against a made-up default."""
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    with pytest.raises(KeyError):
        decode_speed_of_light(params)


@pytest.mark.parametrize("n_tokens", [1, 128, 512])
def test_prefill_roofline_math(n_tokens):
    cfg = LlamaConfig.llama_7b()
    sol = prefill_speed_of_light(cfg, n_tokens, device_kind=H100)
    assert sol == prefill_flops(cfg, n_tokens) / 989e12
    frac = prefill_roofline_fraction(cfg, n_tokens, 2 * sol,
                                     device_kind=H100)
    assert abs(frac - 0.5) < 1e-12


def test_kv_stream_bytes():
    cfg = LlamaConfig.tiny()
    b = kv_stream_bytes(cfg, n_past=10, batch=2, dtype_bytes=2)
    assert b == 2 * cfg.n_layer * 2 * cfg.n_kv_head * 10 * cfg.head_dim * 2


def test_descriptive_stats_fields():
    s = descriptive_stats([1.0, 2.0, 3.0, 4.0, 100.0])
    for k in ("mean_ms", "median_ms", "mode_ms", "stddev_ms",
              "p99_ms", "p95_ms", "p5_ms", "p1_ms", "count"):
        assert k in s
    assert s["count"] == 5
    assert s["median_ms"] == 3.0


def test_token_timer_collects():
    t = TokenTimer()
    for _ in range(5):
        t.tick()
    assert len(t.samples_ms) == 4
    assert t.stats()["count"] == 4
