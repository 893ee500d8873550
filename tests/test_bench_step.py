"""bench.py --mode step: the decode-step A/B that decides whether each
hand-written kernel stays, run at toy widths with the kernels
interpreted."""

import jax.numpy as jnp
import pytest

import bench
from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import unstack_params
from tokenhawk_tpu.ops import dispatch


@pytest.mark.parametrize("batch", [1, 3])
def test_step_ab_times_every_kernel_variant(monkeypatch, batch):
    monkeypatch.setattr(dispatch, "_BACKEND", "interpret")
    cfg = LlamaConfig.tiny(n_layer=2)
    params = unstack_params(bench.synth_params(
        cfg, "q4_0", jnp.bfloat16, jnp.bfloat16))
    notes, records = [], []
    rc = bench.step_ab(cfg, params, batch, 256, notes.append,
                       lambda *a, **k: records.append((a, k)),
                       iters=1, trials=1)
    assert rc == 0
    assert len(notes) == 4
    (metric, value, unit, _), extra = records[0]
    assert metric == f"paged_decode_step_ms_b{batch}" and unit == "ms"
    assert value == extra["both_kernels_ms"] > 0
    for name in ("qgemv_only", "paged_attention_only", "plain_xla"):
        assert extra[f"{name}_ms"] > 0
    assert len(extra["lengths"]) == batch
    assert max(extra["lengths"]) < 256
