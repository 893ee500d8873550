"""chip_smoke.py on the CPU: its serve, CLI and four-card phases at toy
widths with the kernels interpreted, and its refusal to run without a
GPU or outside a checkout."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke
from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.ops import dispatch

ROOT = Path(__file__).resolve().parents[1]

TOY = dict(n_embd=256, n_head=4, n_layer=2, n_ff=512, n_vocab=512,
           n_ctx=512, max_tokens=6, logit_prompts=(150, 40))


@pytest.fixture
def interpreted(monkeypatch):
    monkeypatch.setattr(dispatch, "_BACKEND", "interpret")


def test_serve_and_cli_phases_at_toy_widths(interpreted, tmp_path):
    info = {}
    path = chip_smoke.serve_phase(TOY, "cpu", info, model_dir=tmp_path)
    assert path.parent == tmp_path
    assert info["serve"]["tok_s"] > 0
    chip_smoke.cli_phase(path, TOY, "cpu", info)
    # a second run reuses the written model file
    assert chip_smoke.smoke_model(TOY, tmp_path) == path


def test_four_card_phase_on_four_virtual_devices(interpreted):
    cfg = LlamaConfig(n_vocab=512, n_embd=256, n_head=8, n_kv_head=4,
                      n_ff=512, n_layer=2, n_ctx=512)
    chip_smoke.four_card_phase(TOY, cfg, "cpu", jax.devices()[:4])


def test_four_card_phase_needs_four_devices(interpreted):
    cfg = LlamaConfig.tiny()
    with pytest.raises(AssertionError, match="needs 4 devices"):
        chip_smoke.four_card_phase(TOY, cfg, "cpu", jax.devices()[:2])


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_and_prints_no_result(tmp_path, alone):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
