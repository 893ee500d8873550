"""Dequantizing GEMV kernel (ops/pallas/qgemv.py) and the matmul rule.

The kernel runs through the Pallas interpreter here and is compared with
QWeight.dequantize, the plain definition of every layout.  Which calls
take it is checked twice: the `supported` rule itself, and the program
the 7B shapes lower to for CUDA (a Triton custom call or none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops.linear import _matmul_quant, matmul
from tokenhawk_tpu.ops.pallas import qgemv
from tokenhawk_tpu.ops.qweight import QWeight

S = jax.ShapeDtypeStruct


def make_qweight(rng, kind, K, N):
    """Random codes and scales in the device layout of `kind`."""
    def sc(rows):
        return jnp.asarray(rng.uniform(0.5, 1.5, (rows, N)) / 8, jnp.bfloat16)

    if kind == "q4_0":
        qs = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
        return QWeight(qs=jnp.asarray(qs), scales=sc(K // 64), mins=None,
                       scales_hi=sc(K // 64), kind="q4_0")
    if kind == "q8_0":
        qs = rng.integers(-127, 128, (K, N)).astype(np.int8)
        return QWeight(qs=jnp.asarray(qs), scales=sc(K // 32) / 16, mins=None,
                       kind="q8_0")
    group = {"qk_i8_g32": 32, "qk_i8_g16": 16}[kind]
    qs = rng.integers(-8, 8, (K, N)).astype(np.int8)
    mins = jnp.asarray(rng.standard_normal((K // group, N)) / 8, jnp.bfloat16)
    return QWeight(qs=jnp.asarray(qs), scales=sc(K // group), mins=mins,
                   kind="qk_i8", group=group)


def shaped_q4(K, N):
    return QWeight(qs=S((K // 2, N), jnp.uint8), scales=S((K // 64, N), jnp.bfloat16),
                   mins=None, scales_hi=S((K // 64, N), jnp.bfloat16),
                   kind="q4_0")


def reference(x, w):
    return np.asarray(x, np.float64) @ np.asarray(w.dequantize(jnp.float32),
                                                  np.float64)


def assert_close(got, want, rel=1e-2):
    got = np.asarray(got, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


KINDS = ["q4_0", "q8_0", "qk_i8_g32", "qk_i8_g16"]


@pytest.mark.parametrize("N", [48, 320])
@pytest.mark.parametrize("rows", [1, 5, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_qgemv_matches_dequantized(rng, kind, rows, N):
    """Each layout, row count (padded to the 16-row dot inside) and
    column-slab width (48 -> 16-wide slabs, 320 -> 64-wide)."""
    K = 256
    w = make_qweight(rng, kind, K, N)
    x = jnp.asarray(rng.standard_normal((rows, K)), jnp.bfloat16)
    assert qgemv.supported(rows, w)
    assert_close(qgemv.qgemv(x, w, interpret=True), reference(x, w))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_qgemv_keeps_leading_dims_and_dtype(rng, dtype):
    w = make_qweight(rng, "q4_0", 128, 64)
    x = jnp.asarray(rng.standard_normal((2, 3, 128)), dtype)
    y = qgemv.qgemv(x, w, interpret=True)
    assert y.shape == (2, 3, 64) and y.dtype == dtype
    assert_close(y.reshape(6, 64), reference(x.reshape(6, 128), w))


@pytest.mark.parametrize("case, expect", [
    ("rows=0", False),
    ("rows=1", True),
    ("rows=16", True),
    ("rows=17", False),
    ("stacked [L, K, N] codes", False),
    ("q4_0 without high-half scales", False),
    ("N not a multiple of 16", False),
    ("group 8", False),
    ("dense-kind q4_1", False),
])
def test_supported_rule(case, expect):
    K, N, rows = 256, 64, 4
    w = QWeight(qs=S((K // 2, N), jnp.uint8), scales=S((K // 64, N), jnp.bfloat16),
                mins=None, scales_hi=S((K // 64, N), jnp.bfloat16), kind="q4_0")
    if case.startswith("rows="):
        rows = int(case[5:])
    elif case.startswith("stacked"):
        w = QWeight(qs=S((2, K // 2, N), jnp.uint8), scales=w.scales, mins=None,
                    scales_hi=w.scales_hi, kind="q4_0")
    elif case.startswith("q4_0 without"):
        w = QWeight(qs=w.qs, scales=w.scales, mins=None, kind="q4_0")
    elif case.startswith("N not"):
        w = QWeight(qs=S((K // 2, 40), jnp.uint8), scales=S((K // 64, 40), jnp.bfloat16),
                    mins=None, scales_hi=S((K // 64, 40), jnp.bfloat16),
                    kind="q4_0")
    elif case == "group 8":
        w = QWeight(qs=S((K, N), jnp.int8), scales=S((K // 8, N), jnp.bfloat16),
                    mins=None, kind="qk_i8", group=8)
    elif case.startswith("dense-kind"):
        w = QWeight(qs=S((K, N), jnp.int8), scales=S((K // 32, N), jnp.float32),
                    mins=S((K // 32, N), jnp.float32), kind="q4_1")
    assert qgemv.supported(rows, w) is expect


@pytest.mark.parametrize("n, bn", [(64, 64), (4096, 64), (48, 16), (96, 32),
                                   (40, None)])
def test_block_n(n, bn):
    assert qgemv.block_n(n) == bn


@pytest.mark.parametrize("n_blocks, n_groups", [(64, 64), (192, 64), (5, 4),
                                                (1, 3), (512, 128)])
def test_split_k_divides_groups_and_fills_the_card(n_blocks, n_groups):
    s = qgemv._splits(n_blocks, n_groups)
    assert n_groups % s == 0 and 1 <= s <= qgemv._MAX_SPLITS
    if n_blocks >= qgemv._TARGET_BLOCKS:
        assert s == 1


@pytest.mark.parametrize("backend, rows, N, takes_kernel", [
    ("interpret", 1, 64, True),
    ("interpret", 16, 64, True),
    ("interpret", 17, 64, False),
    ("interpret", 1, 40, False),  # no 16-wide column slab divides N
    ("xla", 1, 64, False),
    ("auto", 1, 64, False),  # the CPU platform never takes a GPU kernel
])
def test_matmul_kernel_choice(rng, monkeypatch, backend, rows, N,
                              takes_kernel):
    calls = []
    real = qgemv.qgemv

    def spy(x, w, interpret=False):
        calls.append(interpret)
        return real(x, w, interpret=interpret)

    monkeypatch.setattr(qgemv, "qgemv", spy)
    monkeypatch.setattr(dispatch, "_BACKEND", backend)
    w = make_qweight(rng, "q4_0", 128, N)
    x = jnp.asarray(rng.standard_normal((rows, 128)), jnp.bfloat16)
    assert_close(matmul(x, w), reference(x, w))
    assert calls == ([True] if takes_kernel else [])


@pytest.mark.parametrize("rows", [1, 40])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_dequantizing_matmul(rng, kind, rows):
    """The plain path: one dot over codes x broadcast scales."""
    w = make_qweight(rng, kind, 256, 64)
    x = jnp.asarray(rng.standard_normal((rows, 256)), jnp.float32)
    y = _matmul_quant(x, w)
    assert y.shape == (rows, 64) and y.dtype == jnp.float32
    assert_close(y, reference(x, w), rel=1e-5)


def _lowers_to_triton(fn, *args):
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    return "xla.gpu.triton" in text


@pytest.mark.parametrize("rows", [1, 8, 512])
@pytest.mark.parametrize("K, N", [(4096, 12288), (4096, 22016), (4096, 4096),
                                  (4096, 32000), (11008, 4096)])
def test_7b_projections_take_the_kernel_on_gpu(monkeypatch, K, N, rows):
    """LLaMA-7B projections lowered for CUDA: decode rows become the
    Triton GEMV, a 512-row prefill stays one XLA dot."""
    monkeypatch.setattr(dispatch, "_BACKEND", "auto")
    monkeypatch.setattr(dispatch, "platform", lambda: "gpu")
    x = S((rows, K), jnp.bfloat16)
    assert _lowers_to_triton(matmul, x, shaped_q4(K, N)) == (rows <= 16)


@pytest.mark.parametrize("kind", ["q8_0", "qk_i4"])
def test_other_kinds_take_the_kernel_on_gpu(monkeypatch, kind):
    monkeypatch.setattr(dispatch, "_BACKEND", "auto")
    monkeypatch.setattr(dispatch, "platform", lambda: "gpu")
    K = N = 4096
    code = jnp.int8 if kind == "q8_0" else jnp.int4
    mins = None if kind == "q8_0" else S((K // 32, N), jnp.bfloat16)
    w = QWeight(qs=S((K, N), code), scales=S((K // 32, N), jnp.bfloat16),
                mins=mins, kind=kind)
    assert _lowers_to_triton(matmul, S((1, K), jnp.bfloat16), w)
