"""Kernel selection.

Which implementation an op takes is a pure function of the platform and
the shapes:

  - on a GPU, the hand-written Pallas kernels (Triton route) take every
    shape their `supported` rule accepts; any other shape takes the
    plain XLA path;
  - on any other platform the plain XLA path runs;
  - tests force "interpret" to run the kernels through the Pallas
    interpreter on the CPU, and "xla" forces the plain path everywhere
    (the reference the kernels are compared against).

TOKENHAWK_BACKEND sets the initial mode ("auto" | "xla" | "interpret").
`kernels_off(...)` sends the named kernels to the plain path for a
block of code, so a benchmark can time each kernel's share of a whole
step (`bench.py --mode step`).  The choice is made when a program is
traced: jit a function inside the block.
"""

from __future__ import annotations

import contextlib
import os

import jax

_BACKEND = os.environ.get("TOKENHAWK_BACKEND", "auto")
_VALID = ("auto", "xla", "interpret")
KERNELS = ("qgemv", "paged_attention")
_OFF: frozenset[str] = frozenset()


def set_backend(backend: str) -> None:
    global _BACKEND
    if backend not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}")
    _BACKEND = backend


def get_backend() -> str:
    return _BACKEND


def platform() -> str:
    """The platform programs are compiled for ("gpu", "cpu", ...)."""
    return jax.default_backend()


@contextlib.contextmanager
def kernels_off(*names: str):
    """Run the plain path in place of the named kernels inside the block."""
    global _OFF
    unknown = set(names) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; known {KERNELS}")
    saved = _OFF
    _OFF = saved | frozenset(names)
    try:
        yield
    finally:
        _OFF = saved


def kernel_mode(kernel: str) -> str | None:
    """How `kernel` (one of KERNELS) runs: None (plain XLA), "compiled"
    (the GPU kernel) or "interpret"."""
    if _BACKEND == "xla" or kernel in _OFF:
        return None
    if _BACKEND == "interpret":
        return "interpret"
    return "compiled" if platform() == "gpu" else None


def int4_codes() -> bool:
    """Whether k-quant loads keep 4-bit codes as int4 device arrays.

    The GEMV kernel reads int4 natively on the GPU; XLA:CPU compiles S4
    arithmetic very slowly, so elsewhere the codes widen to int8."""
    return platform() == "gpu"
