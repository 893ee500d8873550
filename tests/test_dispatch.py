"""The kernel-choice rule (ops/dispatch.py): a function of the mode, the
platform and the kernels switched off for an A/B timing."""

import pytest

from tokenhawk_tpu.ops import dispatch


@pytest.mark.parametrize("backend, platform, mode", [
    ("auto", "gpu", "compiled"),
    ("auto", "cpu", None),
    ("xla", "gpu", None),
    ("xla", "cpu", None),
    ("interpret", "gpu", "interpret"),
    ("interpret", "cpu", "interpret"),
])
def test_kernel_mode(monkeypatch, backend, platform, mode):
    monkeypatch.setattr(dispatch, "_BACKEND", backend)
    monkeypatch.setattr(dispatch, "platform", lambda: platform)
    for kernel in dispatch.KERNELS:
        assert dispatch.kernel_mode(kernel) == mode


@pytest.mark.parametrize("off", [(), ("qgemv",), ("paged_attention",),
                                 ("qgemv", "paged_attention")])
def test_kernels_off_sends_only_the_named_kernels_to_xla(monkeypatch, off):
    monkeypatch.setattr(dispatch, "_BACKEND", "auto")
    monkeypatch.setattr(dispatch, "platform", lambda: "gpu")
    with dispatch.kernels_off(*off):
        for kernel in dispatch.KERNELS:
            want = None if kernel in off else "compiled"
            assert dispatch.kernel_mode(kernel) == want
    for kernel in dispatch.KERNELS:
        assert dispatch.kernel_mode(kernel) == "compiled"


def test_kernels_off_refuses_unknown_names_and_restores_on_error(
        monkeypatch):
    monkeypatch.setattr(dispatch, "_BACKEND", "interpret")
    with pytest.raises(ValueError):
        with dispatch.kernels_off("flash_attention"):
            pass
    with pytest.raises(RuntimeError):
        with dispatch.kernels_off("qgemv"):
            raise RuntimeError
    assert dispatch.kernel_mode("qgemv") == "interpret"


@pytest.mark.parametrize("platform, int4", [("gpu", True), ("cpu", False)])
def test_int4_codes_only_on_gpu(monkeypatch, platform, int4):
    monkeypatch.setattr(dispatch, "platform", lambda: platform)
    assert dispatch.int4_codes() is int4


@pytest.mark.parametrize("name", ["pallas", "pallas_interpret", "triton", ""])
def test_unknown_backend_is_refused(monkeypatch, name):
    monkeypatch.setattr(dispatch, "_BACKEND", "auto")
    with pytest.raises(ValueError):
        dispatch.set_backend(name)
    assert dispatch.get_backend() == "auto"


def test_this_platform_is_the_cpu():
    assert dispatch.platform() == "cpu"
