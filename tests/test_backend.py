"""Backend resolution, device accounting and the chip smoke entry point:
everything that decides where and how the program runs, checked on the
CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from uwspr_tpu.config import (
    PipelineConfig,
    resolve_backend,
    with_serving_defaults,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_resolver_cpu_is_host_engine():
    b = resolve_backend("cpu")
    assert (b.engine, b.serving_defaults, b.fano_impl) == (
        "host", False, "while")


def test_resolver_gpu_is_device_engine_with_serving_defaults():
    b = resolve_backend("gpu")
    assert b.engine == "device"
    assert b.serving_defaults
    assert b.fano_impl in ("cuda", "while")


@pytest.mark.parametrize("platform", ["rocm", "xpu", "METAL", ""])
def test_resolver_rejects_unknown_platform(platform):
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        resolve_backend(platform)


def test_resolver_default_is_this_process_backend():
    import jax
    assert resolve_backend() == resolve_backend(jax.default_backend())


def test_auto_engines_follow_the_resolver():
    """StreamDecoder(engine="auto") and DeviceRingDecoder's serving
    defaults come from the resolver (on the CPU: host engine, no serving
    defaults)."""
    from uwspr_tpu.pipeline.device_ring import DeviceRingDecoder
    from uwspr_tpu.pipeline.stream import StreamDecoder

    assert StreamDecoder(engine="auto").engine == resolve_backend().engine
    ring = DeviceRingDecoder(n_channels=4)
    expect = PipelineConfig()
    if resolve_backend().serving_defaults:
        expect = with_serving_defaults(expect, 4)
    assert ring._device.config == expect
    forced = DeviceRingDecoder(n_channels=4, apply_serving_defaults=True)
    assert forced._device.config == with_serving_defaults(PipelineConfig(),
                                                          4)


def test_device_decoder_fano_impl_auto_resolves():
    from uwspr_tpu.config import DemodConfig
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder

    assert DeviceDecoder().fano_impl == resolve_backend().fano_impl
    assert DeviceDecoder(PipelineConfig(
        demod=DemodConfig(fano_impl="while"))).fano_impl == "while"
    with pytest.raises(ValueError, match="fano_impl"):
        DeviceDecoder(PipelineConfig(demod=DemodConfig(fano_impl="vmem")))


@pytest.mark.parametrize("platform", ["auto", "cpu", "gpu"])
def test_cli_platform_choices(platform):
    from uwspr_tpu.cli import build_parser
    args = build_parser().parse_args(["--platform", platform, "decode",
                                      "x.c2"])
    assert args.platform == platform


def test_cli_platform_rejects_other_backends():
    from uwspr_tpu.cli import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--platform", "rocm", "decode", "x.c2"])


def test_roofline_peaks_h100():
    from uwspr_tpu.utils.roofline import analyze, peaks_for
    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert (p.bf16_flops, p.tf32_flops, p.f32_flops, p.hbm_bytes) == (
        989e12, 495e12, 67e12, 3.35e12)
    assert "data sheet" in p.source
    # 1 ms moving 3.35 GB is the HBM roofline; 1 GFLOP in it is ~0.1%
    r = analyze(1e9, 3.35e9, 1e-3, p)
    assert r.bound == "HBM" and r.hbm_util == pytest.approx(1.0)
    assert analyze(1.0, 1.0, 1.0, p).bound == "dispatch/latency"
    assert analyze(989e12, 1.0, 1.0, p).bound == "tensor"


@pytest.mark.parametrize("kind", ["Intel Max 1550", "cpu", "NVIDIA A100"])
def test_roofline_unknown_device_kind_raises(kind):
    from uwspr_tpu.utils.roofline import peaks_for
    with pytest.raises(ValueError, match="no roofline peaks"):
        peaks_for(kind)


@pytest.fixture
def restore_cache_dir():
    import jax
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    import jax

    from uwspr_tpu.utils.cache import enable_compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def test_compile_cache_default_is_repo_dir(monkeypatch, restore_cache_dir):
    from uwspr_tpu.utils.cache import DEFAULT_CACHE_DIR, enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert DEFAULT_CACHE_DIR == str(REPO / ".jax_cache")
    assert enable_compile_cache() == DEFAULT_CACHE_DIR


def test_require_gpu_fails_without_gpu():
    import jax

    from uwspr_tpu.utils.device import require_gpu
    if jax.default_backend() == "gpu":
        pytest.skip("this process has a GPU")
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
