"""The compile-cache helper and chip_smoke's device gate."""

import os

import jax
import pytest

from lidar_imu_slam_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: the helper sets nothing on top of it
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_refuses_cpu():
    import types

    import chip_smoke

    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu([types.SimpleNamespace(platform="cpu")])
    chip_smoke.require_gpu([types.SimpleNamespace(platform="gpu")])
    if jax.default_backend() == "cpu":
        with pytest.raises(RuntimeError, match="needs a GPU"):
            chip_smoke.require_gpu(jax.devices())


def test_f32_matmul_scan():
    """chip_smoke's HLO scan finds f32 products and ignores f64 ones."""
    import chip_smoke

    hlo = "\n".join([
        "  %a = f32[4,4]{1,0} dot(f32[4,4]{1,0} %x, f32[4,4]{1,0} %y)",
        "  %b = f64[4,4]{1,0} dot(f64[4,4]{1,0} %x, f64[4,4]{1,0} %y)",
        '  %c = (f32[8,8]{1,0}, s8[0]{0}) custom-call(%p), '
        'custom_call_target="__cublas$gemm"',
        "  %d = f32[4]{0} add(f32[4]{0} %x, f32[4]{0} %y)",
    ])
    found = chip_smoke.f32_matmuls(hlo)
    assert len(found) == 2
    assert "f64" not in found[0]


@pytest.mark.gpu
def test_kernel_phase_on_gpu():
    """chip_smoke's kernel phase (fused GN at 4096 x 80, the pose chains)
    compiled for the card. Run on the card with
    `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    import chip_smoke

    chip_smoke.phase_kernels()
