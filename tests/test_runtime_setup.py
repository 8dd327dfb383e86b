"""The compile-cache helper and the single boundary-data resolver."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speedy_ml_tpu.core import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.runtime import jax_setup

REPO = Path(__file__).resolve().parents[1]


def test_cache_dir_uses_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_setup.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_setup.compile_cache_dir() == str(REPO / ".jax_cache")
    assert (REPO / ".jax_cache") == jax_setup.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("from_env", [True, False])
def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path,
                                              from_env):
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        assert jax_setup.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


def test_host_device_is_cpu():
    dev = jax_setup.host_device()
    assert dev is not None and dev.platform == "cpu"


def test_no_cache_set_outside_helper():
    """Only the helper names a compile-cache directory."""
    hits = []
    for p in list(REPO.glob("*.py")) + list(REPO.glob("scripts/*.py")) + \
            list(REPO.glob("speedy_ml_tpu/**/*.py")):
        if p.name == "jax_setup.py":
            continue
        text = p.read_text()
        if "jax_compilation_cache_dir" in text or "cache/jax" in text:
            hits.append(str(p))
    assert not hits, hits


@pytest.mark.parametrize("entry", [
    "speedy_ml_tpu/main.py", "bench.py", "__graft_entry__.py",
    "chip_smoke.py", "scripts/climate_run.py",
    "scripts/skill_experiment_production.py",
    "scripts/bf16_readout_validation.py", "scripts/f32_solve_quant.py",
    "scripts/bench_training.py"])
def test_entry_point_uses_the_cache_helper(entry):
    assert "enable_compile_cache()" in (REPO / entry).read_text()


def test_main_cli_enables_compile_cache(monkeypatch):
    from speedy_ml_tpu import main as entry
    from speedy_ml_tpu.config import RunConfig
    calls = []
    monkeypatch.setattr(jax_setup, "enable_compile_cache",
                        lambda: calls.append("cache"))
    monkeypatch.setattr(RunConfig, "load", staticmethod(lambda p: p))
    monkeypatch.setattr(entry, "plot", lambda cfg: calls.append(cfg))
    assert entry.main(["plot", "cfg.json"]) == 0
    assert calls == ["cache", "cfg.json"]


# ---------------------------------------------------------------------
# boundary data: one resolver for GCM, RunConfig, bench and chip_smoke
# ---------------------------------------------------------------------

T10 = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)


def _sht(geom):
    return SpectralTransform(geom, dtype=jnp.float32)


def test_resolver_falls_back_to_aquaplanet_and_says_so(monkeypatch):
    from speedy_ml_tpu.physics.boundaries import (SYNTHETIC,
                                                  resolve_boundary_data)
    monkeypatch.delenv("SPEEDY_ML_BC_PATH", raising=False)
    geom = Geometry()
    with pytest.warns(UserWarning, match="synthetic aquaplanet"):
        bd, src = resolve_boundary_data(geom, _sht(geom))
    assert src == SYNTHETIC
    assert float(abs(bd.fmask).max()) == 0.0      # no land


def test_resolver_explicit_missing_path_raises(tmp_path):
    from speedy_ml_tpu.physics.boundaries import resolve_boundary_data
    geom = Geometry()
    with pytest.raises((FileNotFoundError, OSError)):
        resolve_boundary_data(geom, _sht(geom), path=str(tmp_path / "nope"))


def test_resolver_env_path_is_configuration_at_96x48(monkeypatch, tmp_path):
    from speedy_ml_tpu.physics.boundaries import resolve_boundary_data
    monkeypatch.setenv("SPEEDY_ML_BC_PATH", str(tmp_path / "missing"))
    geom = Geometry()
    with pytest.raises((FileNotFoundError, OSError)):
        resolve_boundary_data(geom, _sht(geom))


def test_resolver_env_path_ignored_off_grid(monkeypatch, tmp_path):
    from speedy_ml_tpu.physics.boundaries import (SYNTHETIC,
                                                  resolve_boundary_data)
    monkeypatch.setenv("SPEEDY_ML_BC_PATH", str(tmp_path / "missing"))
    with pytest.warns(UserWarning):
        _, src = resolve_boundary_data(T10, _sht(T10))
    assert src == SYNTHETIC


def test_gcm_and_runconfig_use_the_resolver(monkeypatch, tmp_path):
    from speedy_ml_tpu.config import RunConfig
    from speedy_ml_tpu.gcm import GCM
    from speedy_ml_tpu.physics.boundaries import SYNTHETIC
    monkeypatch.delenv("SPEEDY_ML_BC_PATH", raising=False)
    with pytest.warns(UserWarning):
        assert GCM(T10).bc_source == SYNTHETIC
    cfg = RunConfig(trunc=10, nlon=32, nlat=16, n_regions=32)
    with pytest.warns(UserWarning):
        assert cfg.build_gcm().bc_source == SYNTHETIC
    bad = RunConfig(trunc=10, nlon=32, nlat=16, n_regions=32,
                    bc_path=str(tmp_path / "typo"))
    with pytest.raises((FileNotFoundError, OSError)):
        bad.build_gcm()


def test_without_cpu_platform_model_builds_on_default_device(monkeypatch):
    """With no CPU platform loaded (e.g. JAX_PLATFORMS=cuda) the host-side
    tables fall back to the default device instead of failing."""
    import contextlib

    from speedy_ml_tpu.gcm import GCM
    from speedy_ml_tpu.physics.boundaries import synthetic_boundary_data
    monkeypatch.setattr(jax_setup, "host_device", lambda: None)
    assert isinstance(jax_setup.on_host(), contextlib.nullcontext)
    gcm = GCM(T10, bd=synthetic_boundary_data(T10, _sht(T10)))
    assert np.isfinite(np.asarray(gcm.phis)).all()
