"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
phase functions run end to end at a tiny size (T10 geometry, small m)
through `rehearse`, which never prints the ok line.

Whether a card is present is decided inside the `cpu_only` fixture, never
at import time."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture
def cpu_only():
    if jax.default_backend() != "cpu":
        pytest.skip("rehearsals here are CPU runs")
    return jax.devices()


def _run_script(cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_exits_nonzero_without_gpu(cpu_only):
    p = _run_script(REPO)
    assert p.returncode != 0
    assert not _has_ok_line(p.stdout)
    assert "no GPU" in p.stderr


def test_exits_nonzero_alone_in_a_directory(cpu_only, tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run_script(tmp_path)
    assert p.returncode != 0
    assert not _has_ok_line(p.stdout)


def test_main_refuses_cpu_backend(cpu_only, capsys):
    assert chip_smoke.main([]) == 1
    assert not _has_ok_line(capsys.readouterr().out)


def test_production_size_is_the_reference_layout():
    s = chip_smoke.PRODUCTION
    assert (s.nlon, s.nlat, s.nlev, s.trunc) == (96, 48, 8, 30)
    assert (s.n_regions, s.m, s.ocean_m, s.slab_hours) == (1152, 6000,
                                                            4000, 168)
    # the slab ocean needs 4 slab steps of training (2 discarded, 1 pair
    # in the one-batch accumulation) and >= 32 predicted cycles
    assert s.training_hours == 4 * s.slab_hours
    assert s.prediction_hours // 6 >= 32
    assert s.prediction_hours > s.slab_hours


@pytest.mark.parametrize("phase", ["device", "gcm", "solve", "spmv"])
def test_rehearse_phase(cpu_only, capsys, phase):
    chip_smoke.rehearse((phase,))
    out = capsys.readouterr().out
    assert f"[{phase}] ok" in out
    assert "FAILED" not in out
    assert not _has_ok_line(out)


def test_rehearse_failure_raises(cpu_only, monkeypatch):
    def boom(size, ctx):
        raise chip_smoke.PhaseFailed("injected")
    monkeypatch.setitem(chip_smoke.PHASES, "solve", boom)
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.rehearse(("solve",))


def test_check_reports_and_raises(capsys):
    chip_smoke.check("x", 1e-6, 1e-5)
    assert "(tolerance 1.0e-05) ok" in capsys.readouterr().out
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.check("x", 1e-4, 1e-5)
