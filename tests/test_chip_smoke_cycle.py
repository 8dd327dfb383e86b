"""chip_smoke.py's cycle phase and its four-device sharded phase,
rehearsed at a tiny size on CPU devices (4 of the 8 virtual ones for the
sharded path)."""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


@pytest.fixture
def cpu_only():
    if jax.default_backend() != "cpu":
        pytest.skip("rehearsals here are CPU runs")
    return jax.devices()


def test_rehearse_cycle(cpu_only, capsys):
    ctx = chip_smoke.rehearse(("cycle",))
    out = capsys.readouterr().out
    assert "[cycle] ok" in out and "FAILED" not in out
    assert set(ctx["cycle_ms"]) == {"f32", "bf16"}


def test_rehearse_sharded_on_four_devices(cpu_only, capsys):
    if len(cpu_only) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    chip_smoke.rehearse(n_devices=4)
    out = capsys.readouterr().out
    assert "[sharded] ok" in out and "FAILED" not in out
    assert "every parameter and state array spans all 4 devices" in out
