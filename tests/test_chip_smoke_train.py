"""chip_smoke.py's train_predict phase — main.train then main.predict
through a RunConfig, slab ocean on — rehearsed at a tiny size on CPU."""

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


def test_rehearse_train_predict(cpu_only, capsys):
    ctx = chip_smoke.rehearse(("train_predict",))
    out = capsys.readouterr().out
    assert "[train_predict] ok" in out and "FAILED" not in out
    assert "SST changed at the slab step: True" in out
    assert ctx["train_s"] > 0 and ctx["predict_s"] > 0
