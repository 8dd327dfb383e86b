"""Long-integration stability + the physics time-level contract.

Round-3 bug: the main-loop leapfrog evaluated physics at the NEW time
level (j1-1) instead of the Robert-filtered center the reference
hardwires (grtend(..., J1=1, j2) for every step, dyn_step.f90:45).
Dissipative physics at the unfiltered level couples to the leapfrog
computational mode: a 2*dt vertical zig-zag grows at convective columns
and T30 runs with real boundary data blew up after ~20-110 simulated
days (at every precision).  These tests pin the contract and the
long-run behavior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speedy_ml_tpu.core import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.data.calendar import ModelDate
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.physics.boundaries import (load_boundary_data,
                                              synthetic_boundary_data)


def test_physics_evaluates_at_filtered_level():
    """The dycore must hand the physics time level 1 (index 0) on EVERY
    step variant — stepone halves and the filtered main-loop step."""
    geom = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)
    sht = SpectralTransform(geom, dtype=jnp.float64)
    bd = synthetic_boundary_data(geom, sht)
    gcm = GCM(geom, dtype=jnp.float64, bd=bd)
    state, forcing = gcm.init_state(ModelDate(1990, 4, 1))

    seen = []
    real_fn = gcm._physics_fn

    def spy(st, j, dyn, *args):
        seen.append(j)
        return real_fn(st, j, dyn, *args)

    spec = state.spectral
    gcm.dyn.stepone(spec, jnp.asarray(gcm.phis), physics_fn=spy,
                    physics_args=(state.sfc, forcing, state.radiation,
                                  jnp.asarray(True), None),
                    corrections=(forcing.tcorh, forcing.qcorh))
    gcm.dyn.leapfrog_step(spec, jnp.asarray(gcm.phis), physics_fn=spy,
                          physics_args=(state.sfc, forcing, state.radiation,
                                        jnp.asarray(True), None),
                          corrections=(forcing.tcorh, forcing.qcorh))
    assert seen == [0, 0, 0], seen


@pytest.mark.slow
def test_t30_long_integration_stays_physical():
    """90 simulated days at T30 with the real boundary climatology —
    crosses the 20-60-day horizon where the unfiltered-physics bug blew
    up every run (f32 reduced-precision matmuls around day 20-35, f64 CPU
    around day 58)."""
    geom = Geometry()
    sht = SpectralTransform(geom, dtype=jnp.float32)
    try:
        bd = load_boundary_data(geom, sht, path="/root/reference/bin")
    except (FileNotFoundError, OSError):
        bd = synthetic_boundary_data(geom, sht)
    gcm = GCM(geom, dtype=jnp.float32, bd=bd)
    state, forcing = gcm.init_state(ModelDate(1990, 1, 1))
    state = gcm.stepone(state, forcing)
    date = ModelDate(1990, 1, 1)

    @jax.jit
    def probe(sp):
        t = gcm.sht.spec_to_grid(sp.t[0])
        u, v = gcm.sht.uv_grid(sp.vor[0], sp.div[0])
        q = gcm.sht.spec_to_grid(sp.tr[0, 0])
        return t, u, q

    for w in range(360):                      # 90 days of 6-h windows
        forcing = gcm.forcing_for(state.sfc, date.tyear)
        state = gcm.run_window(state, forcing, 24)
        date = date.advance_hours(6)
        if w % 40 == 39:
            t, u, q = (np.asarray(a) for a in probe(state.spectral))
            assert np.isfinite(t).all(), f"non-finite T at window {w}"
            assert 150.0 < t.min() and t.max() < 340.0, (
                w, t.min(), t.max())
            assert np.abs(u).max() < 150.0, (w, np.abs(u).max())
            # bounded spectral-overshoot negatives only
            assert q.min() > -15.0 and q.max() < 40.0, (w, q.min(), q.max())


def test_scan_unroll_is_bitwise_identical():
    """run_window(scan_unroll=k) is the same program unrolled: results
    must be bitwise equal to the unroll=1 window (the knob exists to cut
    per-iteration loop overhead, not to change math).  Also
    pins the fallback: nsteps not divisible by the factor uses unroll=1."""
    geom = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)
    sht = SpectralTransform(geom, dtype=jnp.float32)
    bd = synthetic_boundary_data(geom, sht)
    date = ModelDate(1990, 7, 1)
    outs = []
    for unroll in (1, 4):
        gcm = GCM(geom, dtype=jnp.float32, bd=bd, scan_unroll=unroll)
        state, forcing = gcm.init_state(date)
        state = gcm.stepone(state, forcing)
        state = gcm.run_window(state, forcing, 8)
        outs.append(np.asarray(gcm.sht.spec_to_grid(state.spectral.t[0])))
        # non-divisible trip count must not error (falls back to 1)
        gcm.run_window(state, forcing, 3)
    np.testing.assert_array_equal(outs[0], outs[1])
