"""The full atmospheric GCM: dynamics + physics + coupled surface.

Equivalent of the reference's agcm_main/agcm_1day/stloop assembly
(at_gcm.f90, dyn_stloop.f90) in functional form:

- `GCM` holds all static tables (dycore, physics, boundary data, slab
  coefficients) and exposes pure step functions;
- one *window* = `steps_per_window` leapfrog steps under a single
  `lax.scan` (the reference's 6-h hybrid window = 24 x 900 s);
- the daily host-level loop updates date-dependent forcing (fordate) and
  exchanges with the slab land/sea models (agcm_to_coupler).

The per-step shortwave-radiation cadence (every `nstrad` steps) is a
`lax.cond` on the running step counter inside the scan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.core.constants import PhysicalConstants
from speedy_ml_tpu.core.geometry import Geometry
from speedy_ml_tpu.data.calendar import ModelDate
from speedy_ml_tpu.dycore.model import DycoreModel, GridTendencies
from speedy_ml_tpu.dycore.state import SpectralState
from speedy_ml_tpu.physics.boundaries import (BoundaryData,
                                              resolve_boundary_data)
from speedy_ml_tpu.physics.driver import (DailyForcing, FluxDiag,
                                          PhysicsModel, RadiationCarry)
from speedy_ml_tpu.physics.land_sea import (CplFlags, SlabCoeffs,
                                            SurfaceState, build_slab_coeffs,
                                            couple_daily, init_surface_state,
                                            sea_domain_mask, sstan_for_window)
from speedy_ml_tpu.runtime.jax_setup import on_host

NSTRAD = 3   # shortwave radiation period in steps (mod_tsteps.f90:65)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FluxAccumulator:
    """Daily-mean flux accumulation (ppo_dmflux.f90 essentials).

    In the reference these survive 6-h hybrid restarts through the
    fluxes.grd file; here they are part of the functional model state.
    """
    hflux_l: jnp.ndarray
    hflux_s: jnp.ndarray
    hflux_i: jnp.ndarray
    precip: jnp.ndarray    # accumulated total precip [g/m^2 over the window]

    @staticmethod
    def zeros(nlat, nlon, dtype):
        z = lambda: jnp.zeros((nlat, nlon), dtype=dtype)
        return FluxAccumulator(hflux_l=z(), hflux_s=z(), hflux_i=z(), precip=z())


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GCMState:
    """Everything the jitted window advance threads through."""
    spectral: SpectralState
    sfc: SurfaceState
    radiation: RadiationCarry
    fluxes: FluxAccumulator
    istep: jnp.ndarray     # global step counter (for the nstrad cadence)
    # SPPT stochastic-physics state (None when sppt is off, the default —
    # sppt_on=.false., mod_tsteps.f90:68)
    sppt_spec: Optional[jnp.ndarray] = None   # (K, mx, nx) complex AR(1)
    sppt_key: Optional[jnp.ndarray] = None    # jax.random key


class GCM:
    def __init__(self, geom: Geometry = Geometry(),
                 constants: PhysicalConstants = PhysicalConstants(),
                 dtype=jnp.float32, bc_path: Optional[str] = None,
                 nsteps_day: int = 96, bd: Optional[BoundaryData] = None,
                 sppt_on: bool = False, zonal: str = "dft",
                 scan_unroll: int = 1, cgrate_on: bool = False,
                 cpl_flags: Optional[CplFlags] = None,
                 sstan_monthly: Optional[np.ndarray] = None,
                 sstan_year0: int = 1990,
                 sstom12: Optional[np.ndarray] = None):
        # cpl_flags: coupling modes (mod_cpl_flags.f90); sstan_monthly:
        # observed monthly SST anomalies (M, nlat, nlon) starting Jan of
        # sstan_year0 (the fort.30 anomaly file, obs_ssta); sstom12:
        # ocean-model SST climatology for icsea>=3 (sstom12)
        # scan_unroll: leapfrog steps unrolled per scan iteration
        # (numerically identical, compile time grows with the factor);
        # default 1 for the fastest compile
        self.scan_unroll = max(1, int(scan_unroll))
        self.geom = geom
        self.const = constants
        self.dtype = jnp.dtype(dtype)
        self.dyn = DycoreModel(geom, constants, dtype=dtype,
                               nsteps_day=nsteps_day, zonal=zonal,
                               cgrate_on=cgrate_on)
        self.sht = self.dyn.sht
        self.phys = PhysicsModel(geom, constants, dtype=dtype)
        if sppt_on:
            from speedy_ml_tpu.physics.sppt import SPPT
            self.sppt = SPPT(self.sht, geom.nlev, nsteps_day)
        else:
            self.sppt = None
        # bc_source: where the boundary data came from (a directory, or
        # the synthetic aquaplanet; see resolve_boundary_data)
        if bd is None:
            bd, self.bc_source = resolve_boundary_data(
                geom, self.sht, constants.grav, bc_path)
        else:
            self.bc_source = bc_path or "caller-supplied"
        self.bd = bd
        lat_deg = np.rad2deg(geom.lat_radians)
        self.cpl = cpl_flags if cpl_flags is not None else CplFlags()
        self.slab = build_slab_coeffs(self.bd, lat_deg, self.dtype,
                                      sea_domains=self.cpl.sea_domains)
        # elnino blend weights (wsst_ob, cpl_sea.f90:33-35)
        self.wsst_ob = (np.asarray(sea_domain_mask("elnino", lat_deg,
                                                   geom.nlon),
                                   dtype=self.dtype)
                        if self.cpl.icsea >= 4 else None)
        self.sstan_monthly = (None if sstan_monthly is None
                              else np.asarray(sstan_monthly))
        self.sstan_year0 = sstan_year0
        self.sstom12 = None if sstom12 is None else jnp.asarray(sstom12)
        self.nsteps_day = nsteps_day
        # spectral orography is a static table: built on the host device
        # and held as numpy, so it embeds as a constant wherever it runs
        with on_host():
            self.phis = np.asarray(self.sht.trunct(
                self.sht.grid_to_spec(jnp.asarray(self.bd.orog))))
        # host-API entry points as compiled programs: one dispatch each
        # instead of dozens of eager ops (bd/sht/slab close over as
        # constants)
        self._forcing_jit = jax.jit(
            lambda sfc, tyear: self.phys.daily_forcing(self.bd, sfc,
                                                       tyear, self.sht))
        self._sfc_jit = jax.jit(
            lambda imon, fmon, sst_hybrid, sst_bias: init_surface_state(
                self.bd, imon, fmon, sst_hybrid, sst_bias, flags=self.cpl))
        self._couple_jit = jax.jit(
            lambda sfc, fluxes, imon, fmon, sstan_ob: couple_daily(
                sfc, self.slab, self.bd, fluxes, imon, fmon,
                flags=self.cpl, sstan_ob=sstan_ob, wsst_ob=self.wsst_ob,
                sstom12=self.sstom12))
        self._sstan_jit = jax.jit(
            lambda win, fmon: sstan_for_window(win, fmon))

    def sstan_for(self, date: ModelDate) -> Optional[jnp.ndarray]:
        """Observed SST anomaly at `date` (obs_ssta + the 3-month forint,
        cpl_sea.f90:85-88 + 246-279), or None when no anomaly data /
        isstan off.  Out-of-range months clamp to the series edges (the
        reference keeps the anomaly constant at end-of-file)."""
        if self.sstan_monthly is None or (self.cpl.isstan <= 0
                                          and self.cpl.icsea < 4):
            return None
        M = self.sstan_monthly.shape[0]
        i = (date.year - self.sstan_year0) * 12 + (date.month - 1)
        idx = np.clip([i - 1, i, i + 1], 0, M - 1)
        win = jnp.asarray(self.sstan_monthly[idx], dtype=self.dtype)
        return self._sstan_jit(win, jnp.asarray(date.tmonth,
                                                dtype=self.dtype))

    def forcing_for(self, sfc, tyear) -> "DailyForcing":
        """Date-dependent forcing (fordate), jit-compiled."""
        return self._forcing_jit(sfc, jnp.asarray(tyear, dtype=self.dtype))

    def set_mesh(self, mesh, axis: str = "regions"):
        """Distribute the GCM over `mesh`:

        - grid-space physics: latitude sharding pinned at physics entry
          (with_sharding_constraint) — the FLOP-heavy columns distribute
          instead of replicating per device;
        - spectral dynamics: tensor parallelism over zonal wavenumber m
          (SpectralTransform.set_mesh) — the Legendre einsum batch axis
          partitions, closing SURVEY 2.3's TP row (needs zonal='dft')."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        lat2 = NamedSharding(mesh, P(axis, None))
        lat3 = NamedSharding(mesh, P(None, axis, None))

        def constrain(a):
            s = lat2 if a.ndim == 2 else lat3
            return jax.lax.with_sharding_constraint(a, s)

        self.phys.constrain = constrain
        if self.sht.zonal == "dft":
            self.sht.set_mesh(mesh, axis)

    # ------------------------------------------------------------------

    def init_state(self, date: ModelDate,
                   spectral: Optional[SpectralState] = None,
                   sst_hybrid: Optional[jnp.ndarray] = None,
                   sst_bias: float = 0.0,
                   sppt_seed: int = 0) -> tuple[GCMState, DailyForcing]:
        """agcm_init equivalent: surface + radiation init for `date`."""
        g = self.geom
        imon = jnp.asarray(date.month - 1)
        fmon = jnp.asarray(date.tmonth, dtype=self.dtype)
        sfc = self._sfc_jit(imon, fmon, sst_hybrid,
                            jnp.asarray(sst_bias, dtype=self.dtype))
        if spectral is None:
            from speedy_ml_tpu.dycore.init import rest_state
            spectral = jax.jit(
                lambda: rest_state(self.dyn, self.bd.orog)[0])()
        sppt_spec = sppt_key = None
        if self.sppt is not None:
            sppt_key, sub = jax.random.split(jax.random.PRNGKey(sppt_seed))
            sppt_spec = self.sppt.init_state(sub)
        state = GCMState(
            spectral=spectral, sfc=sfc,
            radiation=RadiationCarry.zeros(g.nlev, g.nlat, g.nlon, self.dtype),
            fluxes=FluxAccumulator.zeros(g.nlat, g.nlon, self.dtype),
            istep=jnp.asarray(0, dtype=jnp.int32),
            sppt_spec=sppt_spec, sppt_key=sppt_key)
        forcing = self.forcing_for(sfc, date.tyear)
        return state, forcing

    # ------------------------------------------------------------------

    def _physics_fn(self, state: SpectralState, j: int, dyn: DycoreModel,
                    sfc, forcing, carry, lradsw, sppt_pattern=None):
        """Adapter: spectral state -> grid fields -> PhysicsModel.compute.

        One fused inverse transform over all needed fields."""
        sht = self.sht
        g = self.geom
        K = g.nlev
        vor_s, div_s, t_s, ps_s, tr_s = state.at_level(j)
        ucosm, vcosm = sht.uvspec(vor_s, div_s)
        phi_s = dyn.geopotential(t_s, self.phis)
        stacked = jnp.concatenate(
            [t_s, tr_s[0], phi_s, ucosm, vcosm, ps_s[None]], axis=0)
        gall = sht.spec_to_grid(stacked)
        cosf = sht.cosgr[:, None]
        tg = gall[0:K]
        qg = gall[K:2 * K]
        phig = gall[2 * K:3 * K]
        ug = gall[3 * K:4 * K] * cosf
        vg = gall[4 * K:5 * K] * cosf
        pslg = gall[5 * K]

        ut, vt, tt, qt, carry2, diag = self.phys.compute(
            ug, vg, tg, qg, phig, pslg, bd=self.bd, sfc=sfc,
            forcing=forcing, carry=carry, lradsw=lradsw,
            sppt_pattern=sppt_pattern)
        return GridTendencies(u=ut, v=vt, t=tt, tr=qt[None]), (carry2, diag)

    # ------------------------------------------------------------------

    def leapfrog(self, gstate: GCMState, forcing: DailyForcing) -> GCMState:
        """One filtered leapfrog step with physics (stloop body)."""
        lradsw = (gstate.istep % NSTRAD) == 0   # istep 0-based: mod(istep,3)==1 1-based
        # SPPT runs only when the state carries AR(1) state: windows built
        # without it (e.g. the hybrid's cold-start SPEEDY window) integrate
        # deterministically even on an sppt_on GCM
        sppt_spec, sppt_key, pattern = gstate.sppt_spec, gstate.sppt_key, None
        if self.sppt is not None and gstate.sppt_key is not None:
            sppt_key, sub = jax.random.split(gstate.sppt_key)
            sppt_spec = self.sppt.step(gstate.sppt_spec, sub)
            pattern = (self.sppt.grid_pattern(sppt_spec)
                       * jnp.asarray(self.sppt.mu)[:, None, None])
        spec, aux = self.dyn.leapfrog_step(
            gstate.spectral, self.phis,
            physics_fn=self._physics_fn,
            physics_args=(gstate.sfc, forcing, gstate.radiation, lradsw,
                          pattern),
            corrections=(forcing.tcorh, forcing.qcorh))
        carry, diag = aux
        rsteps = 1.0 / self.nsteps_day
        fx = gstate.fluxes
        fluxes = FluxAccumulator(
            hflux_l=fx.hflux_l + diag.hflux_l * rsteps,
            hflux_s=fx.hflux_s + diag.hflux_s * rsteps,
            hflux_i=fx.hflux_i + diag.hflux_i * rsteps,
            precip=fx.precip + ((diag.precnv + diag.precls)
                                * self.dyn.delt2 / 2.0
                                ).astype(fx.precip.dtype))
        return GCMState(spectral=spec, sfc=gstate.sfc, radiation=carry,
                        fluxes=fluxes, istep=gstate.istep + 1,
                        sppt_spec=sppt_spec, sppt_key=sppt_key)

    @functools.partial(jax.jit, static_argnums=0)
    def stepone(self, gstate: GCMState, forcing: DailyForcing) -> GCMState:
        """Cold-start double half-step with physics (ini_stepone.f90)."""
        lradsw = jnp.asarray(True)
        spec, aux = self.dyn.stepone(
            gstate.spectral, self.phis,
            physics_fn=self._physics_fn,
            physics_args=(gstate.sfc, forcing, gstate.radiation, lradsw,
                          None),
            corrections=(forcing.tcorh, forcing.qcorh))
        carry, _ = aux
        return GCMState(spectral=spec, sfc=gstate.sfc, radiation=carry,
                        fluxes=gstate.fluxes, istep=gstate.istep,
                        sppt_spec=gstate.sppt_spec, sppt_key=gstate.sppt_key)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def run_window(self, gstate: GCMState, forcing: DailyForcing,
                   nsteps: int) -> GCMState:
        """`nsteps` leapfrog steps under one scan (a 6-h window = 24 steps)."""
        def body(s, _):
            return self.leapfrog(s, forcing), None
        u = self.scan_unroll if nsteps % self.scan_unroll == 0 else 1
        return jax.lax.scan(body, gstate, None, length=nsteps, unroll=u)[0]

    # ------------------------------------------------------------------

    def run_days(self, gstate: GCMState, date: ModelDate, ndays: int,
                 stepone_first: bool = False) -> tuple[GCMState, ModelDate]:
        """agcm_main day loop: fordate + window + slab-coupler exchange."""
        for _ in range(ndays):
            forcing = self.forcing_for(gstate.sfc, date.tyear)
            gstate = dataclasses.replace(
                gstate, fluxes=FluxAccumulator.zeros(
                    self.geom.nlat, self.geom.nlon, self.dtype))
            if stepone_first:
                gstate = self.stepone(gstate, forcing)
                stepone_first = False
            gstate = self.run_window(gstate, forcing, self.nsteps_day)
            date = date.advance_day()
            # coupler exchange at day end (agcm_to_coupler/coupler_to_agcm)
            sfc = self._couple_jit(
                gstate.sfc,
                dict(hflux_l=gstate.fluxes.hflux_l,
                     hflux_s=gstate.fluxes.hflux_s,
                     hflux_i=gstate.fluxes.hflux_i),
                jnp.asarray(date.month - 1),
                jnp.asarray(date.tmonth, dtype=self.dtype),
                self.sstan_for(date))
            gstate = dataclasses.replace(gstate, sfc=sfc)
        return gstate, date
