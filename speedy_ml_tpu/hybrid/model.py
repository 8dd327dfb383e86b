"""The hybrid atmosphere: per-region ESNs coupled to the spectral GCM.

Reference: the per-timestep cycle of parallelmain.f90:206-272 +
mpires.f90 sendrecievegrid/run_model (218-780, 1516-1628) + the
iogrid(30)/(31) bridge (ppo_iogrid.f90:497-601).

Re-design: there is no rank-0 hub.  The "global grid" is a sharded
device array; reservoir outputs scatter into it, SPEEDY-as-a-jitted-
function advances it 6 h, and the feedback/local-model vectors gather
straight back out.  One `cycle()` is a single jitted program.

Key behavioral parities kept from the reference:
- q >= 1e-6 clamp and precip floor on the assembled grid (mpires.f90:444-478);
- the grid->spectral->grid double transform when injecting into SPEEDY,
  including its smoothing ("major bug" at ppo_iogrid.f90:541-554, which
  trained weights adapted to);
- the physical-range safety gate (u,v,T,q bounds) evaluated on the
  POST-transform fields (ppo_iogrid.f90:563-577);
- SPEEDY cold-starts every cycle through stepone (ini_stepone.f90), with
  land/sea surfaces re-initialized from climatology + hybrid SST
  (cpl_sea.f90:38-46).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.dycore.init import rest_state
from speedy_ml_tpu.dycore.state import SpectralState
from speedy_ml_tpu.esn.domain import RegionClass, RegionLayout, build_layout
from speedy_ml_tpu.esn.reservoir import (BatchedReservoir, ESNHyper, esn_step,
                                         readout)
from speedy_ml_tpu.esn.standardize import Standardizer
from speedy_ml_tpu.gcm import GCM, GCMState, FluxAccumulator
from speedy_ml_tpu.physics.driver import RadiationCarry
from speedy_ml_tpu.physics.land_sea import init_surface_state
from speedy_ml_tpu.physics.radiation import solar_flux_traced
from speedy_ml_tpu.physics.constants import SOLC


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClassState:
    """Dynamic per-class ESN state."""
    x: jnp.ndarray            # (Rc, n) reservoir state
    feedback: jnp.ndarray     # (Rc, I) standardized input for the next step
    local_model: jnp.ndarray  # (Rc, S) standardized SPEEDY forecast


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OceanClassState:
    """Slab-ocean reservoir state for one region class."""
    x: jnp.ndarray        # (Rc, n_o)
    buffer: jnp.ndarray   # (W, Rc, I_o) rolling atmo-input buffer (W=27)
    # standardized SST local-model for the hybrid slab readout: the
    # previous slab step's own outvec (predict_slab persists its output
    # as the next step's imperfect model,
    # mod_slab_ocean_reservoir.f90:1236-1238); None for ml-only slabs
    lm: object = None     # (Rc, O_o) or None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HybridState:
    classes: tuple            # tuple[ClassState, ...]
    sst_grid: jnp.ndarray     # (lat, lon) current SST seen by SPEEDY + ESNs
    safe: jnp.ndarray         # bool: SPEEDY safety gate
    step: jnp.ndarray         # int32 cycle counter
    ocean: tuple = ()         # tuple[OceanClassState, ...] (empty: climo SST)
    # persistent coupled-surface memory (persist_surface=True): the slab
    # land/ice anomaly models survive the 6-h SPEEDY restarts, as the
    # reference's fluxes.grd/restart files do (mod_cpl_land_model.f90:
    # 85-126); fluxes accumulates toward the daily coupler exchange
    sfc: object = None        # SurfaceState or None
    fluxes: object = None     # FluxAccumulator or None


class OceanPack(NamedTuple):
    """Slab-ocean reservoirs for one region class.

    idx_map: static indices into the class's atmo input vector
    (atmo_training_data_idx equivalent); mean_sst/std_sst: the atmo
    standardizer's SST scalars (outputs unstandardize with them)."""
    cls: RegionClass
    res: BatchedReservoir
    hyper: ESNHyper
    idx_map: np.ndarray
    mean_sst: jnp.ndarray    # (Rc, 1)
    std_sst: jnp.ndarray
    # hybrid slab readout (predict_slab vs predict_slab_ml,
    # mod_slab_ocean_reservoir.f90:1201-1296): the readout sees
    # [previous SST outvec ; x~] instead of x~ alone
    hybrid_readout: bool = False


class ClassPack(NamedTuple):
    """Per-class bundle: reservoir weights + geometry + scaling.

    `cls` and `hyper` are static; `res` and `std` are the dynamic model
    parameters.  Jitted entry points take the dynamic parts explicitly
    (see HybridAtmosphere.params) so multi-GB weights are real arguments
    of the XLA program, not captured constants.

    zspec: vertical-localization group (esn.domain.VertSpec) — None means
    the single full-column group.  With num_vert_levels > 1 each
    (horizontal class, vertical group) is its own pack; only bottom
    groups carry logp/precip/sst (res_domain.f90:206-256)."""
    cls: RegionClass
    res: BatchedReservoir
    hyper: ESNHyper
    std: Standardizer
    zspec: object = None

    @property
    def bottom(self):
        return self.zspec is None or self.zspec.bottom


class HybridAtmosphere:
    """Hybrid cycle driver (atmosphere reservoirs; ocean added separately)."""

    TIMESTEP_HOURS = 6
    NVAR = 4  # T, u, v, q

    SLAB_STRIDE = 28   # atmosphere cycles per ocean step (168 h / 6 h)

    def __init__(self, gcm: GCM, layout: RegionLayout,
                 packs: list[ClassPack], ml_only: bool = False,
                 ocean_packs: Optional[list] = None,
                 base_sst: Optional[jnp.ndarray] = None,
                 sea_mask: Optional[jnp.ndarray] = None):
        self.gcm = gcm
        self.layout = layout
        self.packs = packs
        self.ml_only = ml_only
        self.ocean_packs = ocean_packs
        # base_sst/sea_mask: land fill values + mask for the ML SST grid
        # (mpires.f90:458-472; sea_mask > 0 means LAND there)
        self.base_sst = base_sst
        self.sea_mask = sea_mask
        # date-indexed climatology tables (set_tisr_table/set_sst_table):
        # full_tisr (n_hours, lat, lon) hourly-ish over a 365-day year and
        # full_sst (365, lat, lon) daily (get_tisr_by_date/get_sst_by_date,
        # mpires.f90:1644-1725).  Absent -> analytic TISR, SST held/ML.
        self.tisr_table = None
        self.tisr_hours_per_entry = 1
        self.sst_table = None
        # emit v_p/v_ml readout contributions in the cycle diagnostics
        # (outvec_component_contribs; v_p/v_ml streams of
        # mpires.f90:1114-1514).  Static: toggling retraces the cycle.
        self.emit_components = False
        # persist the slab land/ice anomaly models across hybrid cycles
        # with a daily coupler exchange (reference fluxes.grd semantics,
        # VERDICT r1 weak #9); off -> each window re-inits surfaces from
        # climatology (round-1 behavior).  Static: toggling retraces.
        self.persist_surface = False
        # peer-to-peer sharded cycle (set_mesh): assemble/feedback/
        # local_model run shard-mapped over lon sectors with ppermute
        # halos instead of a replicated grid (hybrid/sharded.py)
        self.mesh = None
        self._sharded_ops = None
        g = gcm.geom
        self.nz = g.nlev
        # steps of the GCM inside one hybrid window
        self.gcm_steps = gcm.nsteps_day * self.TIMESTEP_HOURS // 24

    def set_mesh(self, mesh, shard_gcm: bool = True):
        """Switch the cycle to the hub-free sharded path: region outputs
        scatter into LON-SECTOR grid shards, halos move by ring ppermute,
        and feedback/local-model windows gather shard-locally (the
        peer-to-peer transposition of sendrecievegrid, mpires.f90:218-780).
        Call BEFORE the first traced cycle; also lat-shards the GCM's
        grid-space physics (GCM.set_mesh) unless shard_gcm=False."""
        from speedy_ml_tpu.hybrid.sharded import ShardedCycleOps
        self.mesh = mesh
        self._sharded_ops = ShardedCycleOps(self.layout, self.packs, mesh)
        if shard_gcm:
            self.gcm.set_mesh(mesh)

    # ------------------------------------------------------------------

    def init_state(self, sst_grid: jnp.ndarray) -> HybridState:
        cls_states = []
        for p in self.packs:
            Rc = p.cls.count
            cls_states.append(ClassState(
                x=jnp.zeros((Rc, p.res.n), dtype=self.gcm.dtype),
                feedback=jnp.zeros((Rc, p.res.n_inputs), dtype=self.gcm.dtype),
                local_model=jnp.zeros((Rc, p.res.n_speedy), dtype=self.gcm.dtype)))
        return HybridState(classes=tuple(cls_states),
                           sst_grid=jnp.asarray(sst_grid),
                           safe=jnp.asarray(True, dtype=jnp.bool_),
                           step=jnp.asarray(0, dtype=jnp.int32),
                           ocean=self._init_ocean_states())

    def _init_ocean_states(self) -> tuple:
        if not self.ocean_packs:
            return ()
        W = self.SLAB_STRIDE - 1
        out = []
        for op in self.ocean_packs:
            Rc = op.cls.count
            I_o = len(op.idx_map)
            lm = (jnp.zeros((Rc, op.res.n_outputs), dtype=self.gcm.dtype)
                  if op.hybrid_readout else None)
            out.append(OceanClassState(
                x=jnp.zeros((Rc, op.res.n), dtype=self.gcm.dtype),
                buffer=jnp.zeros((W, Rc, I_o), dtype=self.gcm.dtype),
                lm=lm))
        return tuple(out)

    def start_prediction(self, truth_sync: dict, model_next: Optional[dict],
                         sst0: jnp.ndarray) -> HybridState:
        """Synchronize reservoirs on a truth window, then arm the first
        cycle (start_prediction/synchronize, mod_reservoir.f90:938-959,
        1352-1379).

        truth_sync: dict of grids (T, ...) as in hybrid.training; the last
        sample is the initial condition.  model_next: imperfect-model
        forecast grids valid one step AFTER the window end (or None for
        ml_only)."""
        from speedy_ml_tpu.esn.reservoir import synchronize
        from speedy_ml_tpu.hybrid.training import pack_class_series

        cls_states = []
        for p in self.packs:
            series = pack_class_series(self.layout, p.cls, truth_sync,
                                       zspec=p.zspec)
            z = p.std.standardize_input(series.astype(self.gcm.dtype))
            x = synchronize(p.res, jnp.zeros((p.cls.count, p.res.n),
                                             dtype=self.gcm.dtype),
                            z[:-1], p.hyper.leakage)
            feedback = z[-1]
            if model_next is not None:
                a = (model_next["atmo"] if p.zspec is None
                     else model_next["atmo"][:, p.zspec.z0:p.zspec.z1])
                vec = self.layout.pack_vector(
                    p.cls, a,
                    logp=model_next["logp"] if p.bottom else None,
                    core_only=True)
                S = p.res.n_speedy
                lm = (vec[:, :S] - p.std.out_mean[:, :S]) / p.std.out_std[:, :S]
            else:
                lm = jnp.zeros((p.cls.count, p.res.n_speedy),
                               dtype=self.gcm.dtype)
            cls_states.append(ClassState(x=x, feedback=feedback,
                                         local_model=lm))

        # seed the ocean rolling buffers from the sync window (paired with
        # the BOTTOM atmo pack of each class — the slab ocean reads the
        # lowest-level inputs, get_training_data_from_atmo)
        ocean_states = []
        if self.ocean_packs:
            W = self.SLAB_STRIDE - 1
            for op, bi in zip(self.ocean_packs, self._bottom_index()):
                p = self.packs[bi]
                series = pack_class_series(self.layout, op.cls, truth_sync)
                z = p.std.standardize_input(series.astype(self.gcm.dtype))
                o_series = z[:, :, jnp.asarray(op.idx_map)]
                T = o_series.shape[0]
                reps = (W + T - 1) // T
                buf = jnp.tile(o_series, (reps, 1, 1))[-W:]
                lm = None
                if op.hybrid_readout:
                    # seed the slab local model with the last observed
                    # SST core (start_prediction_slab seeds outvec from
                    # the final ERA SST, mod_slab_ocean_reservoir.f90:
                    # 769-800), standardized
                    from speedy_ml_tpu.esn.ocean import (
                        ocean_target_slice, sst_core_from_input)
                    sl = ocean_target_slice(op.cls, self.nz)
                    lm = sst_core_from_input(op.cls, z[-1, :, sl[0]:sl[1]])
                ocean_states.append(OceanClassState(
                    x=jnp.zeros((op.cls.count, op.res.n),
                                dtype=self.gcm.dtype),
                    buffer=buf, lm=lm))
        return HybridState(classes=tuple(cls_states),
                           sst_grid=jnp.asarray(sst0),
                           safe=jnp.asarray(True, dtype=jnp.bool_),
                           step=jnp.asarray(0, dtype=jnp.int32),
                           ocean=tuple(ocean_states))

    def _bottom_index(self) -> list:
        """Index into packs of each layout class's bottom pack (the one
        carrying surface blocks), in layout.classes order."""
        out = []
        for cls in self.layout.classes:
            for i, p in enumerate(self.packs):
                if p.cls is cls and p.bottom:
                    out.append(i)
                    break
        return out

    # ------------------------------------------------------------------
    # pieces of the cycle
    # ------------------------------------------------------------------

    @property
    def params(self):
        """Dynamic model parameters: (atmo (res, std) tuple, ocean tuple)."""
        atmo = tuple((p.res, p.std) for p in self.packs)
        ocean = tuple((op.res, op.mean_sst, op.std_sst)
                      for op in (self.ocean_packs or ()))
        return (atmo, ocean)

    def cast_wout_bf16(self):
        """Store the readout weights in bfloat16 (in place on the packs).

        Optional perf mode: the cycle's readout is bound by the Wout read
        (3.8 GB f32 at m=6000 x 1,152 regions); bf16 halves it.  Outputs
        keep an f32 accumulator (see esn.reservoir.readout); the ~0.4%
        relative weight rounding sits far below the 0.2-sigma training
        noise."""
        self.packs = [p._replace(res=dataclasses.replace(
            p.res, wout=p.res.wout.astype(jnp.bfloat16)))
            for p in self.packs]
        return self

    def _with_params(self, params):
        """(atmo packs, ocean packs) with dynamic parts from `params`."""
        atmo_p, ocean_p = params
        packs = [ClassPack(cls=p.cls, res=r, hyper=p.hyper, std=s,
                           zspec=p.zspec)
                 for p, (r, s) in zip(self.packs, atmo_p)]
        opacks = [OceanPack(cls=op.cls, res=r, hyper=op.hyper,
                            idx_map=op.idx_map, mean_sst=m, std_sst=s,
                            hybrid_readout=op.hybrid_readout)
                  for op, (r, m, s) in zip(self.ocean_packs or (), ocean_p)]
        return packs, opacks

    def predict_all(self, packs, hstate: HybridState,
                    components: bool = False):
        """ESN step + readout for every region (predict/predict_ml,
        mod_reservoir.f90:1416-1533).  Returns (new xs, physical outvecs
        [, list of standardized (v_p, v_ml) contribution pairs]).

        components=True also splits the readout into the SPEEDY (v_p) and
        reservoir (v_ml) contributions without re-running the ESN step
        (outvec_component_contribs, mod_reservoir.f90:1456-1467)."""
        from speedy_ml_tpu.esn.reservoir import quad_expand
        new_x = []
        outvecs = []
        contribs = []
        for p, cs in zip(packs, hstate.classes):
            x = esn_step(p.res, cs.x, cs.feedback, p.hyper.leakage)
            lm = None if self.ml_only else cs.local_model
            if components:
                xt = quad_expand(x)
                S = p.res.n_speedy
                v_ml = jnp.einsum("roa,ra->ro", p.res.wout[:, :, S:], xt)
                if lm is not None:
                    v_p = jnp.einsum("roa,ra->ro", p.res.wout[:, :, :S], lm)
                    out = v_p + v_ml
                else:
                    v_p = jnp.zeros_like(v_ml)
                    out = v_ml
                contribs.append((v_p, v_ml))
            else:
                out = readout(p.res, x, lm)
            outvecs.append(p.std.unstandardize_output(out))
            new_x.append(x)
        if components:
            return new_x, outvecs, contribs
        return new_x, outvecs

    def assemble_global(self, packs, outvecs, clamp: bool = True):
        """Scatter region outputs into global grids + clamps
        (tile_full_grid_with_local_state_vec_res + mpires.f90:444-478).
        clamp=False skips the physical q/precip clamps (used for the raw
        v_p/v_ml contribution grids, which are standardized deltas).

        With vertical localization each pack writes only its core sigma
        band; logp/precip come from the bottom groups."""
        g = self.gcm.geom
        dt = self.gcm.dtype
        atmo = jnp.zeros((self.NVAR, self.nz, g.nlat, g.nlon), dtype=dt)
        logp = jnp.zeros((g.nlat, g.nlon), dtype=dt)
        precip = jnp.zeros((g.nlat, g.nlon), dtype=dt)
        for p, vec in zip(packs, outvecs):
            nz_core = self.nz if p.zspec is None else p.zspec.nz_core
            parts = self.layout.unpack_core_vector(
                p.cls, vec, self.NVAR, nz_core,
                logp=p.bottom, precip=p.bottom)
            z0 = 0 if p.zspec is None else p.zspec.z0
            band = self.layout.scatter_core(
                p.cls, parts["atmo"], atmo[:, z0:z0 + nz_core])
            atmo = atmo.at[:, z0:z0 + nz_core].set(band)
            if p.bottom:
                logp = self.layout.scatter_core(p.cls, parts["logp"], logp)
                precip = self.layout.scatter_core(p.cls, parts["precip"],
                                                  precip)
        if clamp:
            atmo = atmo.at[3].set(jnp.maximum(atmo[3], 1e-6))   # q clamp
            precip = jnp.where(precip < 1e-5, 0.0, precip)
        return atmo, logp, precip

    def inject_to_speedy(self, atmo, logp):
        """Grid -> spectral with truncation + back (iogrid 30).

        Returns (SpectralState at level 0, smoothed grid fields, safe)."""
        sht = self.gcm.sht
        tg, ug, vg, qg = atmo[0], atmo[1], atmo[2], atmo[3]
        qg = jnp.maximum(qg, 0.0)

        vor, div = sht.vdspec(ug, vg, kcos=2)
        t_s = sht.grid_to_spec(tg)
        q_s = sht.grid_to_spec(qg)
        ps_s = sht.grid_to_spec(logp)
        vor, div = sht.trunct(vor), sht.trunct(div)
        t_s, q_s, ps_s = sht.trunct(t_s), sht.trunct(q_s), sht.trunct(ps_s)

        # the double transform: back to grid for the safety check (and the
        # smoothing the trained weights expect)
        u2, v2 = sht.uv_grid(vor, div)
        t2 = sht.spec_to_grid(t_s)
        q2 = sht.spec_to_grid(q_s)

        safe = ((u2.min() >= -150.0) & (u2.max() <= 150.0)
                & (v2.min() >= -120.0) & (v2.max() <= 120.0)
                & (t2.min() >= 160.0) & (t2.max() <= 330.0)
                & (q2.min() >= -6.0) & (q2.max() <= 30.0))

        spec = SpectralState(
            vor=jnp.stack([vor, vor]), div=jnp.stack([div, div]),
            t=jnp.stack([t_s, t_s]), ps=jnp.stack([ps_s, ps_s]),
            tr=jnp.stack([q_s[None], q_s[None]]))
        return spec, safe

    @functools.partial(jax.jit, static_argnums=0)
    def speedy_window(self, spec: SpectralState, sst_hybrid, imon, fmon,
                      tyear, sfc_carry=None) -> tuple:
        """Run SPEEDY for one 6-h window from a cold start (run_model,
        mpires.f90:1516-1628 + agcm flow).

        sfc_carry: persistent coupled-surface anomalies (land skin
        temperature, slab-ocean/ice temps) carried across hybrid cycles
        — the reference keeps these through restarts via fluxes.grd
        (mod_cpl_land_model.f90:85-126); None re-inits from climatology.
        Returns (atmo forecast, logp forecast, window FluxAccumulator)."""
        gcm = self.gcm
        g = gcm.geom
        sfc = init_surface_state(gcm.bd, imon, fmon, sst_hybrid=sst_hybrid,
                                 flags=gcm.cpl)
        if sfc_carry is not None:
            # climatology + hybrid SST injection (ini_sea) but the
            # prognostic anomaly fields come from the carried models
            # (ini_land restart path)
            sfc = dataclasses.replace(
                sfc, stl_lm=sfc_carry.stl_lm, stl_am=sfc_carry.stl_lm,
                sst_om=sfc_carry.sst_om, tice_om=sfc_carry.tice_om,
                tice_am=sfc_carry.tice_om)
        gstate = GCMState(
            spectral=spec, sfc=sfc,
            radiation=RadiationCarry.zeros(g.nlev, g.nlat, g.nlon, gcm.dtype),
            fluxes=FluxAccumulator.zeros(g.nlat, g.nlon, gcm.dtype),
            istep=jnp.asarray(0, dtype=jnp.int32))
        forcing = gcm.phys.daily_forcing(gcm.bd, sfc, tyear, gcm.sht)
        gstate = gcm.stepone(gstate, forcing)
        gstate = gcm.run_window(gstate, forcing, self.gcm_steps)

        # extract at leapfrog level 0 (iogrid 31 reads time level 1)
        sht = gcm.sht
        sp = gstate.spectral
        u, v = sht.uv_grid(sp.vor[0], sp.div[0])
        t = sht.spec_to_grid(sp.t[0])
        q = sht.spec_to_grid(sp.tr[0, 0])
        logp = sht.spec_to_grid(sp.ps[0])
        return jnp.stack([t, u, v, q]), logp, gstate.fluxes

    def build_feedback(self, packs, atmo, logp, precip, sst_grid, tisr_grid):
        """Per-class standardized feedback vectors (sendrecievegrid
        scatter + standardize, mpires.f90:561-750)."""
        out = []
        for p in packs:
            if p.zspec is None:
                a = atmo
            else:
                a = atmo[:, p.zspec.zi0:p.zspec.zi1]
            vec = self.layout.pack_vector(
                p.cls, a,
                logp=logp if p.bottom else None,
                precip=precip if p.bottom else None,
                sst=sst_grid if p.bottom else None,
                tisr=tisr_grid)
            out.append(p.std.standardize_input(vec))
        return out

    def build_local_model(self, packs, fc_atmo, fc_logp):
        """Per-class standardized SPEEDY forecast vectors (core, atmo+logp)."""
        out = []
        for p in packs:
            if p.zspec is None:
                a = fc_atmo
            else:
                a = fc_atmo[:, p.zspec.z0:p.zspec.z1]
            vec = self.layout.pack_vector(
                p.cls, a, logp=fc_logp if p.bottom else None,
                core_only=True)
            # speedy vector = output layout minus the trailing precip block
            S = p.res.n_speedy
            vec = vec[:, :S]
            out.append((vec - p.std.out_mean[:, :S]) / p.std.out_std[:, :S])
        return out

    def set_tisr_table(self, table, hours_per_entry: int = 1):
        """Install a TISR climatology over one 365-day year
        (full_tisr of get_tisr_by_date, mpires.f90:1644-1676).
        table: (n_entries, lat, lon), entry k valid at hour
        k*hours_per_entry into the year."""
        self.tisr_table = jnp.asarray(table, dtype=self.gcm.dtype)
        self.tisr_hours_per_entry = int(hours_per_entry)

    def set_sst_table(self, table):
        """Install a daily SST climatology (365, lat, lon)
        (full_sst of get_sst_by_date, mpires.f90:1679-1725)."""
        self.sst_table = jnp.asarray(table, dtype=self.gcm.dtype)

    def tisr_field(self, tyear, hour_of_year=None, table=None,
                   hours_per_entry: int = 1):
        """TISR input field for the current date.

        With a table (a traced jit argument — see _cycle_jit, which
        threads self.tisr_table through explicitly so installing or
        swapping a table retraces/re-reads correctly) and a traced
        hour_of_year, index it like get_tisr_by_date
        (mpires.f90:1644-1676); otherwise substitute the analytic
        Hartmann daily-mean insolation, which carries the same seasonal
        signal."""
        g = self.gcm.geom
        if table is not None and hour_of_year is not None:
            k = (hour_of_year // hours_per_entry) % table.shape[0]
            return jax.lax.dynamic_index_in_dim(table, k, 0,
                                                keepdims=False)
        slat = jnp.asarray(g.sin_lat, dtype=self.gcm.dtype)
        clat = jnp.asarray(g.cos_lat, dtype=self.gcm.dtype)
        row = solar_flux_traced(tyear, 4.0 * SOLC, slat, clat)
        return jnp.broadcast_to(row[:, None], (g.nlat, g.nlon))

    def sst_by_date(self, hour_of_year, sst_bias, table):
        """Daily-climatology SST with the non-stationary bias ramp applied
        over open water (get_sst_by_date, mpires.f90:1679-1725: bias added
        where SST > 273 K when non_stationary_ocn_climo).  `table` is a
        traced jit argument (threaded by _cycle_jit)."""
        day = (hour_of_year // 24) % table.shape[0]
        sst = jax.lax.dynamic_index_in_dim(table, day, 0, keepdims=False)
        return jnp.where(sst > 273.0, sst + sst_bias, sst)

    # ------------------------------------------------------------------

    def cycle_with_params(self, params, hstate: HybridState, imon, fmon,
                          tyear, hour_of_year=None, sst_bias=0.0) -> tuple:
        """One 6-h hybrid step with explicit parameters (jit arguments).

        hour_of_year: traced int hour into the 365-day year, required for
        the date-indexed TISR/SST climatology tables; sst_bias: the
        non-stationary-climate SST offset (current_sst_bias).
        Returns (new_state, diagnostics dict)."""
        # feature flags enter the jit cache key explicitly — mutating an
        # instance attribute alone would NOT retrace a self-static jit.
        # The TISR/SST tables are likewise threaded as real jit arguments
        # (presence changes the pytree structure -> retrace; content
        # changes are plain array updates), so set_*_table works even
        # after the first traced cycle.
        return self._cycle_jit(params, hstate, imon, fmon, tyear,
                               hour_of_year,
                               jnp.asarray(sst_bias, dtype=self.gcm.dtype),
                               (self.tisr_table, self.sst_table),
                               self.emit_components, self.persist_surface,
                               self.tisr_hours_per_entry,
                               self._sharded_ops is not None)

    @functools.partial(jax.jit, static_argnums=(0, 9, 10, 11, 12))
    def _cycle_jit(self, params, hstate: HybridState, imon, fmon,
                   tyear, hour_of_year, sst_bias, tables, emit_components,
                   persist_surface, tisr_hpe, sharded) -> tuple:
        # `sharded` mirrors self._sharded_ops presence in the jit cache
        # key, so set_mesh AFTER a traced cycle still retraces (self is
        # static with identity hash; its attributes alone would not)
        packs, opacks = self._with_params(params)
        tisr_table, sst_table = tables

        # SST seen by the ESN inputs and SPEEDY this cycle: without an ML
        # ocean, follow the daily climatology (get_sst_by_date); the ML
        # ocean overwrites it every SLAB_STRIDE cycles below.
        if sst_table is not None and hour_of_year is not None \
                and not self.ocean_packs:
            hstate = dataclasses.replace(
                hstate, sst_grid=self.sst_by_date(hour_of_year, sst_bias,
                                                  sst_table))

        contribs = None
        if emit_components:
            new_x, outvecs, contribs = self.predict_all(packs, hstate,
                                                        components=True)
        else:
            new_x, outvecs = self.predict_all(packs, hstate)
        if sharded:
            atmo, logp, precip = self._sharded_ops.assemble(
                packs, outvecs, self.nz, self.gcm.dtype)
        else:
            atmo, logp, precip = self.assemble_global(packs, outvecs)

        new_sfc, new_fluxes = hstate.sfc, hstate.fluxes
        if self.ml_only:
            fc_atmo = fc_logp = None
            safe = jnp.asarray(True, dtype=jnp.bool_)
        else:
            g = self.gcm.geom
            sfc_carry = None
            if persist_surface:
                sfc_carry = hstate.sfc
                fx_acc = hstate.fluxes
                if sfc_carry is None:      # first cycle: climo init
                    sfc_carry = init_surface_state(self.gcm.bd, imon, fmon,
                                                   flags=self.gcm.cpl)
                    fx_acc = FluxAccumulator.zeros(g.nlat, g.nlon,
                                                   self.gcm.dtype)
            spec, safe = self.inject_to_speedy(atmo, logp)
            # gate BEFORE running (ppo_iogrid.f90:563-577, mpires.f90:721):
            # an unphysical state must never feed SPEEDY — the window is
            # skipped in-graph and the smoothed injected fields stand in as
            # the "forecast" so no NaN can poison subsequent state.  The
            # driver aborts the run on the tripped flag.
            ok = hstate.safe & safe
            fc_atmo, fc_logp, wfx = jax.lax.cond(
                ok,
                lambda _: self.speedy_window(spec, hstate.sst_grid, imon,
                                             fmon, tyear, sfc_carry),
                lambda _: (atmo, logp,
                           FluxAccumulator.zeros(g.nlat, g.nlon,
                                                 self.gcm.dtype)),
                operand=None)
            if persist_surface:
                # accumulate window fluxes; daily coupler exchange every
                # cycles-per-day steps (agcm_to_coupler/coupler_to_agcm)
                fx_acc = jax.tree_util.tree_map(jnp.add, fx_acc, wfx)
                cpd = 24 // self.TIMESTEP_HOURS
                do_couple = (hstate.step % cpd) == (cpd - 1)
                from speedy_ml_tpu.physics.land_sea import couple_daily
                coupled = couple_daily(
                    sfc_carry, self.gcm.slab, self.gcm.bd,
                    dict(hflux_l=fx_acc.hflux_l, hflux_s=fx_acc.hflux_s,
                         hflux_i=fx_acc.hflux_i), imon, fmon,
                    flags=self.gcm.cpl, wsst_ob=self.gcm.wsst_ob,
                    sstom12=self.gcm.sstom12)
                new_sfc = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(do_couple, a, b), coupled,
                    sfc_carry)
                new_fluxes = jax.tree_util.tree_map(
                    lambda a: jnp.where(do_couple, jnp.zeros_like(a), a),
                    fx_acc)

        tisr = self.tisr_field(tyear, hour_of_year, table=tisr_table,
                               hours_per_entry=tisr_hpe)
        if sharded:
            feedbacks = self._sharded_ops.feedback(
                packs, atmo, logp, precip, hstate.sst_grid, tisr)
            if self.ml_only:
                locals_ = [cs.local_model for cs in hstate.classes]
            else:
                locals_ = self._sharded_ops.local_model(packs, fc_atmo,
                                                        fc_logp, self.nz)
        else:
            feedbacks = self.build_feedback(packs, atmo, logp, precip,
                                            hstate.sst_grid, tisr)
            if self.ml_only:
                locals_ = [cs.local_model for cs in hstate.classes]
            else:
                locals_ = self.build_local_model(packs, fc_atmo, fc_logp)

        # --- slab-ocean reservoirs: accumulate every cycle, step every
        #     SLAB_STRIDE cycles (parallelmain.f90:236-248, mpires.f90:753-757)
        sst_grid = hstate.sst_grid
        new_ocean = hstate.ocean
        if opacks and len(hstate.ocean):
            do_step = (hstate.step % self.SLAB_STRIDE) == (self.SLAB_STRIDE - 1)
            sst_new = jnp.zeros_like(sst_grid)
            ocean_states = []
            bottom_fb = [feedbacks[i] for i in self._bottom_index()]
            for op, ocs, fb in zip(opacks, hstate.ocean, bottom_fb):
                o_in = fb[:, jnp.asarray(op.idx_map)]
                buffer = jnp.concatenate([ocs.buffer[1:], o_in[None]], axis=0)
                fb_mean = buffer.mean(axis=0)

                # the slab ESN only advances every SLAB_STRIDE cycles;
                # lax.cond skips its spmv/readout entirely in between.
                # Hybrid readout (predict_slab): the previous slab
                # output rides along as the local-model block and the
                # new output replaces it.
                def _advance(x, lm, op=op, fb_mean=fb_mean):
                    x_new = esn_step(op.res, x, fb_mean, op.hyper.leakage)
                    out = readout(op.res, x_new,
                                  lm if op.hybrid_readout else None)
                    lm_new = out if op.hybrid_readout else lm
                    return x_new, lm_new, out * op.std_sst + op.mean_sst

                def _hold(x, lm, op=op):
                    return x, lm, jnp.zeros(
                        (op.cls.count, op.res.n_outputs),
                        dtype=self.gcm.dtype)

                lm0 = (ocs.lm if ocs.lm is not None else
                       jnp.zeros((op.cls.count, op.res.n_outputs),
                                 dtype=self.gcm.dtype))
                x_keep, lm_keep, out_phys = jax.lax.cond(
                    do_step, _advance, _hold, ocs.x, lm0)
                ocean_states.append(OceanClassState(
                    x=x_keep, buffer=buffer,
                    lm=lm_keep if op.hybrid_readout else None))
                xc, yc = op.cls.core_shape
                patches = out_phys.reshape(-1, yc, xc)
                sst_new = self.layout.scatter_core(op.cls, patches, sst_new)
            # land fill + freezing floor (mpires.f90:458-472)
            if self.sea_mask is not None:
                sst_new = jnp.where(jnp.asarray(self.sea_mask) > 0.0,
                                    jnp.asarray(self.base_sst), sst_new)
            sst_new = jnp.maximum(sst_new, 272.0)
            sst_grid = jnp.where(do_step, sst_new, sst_grid)
            new_ocean = tuple(ocean_states)

        classes = tuple(
            ClassState(x=x, feedback=fb, local_model=lm)
            for x, fb, lm in zip(new_x, feedbacks, locals_))
        new_state = HybridState(classes=classes, sst_grid=sst_grid,
                                safe=hstate.safe & safe,
                                step=hstate.step + 1, ocean=new_ocean,
                                sfc=new_sfc, fluxes=new_fluxes)
        diag = dict(atmo=atmo, logp=logp, precip=precip,
                    speedy_atmo=fc_atmo, speedy_logp=fc_logp)
        if contribs is not None:
            # assemble the standardized v_p/v_ml readout contributions
            # into global grids (the reference's v_p/v_ml NetCDF streams)
            asm = (lambda pk, v, clamp: self._sharded_ops.assemble(
                       pk, v, self.nz, self.gcm.dtype, clamp=clamp)
                   ) if sharded else self.assemble_global
            vp_a, vp_l, vp_p = asm(packs, [c[0] for c in contribs],
                                   clamp=False)
            vml_a, vml_l, vml_p = asm(packs, [c[1] for c in contribs],
                                      clamp=False)
            diag.update(vp_atmo=vp_a, vp_logp=vp_l, vp_precip=vp_p,
                        vml_atmo=vml_a, vml_logp=vml_l, vml_precip=vml_p)
        return new_state, diag

    def cycle(self, hstate: HybridState, imon, fmon, tyear,
              hour_of_year=None, sst_bias=0.0) -> tuple:
        """Convenience wrapper using this instance's stored parameters."""
        return self.cycle_with_params(self.params, hstate, imon, fmon,
                                      tyear, hour_of_year, sst_bias)
