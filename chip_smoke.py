"""Smoke test of the hybrid model on an NVIDIA GPU, at production width.

    python chip_smoke.py               # one card: every one-card phase
    python chip_smoke.py --devices 4   # four cards: the sharded path only

Phases (one card, in order): device, gcm, cycle, train_predict, solve,
spmv.  With --devices 4 only the `sharded` phase runs.  Each phase prints
its findings, each GPU-vs-CPU or f64 comparison beside its tolerance, and
its seconds.  The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed.  Without a GPU, or with any phase failing, the script
exits non-zero and prints no such line.

Everything runs in this one process: a JAX process reserves most of the
card's memory, so no second JAX process may open it.  The CPU backend is
used in-process for the GPU-vs-CPU comparisons (leave JAX_PLATFORMS
unset, or include cpu in it).

Production width (T30L8, 96x48x8 grid; 1,152 regions; atmosphere m=6000,
n=5,760 nodes per interior region; slab ocean m=4000; 6-h cycle, 168-h
slab step) with random weights from fixed seeds.  `rehearse()` runs the
same phase functions at a tiny size on whatever backend is present (the
CPU tests use it); it never prints the ok line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ONE_CARD_PHASES = ("device", "gcm", "cycle", "train_predict", "solve", "spmv")

# Ridge for the smoke's short training series (train_predict, solve,
# sharded training step).  A 672-h series gives 72 (state, target) pairs
# against A=5,892 unknowns per region, so the Gram has rank <= 72; the
# reference's beta_res=0.001 (squared: 1e-6, ~1e-8 of the Gram diagonal)
# is then below float32 round-off and the f32 solve returns noise.  These
# are the ridges the repo's climate run uses for short series
# (scripts/climate_run.py: ATMO_BETA, OCEAN_BETA).
ATMO_BETA = 0.2
OCEAN_BETA = 0.01
# scale of the random readout beside the identity on the SPEEDY forecast
# (see evolving_hybrid): weights of N(0, 1e-4), a reservoir term of a few
# 1e-3 in standardized units per cycle
WOUT_SCALE = 0.1
# 6-h samples of the nature run that fits the standardization and
# synchronizes the reservoirs in the `cycle` and `sharded` phases
NATURE_SAMPLES = 8


@dataclasses.dataclass(frozen=True)
class Size:
    trunc: int
    nlon: int
    nlat: int
    nlev: int
    n_regions: int
    m: int                   # atmosphere reservoir size target
    ocean_m: int
    slab_hours: int          # slab-ocean step
    training_hours: int      # 4 slab steps: the least that trains the slab
    discard_hours: int
    sync_hours: int
    prediction_hours: int    # >= 32 cycles at production, crosses a slab step
    cycles: int              # free-running cycles in the `cycle` phase
    timing_reps: int
    solve_regions: int
    solve_samples: int
    dense_regions: int       # regions checked against a dense A x

    def geometry(self):
        from speedy_ml_tpu.core.geometry import Geometry
        return Geometry(trunc=self.trunc, nlon=self.nlon, nlat=self.nlat,
                        nlev=self.nlev)


PRODUCTION = Size(trunc=30, nlon=96, nlat=48, nlev=8, n_regions=1152,
                  m=6000, ocean_m=4000, slab_hours=168,
                  training_hours=4 * 168, discard_hours=240, sync_hours=12,
                  prediction_hours=32 * 6, cycles=40, timing_reps=20,
                  solve_regions=4, solve_samples=600, dense_regions=4)

# CPU rehearsal: the same code paths at a size a test can afford
TINY = Size(trunc=10, nlon=32, nlat=16, nlev=8, n_regions=32, m=1400,
            ocean_m=600, slab_hours=24, training_hours=4 * 24,
            discard_hours=24, sync_hours=12, prediction_hours=8 * 6,
            cycles=6, timing_reps=2, solve_regions=2, solve_samples=40,
            dense_regions=2)

# ----------------------------------------------------------------------
# tolerances (each with its reason)
# ----------------------------------------------------------------------

# gcm: GPU and CPU run the same f32 program; they differ in summation
# order and in the last bit of exp/log/pow.  On an H100 (700 W), stepone
# + 1 day differs by T 6.1e-5 K, u 1.4e-5, v 2.6e-5 m/s, q 1.1e-5 g/kg,
# log ps 9.3e-9.  With the spectral and dycore einsums at DEFAULT
# precision (TF32 on the card) the same day differs by T 0.50 K, u 0.23,
# v 0.44 m/s, q 0.20 g/kg, log ps 5.4e-4.  Each bound sits >= 160x above
# the first reading and >= 46x below the TF32 one.
GCM_TOL = {"t": 1e-2, "u": 5e-3, "v": 5e-3, "q": 2e-3, "logps": 1e-5}
# cycle, diag["atmo"] and diag["logp"], each field's max difference over
# its max magnitude: the readout passes the forecast through (identity)
# and adds a small reservoir term, then unstandardizes.  Its f32 sum runs
# over S+n ~ 5,900 terms while the running sum is the O(1)-sigma
# forecast, so a reordered sum walks ~sqrt(5,900)/2 ~ 40 ulp of it (f32
# ulp is 6e-8 to 1.2e-7 relative; v differed by 2.3e-6 on an H100).
# 2e-5 is ~170 ulp; TF32 rounding of the readout's inputs (2^-11 ~ 5e-4
# relative) is 25x past it.
CYCLE_ATMO_REL_TOL = 2e-5
# cycle, free run: T must move by at least this much somewhere between
# the first and the last cycle.  SPEEDY's weather moves T by kelvins in a
# day; an atmosphere the readout holds fixed does not move at all.
MIN_T_CHANGE = 0.5
# cycle, reservoir states: tanh of an f32 sum of <= J+1 terms; GPU and CPU
# tanh differ by a few ulp of values in [-1, 1].
CYCLE_X_TOL = 1e-5
# cycle, the reservoir part of the f32 readout (Wout's reservoir columns
# times x~, standardized) relative to its own largest value: a reordered
# f32 sum of n ~ 5,760 products differs by ~1e-6; TF32 inputs (10-bit
# mantissa) would give ~5e-4.  Past this bound the readout gets pinned to
# Precision.HIGHEST.
READOUT_REL_TOL = 5e-5
# solve: Gram from HIGHEST f32 GEMMs vs an f64 recomputation, relative
# Frobenius: f32 accumulation over N samples is ~sqrt(N)*6e-8 ~ 1e-6;
# TF32 inputs would give ~1e-3.
GRAM_REL_TOL = 1e-5
# solve: the f64 QR path vs scipy's f64 solve of the same Gram: both are
# f64 (cond <~ 1e6 -> ~1e-10), and Wout is returned in f32 (~3e-8
# relative rounding); the bound leaves room for both.
QR_REL_TOL = 1e-6
# spmv: the gather sums J=6 f32 products; dense HIGHEST matmul sums the
# same products (plus zeros) in another order: ~1e-7 relative.
GATHER_REL_TOL = 1e-5
# spmv: the one-hot einsum as it was (no precision argument) may round x
# to TF32 (2^-11 relative) on the card.
ONEHOT_REL_TOL = 2e-3
# sharded: the same cycle on 4 cards vs 1.  diag["atmo"] and x as in the
# `cycle` phase.  The 24-step SPEEDY forecast inside it starts from a
# spun-up atmosphere, where convection and condensation switch on
# thresholds: an ulp of difference can flip a column by one step's
# tendency.  From the same state, GPU and CPU forecasts differed by up to
# T 6.5e-2 K, u 1.4e-2, v 1.5e-2 m/s, q 3.6e-2 g/kg on an H100 (700 W).
# These bounds leave room for such flips; a wrong partition or halo moves
# whole bands by kelvins.  Precision is guarded by the `gcm` phase.
SHARD_FORECAST_TOL = {"t": 0.5, "u": 0.5, "v": 0.5, "q": 0.5}
# Legendre sums split over zonal wavenumbers reorder the f32 sums.
# Gram: HIGHEST f32 GEMMs of other batch shapes; Wout: the f32 LU
# amplifies the Gram's round-off by its condition number (~1e3-1e4 with
# this ridge and 64 samples).
SHARD_GRAM_REL_TOL = 1e-5
SHARD_WOUT_REL_TOL = 1e-2


class PhaseFailed(AssertionError):
    pass


def say(*a):
    print(*a, flush=True)


def check(name, value, tol):
    """Print one comparison beside its bound; raise if it is past it."""
    ok = bool(value <= tol)
    say(f"  {name}: {value:.3e} (tolerance {tol:.1e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise PhaseFailed(f"{name} = {value:.3e} > {tol:.1e}")


def rel_fro(a, b):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def max_abs(a, b):
    import numpy as np
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def atmo_fields(d1, d2):
    """(name, field of d1, field of d2) for each assembled grid field of
    two cycle diagnostics."""
    import numpy as np
    for i, k in enumerate(("T", "u", "v", "q")):
        yield k, np.asarray(d1["atmo"][i]), np.asarray(d2["atmo"][i])
    yield "log ps", np.asarray(d1["logp"]), np.asarray(d2["logp"])


def timed_median_ms(fn, reps):
    """Median wall ms of fn() over reps calls, each ended by
    block_until_ready (after one warm-up call)."""
    import jax
    import numpy as np
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def cycle_args(dtype):
    import jax.numpy as jnp
    return (jnp.asarray(0), jnp.asarray(0.5, dtype), jnp.asarray(0.05, dtype))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_device(size, ctx):
    import jax
    say(f"  jax {jax.__version__}, backend {jax.default_backend()}")
    say(f"  devices: {jax.devices()}")
    if ctx["require_gpu"]:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        for line in out.splitlines():
            say(f"  nvidia-smi: {line}")
        ctx["card"] = out.splitlines()[0] if out else "unknown"
    from speedy_ml_tpu.runtime.jax_setup import host_device
    if host_device() is None:
        raise PhaseFailed("no CPU backend in this process: the GPU-vs-CPU "
                          "comparisons need it (do not set JAX_PLATFORMS "
                          "to the GPU platform alone)")


def _grid_fields(gcm):
    import jax
    import jax.numpy as jnp
    sht = gcm.sht

    @jax.jit
    def fields(state):
        sp = state.spectral
        u, v = sht.uv_grid(sp.vor[0], sp.div[0])
        return dict(t=sht.spec_to_grid(sp.t[0]), u=u, v=v,
                    q=sht.spec_to_grid(sp.tr[0, 0]),
                    logps=sht.spec_to_grid(sp.ps[0]))
    return fields


def phase_gcm(size, ctx):
    """Stepone + one day of the GCM on the accelerator and on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from speedy_ml_tpu.data.calendar import ModelDate
    from speedy_ml_tpu.gcm import GCM

    gcm = GCM(size.geometry(), dtype=jnp.float32)
    say(f"  boundary data: {gcm.bc_source}")
    fields = _grid_fields(gcm)
    date = ModelDate(1990, 7, 1)

    def integrate(dev):
        with jax.default_device(dev):
            t0 = time.perf_counter()
            state, _ = gcm.init_state(date)
            state, _ = gcm.run_days(state, date, 1, stepone_first=True)
            out = {k: np.asarray(v) for k, v in fields(state).items()}
            return out, time.perf_counter() - t0

    acc, t_acc = integrate(ctx["accel"])
    cpu, t_cpu = integrate(ctx["host"])
    say(f"  stepone + 1 day ({gcm.nsteps_day} steps): accelerator "
        f"{t_acc:.1f} s, cpu {t_cpu:.1f} s (compile included)")
    for k, v in acc.items():
        if not np.isfinite(v).all():
            raise PhaseFailed(f"gcm field {k} not finite")
    t = acc["t"]
    say(f"  T range [{t.min():.1f}, {t.max():.1f}] K")
    if not (t.min() > 180.0 and t.max() < 330.0):
        raise PhaseFailed("gcm T out of [180, 330] K")
    for k in ("t", "u", "v", "q", "logps"):
        rms = float(np.sqrt(np.mean((acc[k].astype(np.float64)
                                     - cpu[k]) ** 2)))
        say(f"  {k}: rms diff {rms:.3e}")
        check(f"gcm {k} max |gpu - cpu|", max_abs(acc[k], cpu[k]),
              GCM_TOL[k])


def evolving_hybrid(gcm, size):
    """The production hybrid with random reservoirs
    (build_untrained_hybrid), set up to evolve as a trained one does.

    Its standardization is fitted to a short nature run, and its readout
    passes the standardized SPEEDY forecast through (identity on the
    local-model block) plus the random readout scaled by WOUT_SCALE, so
    each cycle is SPEEDY's 6-h forecast plus a small random term.  The compute graph is the trained hybrid's.
    Returns (hybrid, state synchronized on the nature run's window, as
    main.predict starts a prediction)."""
    import jax.numpy as jnp

    from speedy_ml_tpu.data.calendar import ModelDate
    from speedy_ml_tpu.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu.hybrid.training import (class_standardizer,
                                               generate_nature_run,
                                               pack_class_series)
    hyb = build_untrained_hybrid(gcm, n_regions=size.n_regions, m=size.m,
                                 radius_iters=10)
    truth, _, _ = generate_nature_run(gcm, ModelDate(1990, 1, 15),
                                      NATURE_SAMPLES, spinup_days=1)
    packs = []
    for p in hyb.packs:
        std = class_standardizer(hyb.layout, p.cls, pack_class_series(
            hyb.layout, p.cls, truth), gcm.geom.nlev)
        S = p.res.n_speedy
        wout = (WOUT_SCALE * p.res.wout).at[:, :S, :S].add(
            jnp.eye(S, dtype=p.res.wout.dtype))
        packs.append(p._replace(std=std, res=dataclasses.replace(
            p.res, wout=wout, mean=std.in_mean, std=std.in_std)))
    hyb.packs = packs
    state = hyb.start_prediction(
        {k: v[:-1] for k, v in truth.items()},
        dict(atmo=truth["atmo"][-1], logp=truth["logp"][-1]),
        truth["sst"][-1])
    return hyb, state


def phase_cycle(size, ctx):
    """The untrained production hybrid: one cycle GPU vs CPU, then free
    cycles with timing for the f32 and the bf16 readout."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from speedy_ml_tpu.esn.reservoir import readout
    from speedy_ml_tpu.gcm import GCM

    gcm = GCM(size.geometry(), dtype=jnp.float32)
    t0 = time.perf_counter()
    hyb, state = evolving_hybrid(gcm, size)
    ns = [p.res.n for p in hyb.packs]
    say(f"  built {size.n_regions} regions, m={size.m}, n per class {ns}, "
        f"Wout {sum(p.res.wout.size for p in hyb.packs) * 4 / 1e9:.2f} GB "
        f"f32, standardization fitted to and reservoirs synchronized on a "
        f"{NATURE_SAMPLES}-sample nature run, in "
        f"{time.perf_counter() - t0:.1f} s")
    args = cycle_args(jnp.float32)
    params = hyb.params
    t0 = time.perf_counter()
    state, _ = hyb.cycle_with_params(params, state, *args)
    jax.block_until_ready(state)
    say(f"  first cycle (compile included): {time.perf_counter() - t0:.1f} s")

    # one cycle on each device from the same params and state
    s_acc, d_acc = hyb.cycle_with_params(params, state, *args)
    host = ctx["host"]
    t0 = time.perf_counter()
    with jax.default_device(host):
        p_cpu, st_cpu, a_cpu = jax.device_put((params, state, args), host)
        s_cpu, d_cpu = hyb.cycle_with_params(p_cpu, st_cpu, *a_cpu)
        jax.block_until_ready(s_cpu)
    say(f"  cpu cycle (compile included): {time.perf_counter() - t0:.1f} s")
    for k, a, c in atmo_fields(d_acc, d_cpu):
        check(f"cycle diag {k} max |gpu - cpu| / max |cpu|",
              max_abs(a, c) / np.abs(c).max(), CYCLE_ATMO_REL_TOL)
    check("cycle reservoir x max |gpu - cpu|",
          max(max_abs(a.x, b.x) for a, b in zip(s_acc.classes,
                                                 s_cpu.classes)),
          CYCLE_X_TOL)
    for i, k in enumerate(("T", "u", "v", "q")):
        say(f"  speedy forecast {k}: max |gpu - cpu| "
            f"{max_abs(d_acc['speedy_atmo'][i], d_cpu['speedy_atmo'][i]):.3e}"
            " (reported; the GCM is compared in the gcm phase)")

    # the reservoir part of the f32 readout (Wout's reservoir columns
    # times x~), standardized, from the same x on each device
    ro = jax.jit(readout)
    reservoir_part = lambda r: dataclasses.replace(
        r, wout=r.wout[:, :, r.n_speedy:])
    rel = size_ml = 0.0
    for p, cs, pc, cc in zip(hyb.packs, state.classes, p_cpu[0],
                             st_cpu.classes):
        y_acc = np.asarray(ro(reservoir_part(p.res), cs.x))
        with jax.default_device(host):
            y_cpu = np.asarray(ro(reservoir_part(pc[0]), cc.x))
        size_ml = max(size_ml, float(np.abs(y_cpu).max()))
        rel = max(rel, max_abs(y_acc, y_cpu) / max(np.abs(y_cpu).max(),
                                                   1e-30))
    say(f"  reservoir part of the readout: max |.| {size_ml:.3e} "
        "(standardized)")
    check("f32 readout, reservoir part, max |gpu - cpu| / max |cpu|", rel,
          READOUT_REL_TOL)
    del p_cpu, st_cpu, s_cpu, d_cpu

    # free-running cycles on the accelerator, each timed to completion
    def run(n, params, state):
        ts, t_lo, t_hi, t_first = [], np.inf, -np.inf, None
        for _ in range(n):
            t0 = time.perf_counter()
            state, diag = hyb.cycle_with_params(params, state, *args)
            jax.block_until_ready(state)
            ts.append((time.perf_counter() - t0) * 1e3)
            a = np.asarray(diag["atmo"])
            if not (np.isfinite(a).all() and bool(state.safe)):
                raise PhaseFailed("cycle went non-finite or unsafe")
            t_lo, t_hi = min(t_lo, a[0].min()), max(t_hi, a[0].max())
            t_first = a[0] if t_first is None else t_first
        if not (t_lo > 180.0 and t_hi < 330.0):
            raise PhaseFailed(f"cycle T [{t_lo}, {t_hi}] outside [180, 330]")
        dt = float(np.abs(a[0] - t_first).max())
        return state, float(np.median(ts)), (t_lo, t_hi), dt

    state, ms32, trange, dt = run(size.cycles, params, s_acc)
    say(f"  {size.cycles} cycles f32 readout: safe, finite, T in "
        f"[{trange[0]:.1f}, {trange[1]:.1f}] K, T changed by up to "
        f"{dt:.1f} K from the first cycle; median cycle {ms32:.2f} ms")
    if dt < MIN_T_CHANGE:
        raise PhaseFailed(f"T changed by {dt} K < {MIN_T_CHANGE} K: the "
                          "free cycles do not evolve the atmosphere")
    del params
    hyb.cast_wout_bf16()
    params = hyb.params
    hyb.cycle_with_params(params, state, *args)       # compile bf16 variant
    n16 = max(2, size.cycles // 2)
    state, ms16, _, _ = run(n16, params, state)
    say(f"  {n16} cycles bf16 readout: median cycle {ms16:.2f} ms")
    ctx["cycle_ms"] = dict(f32=ms32, bf16=ms16)


def phase_train_predict(size, ctx):
    """main.train then main.predict through a RunConfig at full width."""
    import numpy as np

    from speedy_ml_tpu import main as entry
    from speedy_ml_tpu.config import RunConfig
    from speedy_ml_tpu.esn.reservoir import ESNHyper

    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg = RunConfig(
            trunc=size.trunc, nlon=size.nlon, nlat=size.nlat,
            nlev=size.nlev, n_regions=size.n_regions,
            timestep_slab_hours=size.slab_hours, slab_ocean=True,
            training_hours=size.training_hours,
            discard_hours=size.discard_hours, sync_hours=size.sync_hours,
            prediction_hours=size.prediction_hours,
            atmo=ESNHyper(m=size.m, beta_res=ATMO_BETA),
            ocean=ESNHyper(m=size.ocean_m, sigma=0.6, beta_res=OCEAN_BETA,
                           noise_mag=0.10, using_prior=False),
            output_path=os.path.join(scratch, "output"),
            checkpoint_path=os.path.join(scratch, "checkpoint"))
        say(f"  RunConfig: training {cfg.training_hours} h, discard "
            f"{cfg.discard_hours} h, sync {cfg.sync_hours} h, prediction "
            f"{cfg.prediction_hours} h, slab step {cfg.timestep_slab_hours} "
            f"h, atmo beta_res {ATMO_BETA}, ocean beta_res {OCEAN_BETA}")
        t0 = time.perf_counter()
        hyb = entry.train(cfg)
        t_train = time.perf_counter() - t0
        ns = [p.res.n for p in hyb.packs]
        no = [p.res.n for p in hyb.ocean_packs]
        say(f"  train: {t_train:.1f} s (nature run, forecasts, training, "
            f"checkpoint write); atmo n {ns}, ocean n {no}")
        for p in list(hyb.packs) + list(hyb.ocean_packs):
            if not np.isfinite(np.asarray(p.res.wout)).all():
                raise PhaseFailed("trained Wout not finite")
        t0 = time.perf_counter()
        hstate, dates = entry.predict(cfg, hyb=hyb)
        t_pred = time.perf_counter() - t0
        n_cycles = size.prediction_hours // 6
        say(f"  predict: {t_pred:.1f} s for {len(dates)} cycles (sync "
            f"window + compile included), safe={bool(hstate.safe)}")
        if len(dates) < n_cycles or not bool(hstate.safe):
            raise PhaseFailed("prediction stopped early or went unsafe")
        z = np.load(os.path.join(cfg.output_path, "prediction.npz"))
        atmo, sst = z["atmo"], z["sst"]
        if not (np.isfinite(atmo).all() and np.isfinite(sst).all()):
            raise PhaseFailed("prediction output not finite")
        t = atmo[:, 0]
        say(f"  prediction T in [{t.min():.1f}, {t.max():.1f}] K, SST in "
            f"[{sst.min():.1f}, {sst.max():.1f}] K; SST changed at the slab "
            f"step: {not np.array_equal(sst[0], sst[-1])}")
        if not (t.min() > 180.0 and t.max() < 330.0):
            raise PhaseFailed("prediction T out of [180, 330] K")
        ctx["train_s"], ctx["predict_s"] = t_train, t_pred
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _interior_reservoir(size, key, topology, n_regions):
    """Random reservoirs of the production interior class."""
    import jax.numpy as jnp

    from speedy_ml_tpu.esn.domain import RegionLayout
    from speedy_ml_tpu.esn.reservoir import (BatchedReservoir, ESNHyper,
                                             generate)
    from speedy_ml_tpu.hybrid.chunked import hyper_inputs
    from speedy_ml_tpu.runtime.jax_setup import on_host

    geom = size.geometry()
    layout = RegionLayout(geom, n_regions=size.n_regions, overlap=1)
    cls = max(layout.classes, key=lambda c: c.count)
    I = hyper_inputs(layout, cls, geom.nlev)
    hyper = ESNHyper(m=size.m, beta_res=ATMO_BETA)
    with on_host():
        cols, vals, win, shifts = generate(key, n_regions, I, hyper, 0.5,
                                           radius_iters=10,
                                           topology=topology)
    R, n = win.shape
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win,
                           wout=jnp.zeros((R, 0, 0), jnp.float32),
                           mean=jnp.zeros((R, 0)), std=jnp.ones((R, 0)),
                           n_in=I, shifts=shifts)
    xc, yc = cls.core_shape
    O = 4 * geom.nlev * xc * yc + 2 * xc * yc     # atmo + logp + precip
    return res, hyper, I, O, O - xc * yc


def phase_solve(size, ctx):
    """One Gram accumulation + ridge solve at the interior class's A,
    against numpy f64 on the same data."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from speedy_ml_tpu.esn.reservoir import esn_step, quad_expand
    from speedy_ml_tpu.esn.train import accumulate_batches, solve_wout

    R, T = size.solve_regions, size.solve_samples
    res, hyper, I, O, S = _interior_reservoir(size, jax.random.key(21),
                                              "shift", R)
    res = jax.device_put(res, ctx["accel"])
    A = S + res.n
    bs = T // 20          # 20 batches, like initialize_chunk_training
    k = jax.random.split(jax.random.key(22), 3)
    z = 0.5 * jax.random.normal(k[0], (T, R, I), jnp.float32)
    target = jax.random.normal(k[1], (T, R, O), jnp.float32)
    model = jax.random.normal(k[2], (T, R, S), jnp.float32)
    x0 = jnp.zeros((R, res.n), jnp.float32)

    acc = jax.jit(accumulate_batches, static_argnames=("hyper", "batch_size"))
    t0 = time.perf_counter()
    eq, _ = acc(res, hyper, z, target, model, x0, batch_size=bs)
    jax.block_until_ready(eq)
    say(f"  A = {A} (S={S}, n={res.n}), {R} regions, {T} samples; Gram "
        f"accumulation {time.perf_counter() - t0:.2f} s (compile included)")

    # f64 Gram from the same states (pairing of accumulate_batches:
    # state s_t has absorbed inputs u_0..u_{t-1} and pairs with row t)
    N = ((T - 1) // bs) * bs

    @jax.jit
    def states(res, x0, u):
        def body(x, ut):
            xn = esn_step(res, x, ut, hyper.leakage)
            return xn, xn
        _, tail = jax.lax.scan(body, x0, u)
        return quad_expand(jnp.concatenate([x0[None], tail], axis=0))

    sq = np.asarray(states(res, x0, z[:N - 1]), np.float64)
    aug = np.concatenate([np.asarray(model[:N], np.float64), sq], axis=2)
    tg = np.asarray(target[:N], np.float64)
    ss64 = np.stack([aug[:, r].T @ aug[:, r] for r in range(R)])
    st64 = np.stack([tg[:, r].T @ aug[:, r] for r in range(R)])
    check("Gram rel Frobenius |f32 - f64|",
          max(rel_fro(eq.ss, ss64), rel_fro(eq.st, st64)), GRAM_REL_TOL)

    # scipy-free f64 reference solve of the SAME (f32) Gram
    ss = np.asarray(eq.ss, np.float64)
    st = np.asarray(eq.st, np.float64)
    ridge = np.where(np.arange(A) < S, hyper.beta_model ** 2,
                     hyper.beta_res ** 2)
    ref = np.stack([np.linalg.solve(ss[r] + np.diag(ridge), st[r].T).T
                    for r in range(R)])

    solve = jax.jit(solve_wout, static_argnums=(1, 2, 3))
    for label, dt in (("f32 LU", None), ("f64 QR", jnp.float64)):
        jax.block_until_ready(solve(eq, hyper, S, dt))        # compile
        t0 = time.perf_counter()
        w = jax.block_until_ready(solve(eq, hyper, S, dt))
        per = (time.perf_counter() - t0) / R
        w = np.asarray(w)
        if not np.isfinite(w).all():
            raise PhaseFailed(f"{label} Wout not finite")
        err = rel_fro(w, ref)
        say(f"  {label} solve: {per:.3f} s per region")
        if dt is None:
            say(f"  f32 LU Wout rel Frobenius vs f64: {err:.3e} (reported; "
                "f32 LU error grows with the Gram's condition number)")
            ctx["solve_f32_s"] = per
        else:
            check("f64 QR Wout rel Frobenius vs f64 numpy", err, QR_REL_TOL)
            ctx["solve_qr_s"] = per


def onehot_spmv(vals, onehots, x):
    """A x through J one-hot matmuls, as the removed one-hot path did it
    (kept here only as the measured alternative to the gather)."""
    import jax.numpy as jnp
    g = jnp.einsum("rm,jnm->jrn", x, onehots)
    return jnp.einsum("jrn,jrn->rn", vals, g)


def phase_spmv(size, ctx):
    """ESN step of a shared-pattern random graph: one-hot matmuls vs the
    gather (ell_spmv), each checked against a dense HIGHEST matmul."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from speedy_ml_tpu.esn.reservoir import ell_spmv, esn_step

    R = size.n_regions
    res, hyper, I, _, _ = _interior_reservoir(size, jax.random.key(31),
                                              "random", R)
    accel = ctx["accel"]
    res = jax.device_put(res, accel)
    n = res.n
    cols = np.asarray(res.cols)
    J = cols.shape[1]
    oh = np.zeros((J, n, n), np.float32)
    for j in range(J):
        oh[j, np.arange(n), cols[:, j]] = 1.0
    oh = jax.device_put(oh, accel)
    say(f"  {R} regions, n={n}, J={J}; one-hot matrices "
        f"{oh.nbytes / 1e9:.2f} GB")
    k = jax.random.split(jax.random.key(32), 2)
    x = jax.random.uniform(k[0], (R, n), jnp.float32, -1.0, 1.0)
    u = jax.random.normal(k[1], (R, I), jnp.float32)

    step_gather = jax.jit(lambda res, x, u: esn_step(res, x, u))
    step_onehot = jax.jit(lambda res, oh, x, u: jnp.tanh(
        onehot_spmv(res.vals, oh, x) + res.win_apply(u)))
    ms_g = timed_median_ms(lambda: step_gather(res, x, u), size.timing_reps)
    ms_o = timed_median_ms(lambda: step_onehot(res, oh, x, u),
                           size.timing_reps)
    say(f"  ESN step median: gather {ms_g:.3f} ms, one-hot {ms_o:.3f} ms")
    ctx["spmv_ms"] = dict(gather=ms_g, onehot=ms_o)

    D = size.dense_regions
    vals = np.asarray(res.vals)[:, :D]
    dense = np.zeros((D, n, n), np.float32)
    for d in range(D):
        for j in range(J):
            np.add.at(dense[d], (np.arange(n), cols[:, j]), vals[j, d])
    y_ref = np.asarray(jnp.einsum("rij,rj->ri", jax.device_put(dense, accel),
                                  x[:D], precision=jax.lax.Precision.HIGHEST))
    scale = np.abs(y_ref).max()
    y_g = np.asarray(jax.jit(ell_spmv)(res.vals, res.cols, x))[:D]
    y_o = np.asarray(jax.jit(onehot_spmv)(res.vals, oh, x))[:D]
    check("gather A x vs dense HIGHEST, max rel", max_abs(y_g, y_ref) / scale,
          GATHER_REL_TOL)
    check("one-hot A x vs dense HIGHEST, max rel",
          max_abs(y_o, y_ref) / scale, ONEHOT_REL_TOL)


def phase_sharded(size, ctx, n_devices=4):
    """The sharded path over a 1-D mesh of n_devices, against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from speedy_ml_tpu.esn.train import (accumulate_batches, solve_wout,
                                         solve_wout_sharded)
    from speedy_ml_tpu.gcm import GCM
    from speedy_ml_tpu.hybrid.model import HybridAtmosphere
    from speedy_ml_tpu.parallel.halo import halo_exchange_lat, lat_sharding
    from speedy_ml_tpu.parallel.mesh import (make_mesh, region_sharding,
                                             replicated, shard_reservoir)

    if len(jax.devices()) < n_devices:
        raise PhaseFailed(f"{n_devices} devices needed, "
                          f"{len(jax.devices())} visible")
    mesh = make_mesh(n_devices)
    say(f"  mesh: {n_devices} devices {jax.devices()[:n_devices]}")
    gcm = GCM(size.geometry(), dtype=jnp.float32, zonal="dft")
    say(f"  boundary data: {gcm.bc_source}")
    hyb, state = evolving_hybrid(gcm, size)
    args = cycle_args(jnp.float32)
    state, _ = hyb.cycle(state, *args)       # one cycle on one card
    t0 = time.perf_counter()
    ref_state, ref_diag = hyb.cycle(state, *args)
    jax.block_until_ready(ref_state)
    say(f"  one-card reference cycle: {time.perf_counter() - t0:.1f} s")

    put_r = lambda a: jax.device_put(a, region_sharding(mesh, a.ndim))
    rep = lambda a: jax.device_put(a, replicated(mesh))
    hyb.set_mesh(mesh)
    hyb.packs = [p._replace(res=shard_reservoir(p.res, mesh),
                            std=jax.tree_util.tree_map(put_r, p.std))
                 for p in hyb.packs]
    classes = tuple(dataclasses.replace(
        cs, x=put_r(cs.x), feedback=put_r(cs.feedback),
        local_model=put_r(cs.local_model)) for cs in state.classes)
    sh_state = dataclasses.replace(state, classes=classes,
                                   sst_grid=rep(state.sst_grid),
                                   safe=rep(state.safe), step=rep(state.step))
    del state
    for leaf in jax.tree_util.tree_leaves((hyb.params, sh_state)):
        if len(leaf.sharding.device_set) != n_devices:
            raise PhaseFailed(f"array {leaf.shape} lives on "
                              f"{len(leaf.sharding.device_set)} device(s)")
    say(f"  every parameter and state array spans all {n_devices} devices")
    t0 = time.perf_counter()
    new_state, diag = hyb.cycle(sh_state, *args)
    jax.block_until_ready(new_state)
    say(f"  sharded cycle: {time.perf_counter() - t0:.1f} s "
        "(compile included)")
    for k, a, c in atmo_fields(diag, ref_diag):
        check(f"sharded cycle diag {k} max |4 - 1| / max |1|",
              max_abs(a, c) / np.abs(c).max(), CYCLE_ATMO_REL_TOL)
    check("sharded reservoir x max |4 - 1|",
          max(max_abs(a.x, b.x) for a, b in zip(new_state.classes,
                                                 ref_state.classes)),
          CYCLE_X_TOL)
    for i, k in enumerate(("t", "u", "v", "q")):
        a, c = diag["speedy_atmo"][i], ref_diag["speedy_atmo"][i]
        say(f"  sharded speedy forecast {k}: rms |4 - 1| "
            f"{float(np.sqrt(np.mean((np.asarray(a, np.float64) - c) ** 2))):.3e}")
        check(f"sharded speedy forecast {k} max |4 - 1|", max_abs(a, c),
              SHARD_FORECAST_TOL[k])
    if not bool(new_state.safe):
        raise PhaseFailed("sharded cycle unsafe")
    mem = HybridAtmosphere._cycle_jit.lower(
        hyb, hyb.params, sh_state, *args, None,
        jnp.asarray(0.0, jnp.float32), (None, None), False, False, 1,
        True).compile().memory_analysis()
    if mem is not None:
        say(f"  per-device bytes (memory_analysis): arguments "
            f"{mem.argument_size_in_bytes / 1e9:.3f} GB, outputs "
            f"{mem.output_size_in_bytes / 1e9:.3f} GB, temporaries "
            f"{mem.temp_size_in_bytes / 1e9:.3f} GB")

    # one training step of the interior class, regions sharded vs one card
    Rt = 2 * n_devices
    res, hyper, I, O, S = _interior_reservoir(size, jax.random.key(41),
                                              "shift", Rt)
    T = 64
    k = jax.random.split(jax.random.key(42), 3)
    z = 0.5 * jax.random.normal(k[0], (T, Rt, I), jnp.float32)
    tg = jax.random.normal(k[1], (T, Rt, O), jnp.float32)
    mdl = jax.random.normal(k[2], (T, Rt, S), jnp.float32)
    x0 = jnp.zeros((Rt, res.n), jnp.float32)

    @functools.partial(jax.jit, static_argnames=("mesh",))
    def train_step(res, z, tg, mdl, x0, mesh=None):
        eq, _ = accumulate_batches(res, hyper, z, tg, mdl, x0, batch_size=8)
        if mesh is None:
            return eq, solve_wout(eq, hyper, S)
        return eq, solve_wout_sharded(eq, hyper, S, mesh=mesh)

    dev0 = jax.devices()[0]
    eq1, w1 = train_step(*jax.device_put((res, z, tg, mdl, x0), dev0))
    shard_t = NamedSharding(mesh, P(None, "regions", None))
    sres = shard_reservoir(res, mesh)
    eq4, w4 = train_step(sres, jax.device_put(z, shard_t),
                         jax.device_put(tg, shard_t),
                         jax.device_put(mdl, shard_t), put_r(x0), mesh=mesh)
    say(f"  training step: {Rt} regions, A = {S + res.n}, {T} samples")
    check("sharded Gram rel Frobenius |4 - 1|", rel_fro(eq4.ss, eq1.ss),
          SHARD_GRAM_REL_TOL)
    check("sharded Wout rel Frobenius |4 - 1|", rel_fro(w4, w1),
          SHARD_WOUT_REL_TOL)

    # the ppermute ring halo exchange of a lat-sharded field
    f = np.asarray(gcm.bd.sst12[0], np.float32)
    out = np.asarray(halo_exchange_lat(
        jax.device_put(f, lat_sharding(mesh, 2)), 1, mesh))
    band = f.shape[0] // n_devices
    zero = np.zeros((1, f.shape[1]), np.float32)
    want = np.concatenate([np.concatenate([
        f[d * band - 1:d * band] if d > 0 else zero,
        f[d * band:(d + 1) * band],
        f[(d + 1) * band:(d + 1) * band + 1] if d < n_devices - 1 else zero])
        for d in range(n_devices)])
    if not np.array_equal(out, want):
        raise PhaseFailed("halo exchange rows differ from the expected "
                          "neighbour rows")
    say(f"  ppermute halo exchange: {n_devices} bands of {band} rows + 1-row "
        "halos, exact")


PHASES = dict(device=phase_device, gcm=phase_gcm, cycle=phase_cycle,
              train_predict=phase_train_predict, solve=phase_solve,
              spmv=phase_spmv)


def run_phases(names, size, ctx, n_devices=1):
    """Run phases in order, stopping at the first failure; returns True
    if all passed."""
    for name in names:
        say(f"[{name}]")
        t0 = time.perf_counter()
        try:
            if name == "sharded":
                phase_sharded(size, ctx, n_devices)
            else:
                PHASES[name](size, ctx)
        except Exception as e:       # report and stop the run
            import traceback
            traceback.print_exc()
            say(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
                f"{type(e).__name__}: {e}")
            return False
        finally:
            gc.collect()
        say(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    return True


def make_ctx(require_gpu):
    import jax

    from speedy_ml_tpu.runtime.jax_setup import host_device
    return dict(require_gpu=require_gpu, accel=jax.devices()[0],
                host=host_device())


def rehearse(phases=ONE_CARD_PHASES, n_devices=1, size=TINY):
    """Run phases at `size` on whatever backend is present (no GPU
    required); raises on the first failure.  Never prints the ok line."""
    ctx = make_ctx(require_gpu=False)
    names = ["sharded"] if n_devices > 1 else list(phases)
    if not run_phases(names, size, ctx, n_devices=n_devices):
        raise PhaseFailed("rehearsal failed")
    return ctx


def gpu_present() -> bool:
    import jax
    try:
        return jax.default_backend() == "gpu"
    except RuntimeError:
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase over four cards")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not gpu_present():
        print("chip_smoke: no GPU found by JAX (backend "
              f"{_backend_name()}); this script measures the card only",
              file=sys.stderr)
        return 1
    import jax

    from speedy_ml_tpu.runtime.jax_setup import enable_compile_cache
    say(f"compile cache: {enable_compile_cache()}")
    ctx = make_ctx(require_gpu=True)
    names = (["device", "sharded"] if args.devices > 1
             else list(ONE_CARD_PHASES))
    ok = run_phases(names, PRODUCTION, ctx, n_devices=args.devices)
    say(f"total {time.perf_counter() - t_start:.1f} s; card: "
        f"{ctx.get('card', 'unknown')}")
    if not ok:
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": args.devices}}), flush=True)
    return 0


def _backend_name():
    try:
        import jax
        return jax.default_backend()
    except Exception as e:
        return f"unavailable: {e}"


if __name__ == "__main__":
    sys.exit(main())
