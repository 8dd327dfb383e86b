"""Hybrid-skill experiment (VERDICT r1 #3): does the reservoir
correction beat the pure (imperfect) SPEEDY forecast?

Self-contained twin-experiment protocol:
- TRUTH: the GCM with the true boundary climatology (nature run);
- IMPERFECT MODEL: the same GCM with systematically wrong boundaries
  (+3 K SSTs, doubled land albedo) — a stand-in for SPEEDY-vs-ERA5
  model error;
- training pairs: truth snapshots vs the imperfect model's 6-h
  forecasts launched from truth (read_model_states protocol);
- evaluation: 14-day free-running forecasts from held-out ICs, hybrid
  vs pure imperfect SPEEDY, area-weighted T RMSE vs truth.

Usage: python scripts/skill_experiment.py [n_train] [m]
Writes one JSON line with the RMSE table.
"""
import sys, time, dataclasses
sys.path.insert(0, "/root/repo")
import jax, jax.numpy as jnp, numpy as np
from speedy_ml_tpu.core import Geometry, PhysicalConstants
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.data.calendar import ModelDate
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.esn.domain import RegionLayout
from speedy_ml_tpu.esn.reservoir import ESNHyper
from speedy_ml_tpu.hybrid.training import (generate_nature_run,
                                           make_imperfect_forecasts)
from speedy_ml_tpu.hybrid.chunked import ArraySource, train_hybrid_production
from speedy_ml_tpu.physics.boundaries import synthetic_boundary_data

t_all = time.time()
geom = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)
DT = jnp.float32
sht = SpectralTransform(geom, dtype=DT)
bd_true = synthetic_boundary_data(geom, sht)
# imperfect model: systematically biased SSTs (+3 K) and doubled albedo
bd_imp = dataclasses.replace(bd_true, sst12=bd_true.sst12 + 3.0,
                             stl12=bd_true.stl12 + 3.0,
                             alb0=bd_true.alb0 * 2.0)
gcm_true = GCM(geom, PhysicalConstants(), dtype=DT, bd=bd_true)
gcm_imp = GCM(geom, PhysicalConstants(), dtype=DT, bd=bd_imp)
layout = RegionLayout(geom, n_regions=128, overlap=1)

import json
N = int(sys.argv[1]) if len(sys.argv) > 1 else 400            # training samples (100 days of 6-h)
date0 = ModelDate(1990, 1, 1)
t0 = time.time()
truth, snaps, dates = generate_nature_run(gcm_true, date0, N + 60,
                                          spinup_days=20)
print("nature run:", time.time() - t0)
t0 = time.time()
model = make_imperfect_forecasts(gcm_imp, truth, dates)
print("imperfect forecasts:", time.time() - t0)

train_truth = {k: v[:N] for k, v in truth.items()}
train_model = {k: v[:N] for k, v in model.items()}
M = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
hyper = ESNHyper(m=M, deg=6, noise_mag=0.2)
t0 = time.time()
src = ArraySource({k: np.asarray(v) for k, v in train_truth.items()},
                  {k: np.asarray(v) for k, v in train_model.items()})
hyb = train_hybrid_production(gcm_imp, layout, src, hyper,
                              jax.random.key(0), hybrid=True,
                              region_chunk=48, time_chunk=128, dtype=DT)
print("train:", time.time() - t0)

# ---- evaluate: 14-day forecasts from 2 held-out ICs ----
# all device work jitted; all verification math in numpy on host
from speedy_ml_tpu.hybrid.driver import run_prediction
NCYC = 56
sync_len = 24
w = np.cos(geom.lat_radians)[:, None]

def np_rmse(a, b):
    return float(np.sqrt((w * (a - b) ** 2).sum() / (w.sum() * geom.nlon)))

@jax.jit
def baseline_init(atmo, logp):
    spec, _ = hyb.inject_to_speedy(atmo, logp)
    return spec

@jax.jit
def baseline_extract(state):
    sp = state.spectral
    return gcm_imp.sht.spec_to_grid(sp.t[0])

results = []
for ic in (N + 10, N + 40):
    sync = {k: v[ic - sync_len:ic] for k, v in truth.items()}
    model_next = dict(atmo=model["atmo"][ic], logp=model["logp"][ic])
    hstate = hyb.start_prediction(sync, model_next,
                                  jnp.asarray(truth["sst"][ic - 1]))
    d = dates[ic]
    st = hstate
    spec = baseline_init(jnp.asarray(truth["atmo"][ic - 1]),
                         jnp.asarray(truth["logp"][ic - 1]))
    state_imp, forcing = gcm_imp.init_state(dates[ic - 1], spectral=spec)
    state_imp = gcm_imp.stepone(state_imp, forcing)
    dd = dates[ic - 1]
    errs_h, errs_s = [], []
    for c in range(NCYC):
        st, diag = hyb.cycle(st, jnp.asarray(d.month - 1),
                             jnp.asarray(d.tmonth, dtype=DT),
                             jnp.asarray(d.tyear, dtype=DT))
        forcing = gcm_imp.forcing_for(state_imp.sfc, dd.tyear)
        state_imp = gcm_imp.run_window(state_imp, forcing, 6 * 96 // 24)
        dd = dd.advance_hours(6)
        d = d.advance_hours(6)
        k = ic + c
        if k >= truth["atmo"].shape[0]:
            break
        tr = np.asarray(truth["atmo"][k][0])
        th = np.asarray(diag["atmo"][0])
        ts = np.asarray(baseline_extract(state_imp))
        errs_h.append(np_rmse(th, tr))
        errs_s.append(np_rmse(ts, tr))
    eh, es = np.array(errs_h), np.array(errs_s)
    results.append((eh, es))
    print(f"IC {ic}: n={len(eh)} day1 T-rmse hyb {eh[3]:.3f} spd {es[3]:.3f} | "
          f"day3 {eh[min(11,len(eh)-1)]:.3f}/{es[min(11,len(eh)-1)]:.3f} | "
          f"last {eh[-1]:.3f}/{es[-1]:.3f} | mean {eh.mean():.3f}/{es.mean():.3f}")
summary = dict(metric="hybrid_vs_speedy_t_rmse",
               n_train=N, m=M,
               hybrid_mean=float(np.mean([r[0].mean() for r in results])),
               speedy_mean=float(np.mean([r[1].mean() for r in results])),
               hybrid_day1=float(np.mean([r[0][3] for r in results])),
               speedy_day1=float(np.mean([r[1][3] for r in results])),
               wall_s=round(time.time() - t_all, 1))
print(json.dumps(summary))
