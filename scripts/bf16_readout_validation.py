"""Validate the bf16-readout perf mode on TRAINED weights (not just the
unit precision bound): run the same free forecasts with f32 and
bf16-cast Wout from the climate-run checkpoint and compare T-RMSE
trajectories vs the nature-run truth.

Writes BF16_READOUT_VALIDATION.json.  Gate for making bf16 the bench
default: mean absolute RMSE curve difference << the hybrid-vs-SPEEDY
skill separation.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.runtime.jax_setup import enable_compile_cache
enable_compile_cache()

from speedy_ml_tpu.core import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.data.calendar import ModelDate
from speedy_ml_tpu.data.checkpoint import load_hybrid
from speedy_ml_tpu.esn.domain import RegionLayout
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.physics.boundaries import (load_boundary_data,
                                              synthetic_boundary_data)

T0 = time.time()
mark = lambda m: print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)

M = int(os.environ.get("CLIMATE_M", "3000"))
N = int(os.environ.get("CLIMATE_N", "8760"))
CKPT = f"/root/repo/output/climate/hybrid_m{M}_N{N}.ckpt"
CACHE = f"/root/repo/output/skill_twin_N{N}_v2_refbin.npz"
for p in (CKPT, CACHE):
    if not os.path.exists(p):
        raise SystemExit(f"missing {p}; run scripts/climate_run.py first")

geom = Geometry()
DT = jnp.float32
sht = SpectralTransform(geom, dtype=DT)
try:
    bd_true = load_boundary_data(geom, sht, path="/root/reference/bin")
except (FileNotFoundError, OSError):
    bd_true = synthetic_boundary_data(geom, sht)
bd_imp = dataclasses.replace(bd_true, sst12=bd_true.sst12 + 3.0,
                             stl12=bd_true.stl12 + 3.0,
                             alb0=bd_true.alb0 * 2.0)
gcm = GCM(geom, dtype=DT, bd=bd_imp)
layout = RegionLayout(geom, n_regions=1152, overlap=1)

mark("loading twin cache + checkpoint")
z = np.load(CACHE)
truth = {k[2:]: z[k] for k in z.files if k.startswith("t_")}
model = {k[2:]: z[k] for k in z.files if k.startswith("m_")}

w = np.cos(geom.lat_radians)[:, None]
rmse = lambda a, b: float(np.sqrt((w * (a - b) ** 2).sum()
                                  / (w.sum() * geom.nlon)))

dates = [ModelDate(1990, 1, 1).advance_hours(30 * 24)]
for _ in range(truth["atmo"].shape[0] - 1):
    dates.append(dates[-1].advance_hours(6))

SYNC, NCYC = 24, 56
ICS = [N + 32, N + 80]
results = {}
for mode in ("f32", "bf16"):
    hyb = load_hybrid(gcm, layout, CKPT, dtype=DT)
    if mode == "bf16":
        hyb.cast_wout_bf16()
    curves = []
    for ic in ICS:
        sync = {k: v[ic - SYNC:ic] for k, v in truth.items()}
        st = hyb.start_prediction(
            sync, dict(atmo=model["atmo"][ic], logp=model["logp"][ic]),
            jnp.asarray(truth["sst"][ic - 1]))
        d = dates[ic]
        errs = []
        for c in range(NCYC):
            st, diag = hyb.cycle(st, jnp.asarray(d.month - 1),
                                 jnp.asarray(d.tmonth, dtype=DT),
                                 jnp.asarray(d.tyear, dtype=DT))
            d = d.advance_hours(6)
            k = ic + c
            if k >= truth["atmo"].shape[0]:
                break
            errs.append(rmse(np.asarray(diag["atmo"][0]),
                             np.asarray(truth["atmo"][k][0])))
        if not np.isfinite(errs).all():
            raise SystemExit(f"ABORT: non-finite RMSE in {mode}")
        curves.append(errs)
        mark(f"[{mode}] IC {ic}: day1 {errs[3]:.3f} day7 {errs[27]:.3f} "
             f"day14 {errs[-1]:.3f}")
    results[mode] = np.mean(curves, axis=0)

diff = np.abs(results["bf16"] - results["f32"])
out = dict(
    m=M, n_train=N, n_ic=len(ICS), n_cycles=NCYC,
    lead_days=[(i + 1) / 4 for i in range(len(results["f32"]))],
    rmse_f32=results["f32"].tolist(),
    rmse_bf16=results["bf16"].tolist(),
    mean_abs_diff=float(diff.mean()),
    max_abs_diff=float(diff.max()),
    mean_rmse_f32=float(results["f32"].mean()),
    mean_rmse_bf16=float(results["bf16"].mean()),
    rel_mean_diff=float(diff.mean() / results["f32"].mean()))
with open("/root/repo/BF16_READOUT_VALIDATION.json", "w") as f:
    json.dump(out, f, indent=1, allow_nan=False)
mark("BF16_READOUT_VALIDATION.json written")
print(json.dumps({k: v for k, v in out.items()
                  if not isinstance(v, list)}, indent=1))
