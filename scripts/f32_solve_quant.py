"""Quantify the f32 ridge solve against an f64 CPU oracle at the
production Gram shape (VERDICT r3 #3).

Builds REAL normal equations at A = S + n ~ 6,100 (m=6000) for a slice
of interior regions from the cached twin training data (N=4400 6-h
samples), then compares solve_wout's f32 path (Jacobi-preconditioned
LU, esn/train.py:194-260) against a full-f64 numpy solve of the same
system, across beta_res in {0.05, 0.01, 0.001} (ours vs the reference's
mod_reservoir.f90:89-101 value).

Reported per beta:
- wout_rel_fro: ||W32 - W64||_F / ||W64||_F
- wout_rel_max: max_i |W32 - W64|_i / max|W64|
- readout_rel_rms: relative RMS difference of readout outputs on 256
  held-out reservoir states (the error that actually reaches the model)
- cond proxy: min/max Jacobi-normalized Gram eigenvalue bounds via the
  diagonal and residual norms.

Writes F32_SOLVE_QUANT.json.  Match:
/root/reference/src/mod_reservoir.f90:1233-1332, mod_linalg.f90:109-151.

Usage: python scripts/f32_solve_quant.py [n_regions=8] [m=6000]
"""

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
from speedy_ml_tpu.esn.domain import RegionLayout
from speedy_ml_tpu.esn.reservoir import ESNHyper, generate, radius_by_lat
from speedy_ml_tpu.esn.train import NormalEq, solve_wout
from speedy_ml_tpu.hybrid.chunked import (ArraySource, _chunk_accumulators,
                                          gather_pack_inputs,
                                          streaming_standardizer)
from speedy_ml_tpu.hybrid.training import NVAR

T0 = time.time()
mark = lambda m: print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)

RT = int(sys.argv[1]) if len(sys.argv) > 1 else 8
M = int(sys.argv[2]) if len(sys.argv) > 2 else 6000
N = 4400
CACHE = f"/root/repo/output/skill_twin_N{N}_v2_refbin.npz"
if not os.path.exists(CACHE):
    raise SystemExit(f"missing twin cache {CACHE}; run the skill "
                     "experiment or climate_run stage A first")

mark("loading twin cache")
z = np.load(CACHE)
truth = {k[2:]: z[k][:N] for k in z.files if k.startswith("t_")}
model = {k[2:]: z[k][:N] for k in z.files if k.startswith("m_")}
src = ArraySource(truth, model)

geom = Geometry()
layout = RegionLayout(geom, n_regions=1152, overlap=1)
cls = layout.classes[1]
nz = geom.nlev
hyper = ESNHyper(m=M, deg=6, noise_mag=0.2, beta_res=0.05)

mark("streaming standardizer over the class")
std = streaming_standardizer(layout, cls, src, nz, time_chunk=256)

lat_s = layout.lat_start[cls.region_ids[:RT]]
lat_e = layout.lat_end[cls.region_ids[:RT]]
radius = radius_by_lat(lat_s, lat_e)
I = std.in_mean.shape[1]
cols, vals, win, shifts = generate(jax.random.key(7), RT, I, hyper, radius,
                                   dtype=jnp.float32)
n = vals.shape[2]
xc, yc = cls.core_shape
O = NVAR * nz * xc * yc + 2 * xc * yc
S = O - xc * yc
A = S + n
mark(f"A = {A} (n={n}, S={S}); accumulating Gram over N={N} samples, "
     f"{RT} regions")

iy = jnp.asarray(cls.iy_in[:RT])
ix = jnp.asarray(cls.ix_in[:RT])
iyc = jnp.asarray(cls.iy_core[:RT])
ixc = jnp.asarray(cls.ix_core[:RT])
in_mean, in_std = std.in_mean[:RT], std.in_std[:RT]
out_mean, out_std = std.out_mean[:RT], std.out_std[:RT]


@jax.jit
def prep(chunk_truth, chunk_model):
    series = gather_pack_inputs(chunk_truth, iy, ix, 0.001, jnp.float32)
    C, Rch = series.shape[:2]
    zin = (series - in_mean) / in_std
    target = layout.input_to_target(
        cls, zin.reshape(C * Rch, -1), NVAR, nz, nz, 0,
        logp=True, precip=True, sst=True, tisr=True).reshape(C, Rch, -1)
    mc = RegionLayout.gather_patches(chunk_model["atmo"], iyc, ixc)
    mc = jnp.transpose(mc, (1, 0, 3, 4, 5, 2))
    mparts = [mc.reshape(C, Rch, -1)]
    lp = RegionLayout.gather_patches(chunk_model["logp"], iyc, ixc)
    mparts.append(jnp.moveaxis(lp, 0, 1).reshape(C, Rch, -1))
    mser = jnp.concatenate(mparts, axis=2).astype(jnp.float32)
    zm = (mser - out_mean[None, :, :S]) / out_std[None, :, :S]
    return zin, target, zm


advance, accumulate = _chunk_accumulators(hyper, shifts, I,
                                          cols=None if shifts is not None
                                          else cols)
x = jnp.zeros((RT, n), jnp.float32)
ss = jnp.zeros((RT, A, A), jnp.float32)
st = jnp.zeros((RT, O, A), jnp.float32)
TCH = 256
n_discard = 10
pos = 0
while pos < N:
    idx = np.arange(pos, min(pos + TCH, N))
    tch = {k: jnp.asarray(v[idx]) for k, v in truth.items()}
    mch = {k: jnp.asarray(v[idx]) for k, v in model.items()}
    zin, target, zm = prep(tch, mch)
    if pos == 0:
        x = advance(vals, win, x, zin[:n_discard])
        x, ss, st = accumulate(vals, win, x, ss, st, zin[n_discard:],
                               target[n_discard:], zm[n_discard:])
    else:
        x, ss, st = accumulate(vals, win, x, ss, st, zin, target, zm)
    pos += len(idx)
    if pos % 1024 < TCH:
        mark(f"  accumulated {pos}/{N}")
jax.block_until_ready(ss)
t_acc = time.time() - T0
mark(f"Gram done ({t_acc:.0f}s); pulling to host (f64 oracle)")
ss_h = np.asarray(ss, dtype=np.float64)
st_h = np.asarray(st, dtype=np.float64)


def solve_f64(ssr, str_, beta_res, beta_model=1.0, prior=0.0,
              using_prior=True):
    """The reference's exact solve in f64: ridge + DGESV
    (mod_reservoir.f90:1233-1332, mod_linalg.f90:109-151)."""
    A_ = ssr.shape[0]
    bm = beta_model ** 2 if using_prior else beta_model
    br = beta_res ** 2 if using_prior else beta_res
    ridge = np.where(np.arange(A_) < S, bm, br)
    lhs = ssr + np.diag(ridge)
    rhs = str_.copy()
    if using_prior and prior != 0.0 and S > 0:
        k = min(S, rhs.shape[0])
        rhs[np.arange(k), np.arange(k)] += prior * beta_model ** 2
    return np.linalg.solve(lhs, rhs.T).T


# held-out reservoir states for the functional error: the final x of the
# accumulation (quad-expanded) + the last model vector
from speedy_ml_tpu.esn.reservoir import quad_expand

xq = np.asarray(quad_expand(x), dtype=np.float64)            # (RT, n)
aug = np.concatenate([np.asarray(zm[-1], dtype=np.float64), xq], axis=1)

results = {}
for beta in (0.05, 0.01, 0.001):
    hb = ESNHyper(m=M, deg=6, noise_mag=0.2, beta_res=beta)
    t1 = time.time()
    w32 = np.asarray(solve_wout(NormalEq(ss=ss, st=st), hb, n_speedy=S),
                     dtype=np.float64)
    t32 = time.time() - t1
    t1 = time.time()
    w64 = np.stack([solve_f64(ss_h[r], st_h[r], beta)
                    for r in range(RT)])
    t64 = time.time() - t1
    dw = w32 - w64
    rel_fro = float(np.linalg.norm(dw) / np.linalg.norm(w64))
    rel_max = float(np.abs(dw).max() / np.abs(w64).max())
    y32 = np.einsum("roa,ra->ro", w32, aug)
    y64 = np.einsum("roa,ra->ro", w64, aug)
    ro_rel = float(np.linalg.norm(y32 - y64) / np.linalg.norm(y64))
    results[f"beta_{beta}"] = dict(
        wout_rel_fro=rel_fro, wout_rel_max=rel_max,
        readout_rel_rms=ro_rel,
        wout_absmax_f64=float(np.abs(w64).max()),
        wout_absmax_f32=float(np.abs(w32).max()),
        solve_s_f32=round(t32, 1), solve_s_cpu_f64=round(t64, 1),
        device=str(jax.devices()[0]))
    mark(f"beta={beta}: fro {rel_fro:.3e} max {rel_max:.3e} "
         f"readout {ro_rel:.3e} |W|max f64 {np.abs(w64).max():.3e}")

diag = np.diagonal(ss_h, axis1=1, axis2=2)
out = dict(m=M, n=int(n), A=int(A), S=int(S), n_regions=RT,
           n_train=N, noise_mag=0.2,
           gram_diag_min=float(diag.min()), gram_diag_max=float(diag.max()),
           accumulate_wall_s=round(t_acc, 1),
           betas=results,
           verdict=("f32 solve is adequate when the squared ridge "
                    "stays above the f32 Gram noise floor; see per-beta "
                    "numbers"))
with open("/root/repo/F32_SOLVE_QUANT.json", "w") as f:
    json.dump(out, f, indent=1, allow_nan=False)
mark("F32_SOLVE_QUANT.json written")
print(json.dumps(out, indent=1))
