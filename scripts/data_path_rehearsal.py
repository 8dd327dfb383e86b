"""Production-shaped data-path rehearsal (VERDICT r3 #5).

Writes TWO years (1992 leap + 1993) of HOURLY pseudo-ERA5 year files in
the data.era layout (8784/8760 records, T30 96x48x8, all eight
variables) plus 6-hourly SPEEDY forecast-state year files in the
data.model_states layout, then drives `speedy_ml_tpu.main run`
(train -> checkpoint -> predict -> stream) and `main plot` end-to-end
from a RunConfig pointing at those files — the full config-driven file
path: hourly strided sub-series (stride=6), model-state pairing, slab
ocean, Feb-29 splice, checkpoint round-trip, prediction stream, figures.

The hourly fields are time-interpolated from the cached twin nature run
(real-GCM truth + imperfect 6-h forecasts), so they are physically
plausible and the trained hybrid stays inside the safety gate.

Match: speedy_res_interface.f90:439-632 (read_era year loop + splice),
634-720 (read_model_states).

Runs on the host CPU; the CLI surface is identical on the GPU.  Writes
DATA_PATH_REHEARSAL.json.
"""

import json
import os
import shutil
import sys
import time

sys.path.insert(0, "/root/repo")

import jax

jax.config.update("jax_platforms", "cpu")

import h5py
import numpy as np

T0 = time.time()
mark = lambda m: print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)

ROOT = "/root/repo/output/rehearsal"
DATA = f"{ROOT}/era"
N6 = 4400
CACHE = f"/root/repo/output/skill_twin_N{N6}_v2_refbin.npz"
if not os.path.exists(CACHE):
    raise SystemExit(f"missing {CACHE}")

os.makedirs(DATA, exist_ok=True)

YEARS = (1992, 1993)            # 1992 is a leap year -> 8784-hour file
HPY = {1992: 8784, 1993: 8760}
FEB29 = 59 * 24

mark("loading twin cache (6-hourly truth + model forecasts)")
z = np.load(CACHE)
truth = {k[2:]: z[k] for k in z.files if k.startswith("t_")}
model = {k[2:]: z[k] for k in z.files if k.startswith("m_")}
K, NY, NX = truth["atmo"].shape[2:]

ERA_DSET = {"t": "Temperature", "u": "U-wind", "v": "V-wind",
            "q": "Specific-Humidity", "logp": "logp", "tisr": "tisr",
            "sst": "sst", "precip": "tp"}


def hourly_of(arr6, h0, hours):
    """Linear time interpolation of a 6-hourly series to hourly samples
    [h0, h0+hours) on the spliced (365-day) timeline."""
    h = h0 + np.arange(hours)
    i = h // 6
    w = (h % 6) / 6.0
    i1 = np.minimum(i + 1, arr6.shape[0] - 1)
    extra = (1,) * (arr6.ndim - 1)
    w = w.reshape((-1,) + extra).astype(np.float32)
    return arr6[i] * (1 - w) + arr6[i1] * w


def write_year_spliced(year, yi):
    path = f"{DATA}/era_5_y{year}_regridded_mpi_fixed_var_gcc.nc"
    n_h = HPY[year]
    leap = n_h == 8784
    mark(f"writing {path} ({n_h} hourly records)")
    with h5py.File(path, "w") as f:
        dsets = {}
        for k, name in ERA_DSET.items():
            shape = ((n_h, K, NY, NX) if k in ("t", "u", "v", "q")
                     else (n_h, NY, NX))
            dsets[k] = f.create_dataset(name, shape, dtype=np.float32)

        def file_slices(s0, s1):
            """Map spliced-hour range [s0, s1) to file ranges."""
            if not leap:
                return [(s0, s1, s0)]
            out = []
            if s0 < FEB29:
                hi = min(s1, FEB29)
                out.append((s0, hi, s0))
            if s1 > FEB29:
                lo = max(s0, FEB29)
                out.append((lo, s1, lo + 24))
            return out

        for start in range(0, 8760, 730):
            chunk_a = hourly_of(truth["atmo"], yi * 8760 + start, 730)
            chunk_2d = {k: hourly_of(truth[k], yi * 8760 + start, 730)
                        for k in ("logp", "tisr", "sst", "precip")}
            for (s0, s1, f0) in file_slices(start, start + 730):
                lo, hi = s0 - start, s1 - start
                for vi, k in enumerate(("t", "u", "v", "q")):
                    v = chunk_a[lo:hi, vi]
                    if k == "q":
                        v = v / 1000.0
                    dsets[k][f0:f0 + (hi - lo)] = v
                for k, a in chunk_2d.items():
                    dsets[k][f0:f0 + (hi - lo)] = a[lo:hi]
        if leap:
            for k in ERA_DSET:
                dsets[k][FEB29:FEB29 + 24] = dsets[k][FEB29 - 24:FEB29]


def write_states(year, yi):
    """Hourly model-state records: the reference's restart_6hour files
    hold one 6-h-forecast record PER HOUR (read_model_states fills the
    full hourly axis, speedy_res_interface.f90:690-716), indexed by the
    same strided sub-series loop as the truth."""
    from speedy_ml_tpu.data.model_states import write_model_states
    path = f"{DATA}/restart_6hour_y{year}.nc"
    mark(f"writing {path} (8760 hourly records)")
    atmo_h = hourly_of(model["atmo"], yi * 8760, 8760)
    logp_h = hourly_of(model["logp"], yi * 8760, 8760)
    write_model_states(path, atmo_h, logp_h, hours_per_record=1)


for yi, year in enumerate(YEARS):
    if not os.path.exists(f"{DATA}/era_5_y{year}_regridded_mpi_fixed"
                          f"_var_gcc.nc"):
        write_year_spliced(year, yi)
    if not os.path.exists(f"{DATA}/restart_6hour_y{year}.nc"):
        write_states(year, yi)

# ----------------------------------------------------------- the config
from speedy_ml_tpu.config import RunConfig
from speedy_ml_tpu.esn.reservoir import ESNHyper

cfg = RunConfig(
    start_year=1992,
    era_path=DATA, model_states_path=DATA,
    training_hours=2400, discard_hours=60,
    sync_hours=7 * 24, prediction_hours=240,
    atmo=ESNHyper(m=512, deg=6, noise_mag=0.2, beta_res=0.05),
    ocean=ESNHyper(m=256, sigma=0.6, beta_res=0.01, noise_mag=0.10,
                   using_prior=False),
    slab_ocean=True, timestep_slab_hours=168,
    output_path=f"{ROOT}/out", checkpoint_path=f"{ROOT}/ckpt",
    n_batches=6)
os.makedirs(f"{ROOT}/out", exist_ok=True)
CFG = f"{ROOT}/config.json"
cfg.save(CFG)
mark(f"config -> {CFG}")

# ------------------------------------------------- drive the CLI surface
from speedy_ml_tpu.main import main as cli

mark("`main run` (train from year files -> checkpoint -> predict)")
t0 = time.time()
# predict() in `run` mode starts from year0 = 1992 (the file epoch)
import speedy_ml_tpu.main as M

rc = cli(["run", CFG])
assert rc in (0, None), rc
wall_run = time.time() - t0

mark("`main plot` (figures from the stream)")
rc = cli(["plot", CFG])
assert rc in (0, None), rc

# ------------------------------------------------------------ validation
from speedy_ml_tpu.analysis import load_prediction

pred = load_prediction(f"{ROOT}/out/prediction.npz")
n_cyc = pred["atmo"].shape[0]
finite = all(np.isfinite(v).all() for v in pred.values())
figs = sorted(os.listdir(f"{ROOT}/out/figures"))
ckpt_ok = os.path.isdir(f"{ROOT}/ckpt")

result = dict(
    era_years=list(YEARS), hourly_records={str(y): HPY[y] for y in YEARS},
    leap_splice="Feb 29 present in 1992 file, spliced by reader",
    training_hours=cfg.training_hours, stride=6,
    m=cfg.atmo.m, slab_ocean=True,
    prediction_cycles=n_cyc, prediction_finite=bool(finite),
    checkpoint=ckpt_ok, figures=figs,
    time_means=os.path.exists(f"{ROOT}/out/time_means.npz"),
    run_wall_s=round(wall_run, 1), platform="cpu",
    total_wall_s=round(time.time() - T0, 1))
with open("/root/repo/DATA_PATH_REHEARSAL.json", "w") as f:
    json.dump(result, f, indent=1, allow_nan=False)
mark("DATA_PATH_REHEARSAL.json written")
print(json.dumps(result, indent=1))
assert finite and n_cyc == cfg.prediction_hours // 6 and figs
