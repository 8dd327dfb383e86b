"""Training-throughput benchmark at PRODUCTION scale on one device.

The reference's core job: train 1,152 regions x m=6000 reservoirs on
~26 years of data ("40 minutes to a day" on a CPU cluster,
/root/reference/README.md:21).  This measures the chunked trainer
(hybrid/chunked.py) at the full production geometry — T30 grid, all
region classes, m=6000 (n=5760, A=5892 normal-equation dim) — streaming
synthetic truth through region chunks sized to HBM, and reports
region-pairs/s plus the extrapolated wall-clock for the reference's full
configured run (227,760 h / 6 h = 37,960 samples).

Usage: python scripts/bench_training.py [n_samples] [region_chunk]
"""

import json
import sys
import time

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.core import Geometry
from speedy_ml_tpu.esn.domain import RegionLayout
from speedy_ml_tpu.esn.reservoir import ESNHyper
from speedy_ml_tpu.hybrid.chunked import ArraySource, train_class_production

T = int(sys.argv[1]) if len(sys.argv) > 1 else 160
REGION_CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 32
TIME_CHUNK = 128
N_DISCARD = 16

GEOM = Geometry()          # T30: 96x48x8
NZ = GEOM.nlev


def synth_truth(seed, T, nlat, nlon, nz):
    rng = np.random.Generator(np.random.Philox(seed))
    f32 = np.float32
    atmo = np.stack([
        rng.uniform(220, 290, (T, nz, nlat, nlon)).astype(f32),
        rng.uniform(-30, 30, (T, nz, nlat, nlon)).astype(f32),
        rng.uniform(-20, 20, (T, nz, nlat, nlon)).astype(f32),
        rng.uniform(0, 12, (T, nz, nlat, nlon)).astype(f32)], axis=1)
    return dict(
        atmo=atmo,
        logp=rng.uniform(-0.1, 0.1, (T, nlat, nlon)).astype(f32),
        precip=rng.uniform(0, 2e-4, (T, nlat, nlon)).astype(f32),
        sst=rng.uniform(271, 302, (T, nlat, nlon)).astype(f32),
        tisr=rng.uniform(0, 420, (T, nlat, nlon)).astype(f32))


def main():
    from speedy_ml_tpu.runtime.jax_setup import enable_compile_cache
    enable_compile_cache()
    layout = RegionLayout(GEOM, n_regions=1152, overlap=1)
    truth = synth_truth(0, T, GEOM.nlat, GEOM.nlon, NZ)
    model = dict(atmo=truth["atmo"] + 0.1, logp=truth["logp"])
    src = ArraySource(truth, model)
    hyper = ESNHyper(m=6000, deg=6, noise_mag=0.2)

    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    t0 = time.time()
    total_regions = 0
    for i, cls in enumerate(layout.classes):
        tc0 = time.time()
        pack = train_class_production(
            layout, cls, src, hyper, jax.random.fold_in(jax.random.key(5), i),
            NZ, region_chunk=REGION_CHUNK, time_chunk=TIME_CHUNK,
            n_discard=N_DISCARD)
        jax.block_until_ready(pack.res.wout)
        total_regions += cls.count
        print(f"class {cls.name}: {cls.count} regions, n={pack.res.n}, "
              f"A={pack.res.wout.shape[2]}, {time.time()-tc0:.1f}s",
              file=sys.stderr)
    wall = time.time() - t0

    pairs = T - N_DISCARD
    rps = pairs * total_regions / wall
    # full production: 26 y of 6-h samples, all 1152 regions
    full_samples = 227760 // 6
    est_full_s = full_samples * total_regions / rps
    out = dict(metric="train_region_pairs_per_s", value=round(rps, 1),
               unit="region-pairs/s",
               wall_s=round(wall, 1), n_samples=T, regions=total_regions,
               m=6000, region_chunk=REGION_CHUNK,
               est_full_26y_train_hours=round(est_full_s / 3600, 2),
               device=str(jax.devices()[0]))
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "TRAIN_BENCH.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
