"""Benchmark: hybrid-model throughput in simulated years per day.

Runs the flagship configuration (T30L8 SPEEDY + 1,152 batched reservoirs,
6-h coupling cycle) on the available accelerator and prints one JSON line:

  {"metric": "hybrid_sim_years_per_day", "value": N, "unit": "sim-years/day",
   "vs_baseline": N/100}

Baseline: the reference publishes no throughput numbers (BASELINE.md);
the driver's north-star target is 100 sim-years/day, so vs_baseline is
value/100.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax
    import jax.numpy as jnp

    from speedy_ml_tpu.core.geometry import Geometry
    from speedy_ml_tpu.gcm import GCM
    from speedy_ml_tpu.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu.runtime.jax_setup import enable_compile_cache

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    enable_compile_cache()

    log("bench: devices", jax.devices())

    geom = Geometry()
    unroll = int(os.environ.get("BENCH_UNROLL", "1"))
    gcm = GCM(geom, dtype=jnp.float32, scan_unroll=unroll)
    log("bench: gcm built, boundary data:", gcm.bc_source)
    # production-scale reservoirs: m=6000 -> n=5760/region, 1,152 regions
    m = int(os.environ.get("BENCH_M", "6000"))
    hyb = build_untrained_hybrid(gcm, m=m, radius_iters=10)
    if os.environ.get("BENCH_WOUT_BF16", "1") != "0":
        # default perf mode: bf16 readout weights halve the readout's
        # weight read (3.8 GB in f32 at m=6000).  Skill impact validated in
        # scripts/bf16_readout_validation.py + tests/test_solve_f32_bound.py;
        # set BENCH_WOUT_BF16=0 for the full-f32 reference mode.
        hyb.cast_wout_bf16()
        log("bench: wout cast to bf16")
    log("bench: hybrid built, m =", m)

    hstate = hyb.init_state(jnp.asarray(gcm.bd.sst12[0]))
    imon = jnp.asarray(0)
    fmon = jnp.asarray(0.5, jnp.float32)
    tyear = jnp.asarray(0.05, jnp.float32)
    log("bench: state initialized; compiling cycle")

    # compile + warmup.  Warm up CHAINED: XLA picks different layouts
    # for the cycle's outputs than fresh arrays have, so the first
    # output->input call compiles a second program variant.
    sync = jax.block_until_ready
    hstate2, _ = hyb.cycle(hstate, imon, fmon, tyear)
    sync(hstate2)
    log("bench: compiled (fresh); warming chained variant")
    hstate3, _ = hyb.cycle(hstate2, imon, fmon, tyear)
    sync(hstate3)
    hstate = hstate2
    log("bench: compiled; timing")

    n_cycles = int(os.environ.get("BENCH_CYCLES", "20"))
    chain = int(os.environ.get("BENCH_CHAIN", "0"))
    if chain:
        # scan `chain` cycles inside ONE dispatch: removes the per-cycle
        # host dispatch and is the production pattern when no per-cycle
        # host observability is needed.  Throughput here is the device's
        # cycle rate.
        import jax.lax as lax

        # params as a jit ARGUMENT: inside a trace hyb.cycle's concrete
        # self.params would become GBs of embedded program constants
        @jax.jit
        def run_chain(prm, s):
            def body(c, _):
                c2, _ = hyb.cycle_with_params(prm, c, imon, fmon, tyear)
                return c2, None
            return lax.scan(body, s, None, length=chain)[0]

        params = hyb.params
        cur = run_chain(params, hstate)        # compile + warm
        sync(cur)
        log("bench: chain compiled; timing")
        t0 = time.time()
        cur = run_chain(params, cur)
        sync(cur)
        elapsed = time.time() - t0
        n_cycles = chain
    else:
        t0 = time.time()
        cur = hstate
        for _ in range(n_cycles):
            cur, _ = hyb.cycle(cur, imon, fmon, tyear)
        sync(cur)
        elapsed = time.time() - t0

    sim_seconds = n_cycles * 6 * 3600.0
    sim_years_per_day = (sim_seconds / elapsed) * 86400.0 / (365.0 * 86400.0)
    cycle_ms = elapsed / n_cycles * 1000.0
    # grid-point-steps/s: grid columns x levels x GCM leapfrog steps
    # (BASELINE.md's grid-points/s scaling metric)
    g = geom
    gps = g.nlat * g.nlon * g.nlev * hyb.gcm_steps * n_cycles / elapsed

    breakdown = {
        "hybrid_sim_years_per_day": round(sim_years_per_day, 3),
        "cycle_ms": round(cycle_ms, 3),
        "grid_point_steps_per_s": round(gps, 1),
        "m": m, "n_regions": 1152, "device": str(jax.devices()[0]),
        "boundary_data": gcm.bc_source,
        "n_cycles": n_cycles,
    }

    if os.environ.get("BENCH_PIECES"):
        # per-piece ms (each an extra compile; off for the driver run)
        params = hyb.params
        packs, _ = hyb._with_params(params)
        f_pred = jax.jit(lambda prm, hs: hyb.predict_all(
            hyb._with_params(prm)[0], hs))
        f_asm = jax.jit(lambda prm, ov: hyb.assemble_global(
            hyb._with_params(prm)[0], ov))
        f_inj = jax.jit(lambda a, l: hyb.inject_to_speedy(a, l))
        f_fb = jax.jit(lambda prm, a, l, p, s, t: hyb.build_feedback(
            hyb._with_params(prm)[0], a, l, p, s, t))

        def timeit(fn, *a, reps=10):
            jax.block_until_ready(fn(*a))
            t1 = time.time()
            for _ in range(reps):
                out = fn(*a)
            jax.block_until_ready(out)
            return (time.time() - t1) / reps * 1000.0

        # spectral-transform ms/chip (BASELINE.md target metric): one
        # full-level batch of forward+inverse transforms, the unit the
        # dycore calls ~100x per GCM step
        sht_b = gcm.sht
        f_spec = jax.jit(lambda g: sht_b.spec_to_grid(sht_b.grid_to_spec(g)))
        gfield = jnp.zeros((geom.nlev, geom.nlat, geom.nlon), jnp.float32)
        breakdown["spectral_roundtrip_ms"] = round(timeit(f_spec, gfield), 3)
        breakdown["predict_all_ms"] = round(timeit(f_pred, params, cur), 3)
        log("bench: predict timed")
        _, outvecs = f_pred(params, cur)
        breakdown["assemble_ms"] = round(timeit(f_asm, params, outvecs), 3)
        atmo, logp, precip = f_asm(params, outvecs)
        breakdown["inject_ms"] = round(timeit(f_inj, atmo, logp), 3)
        log("bench: inject timed")
        spec, _ = f_inj(atmo, logp)
        breakdown["speedy_window_ms"] = round(timeit(
            lambda: hyb.speedy_window(spec, cur.sst_grid, imon, fmon,
                                      tyear)), 3)
        log("bench: speedy window timed")
        tisr = hyb.tisr_field(tyear)
        breakdown["build_feedback_ms"] = round(timeit(
            f_fb, params, atmo, logp, precip, cur.sst_grid, tisr), 3)

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_BREAKDOWN.json"), "w") as fo:
        json.dump(breakdown, fo, indent=1)

    print(json.dumps({
        "metric": "hybrid_sim_years_per_day",
        "value": round(sim_years_per_day, 3),
        "unit": "sim-years/day",
        "vs_baseline": round(sim_years_per_day / 100.0, 4),
    }))


if __name__ == "__main__":
    main()
