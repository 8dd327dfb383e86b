"""Per-section timing of the hybrid cycle at production scale.

Times (after compile): full cycle, ESN predict, assemble, inject,
speedy_window, feedback build. Prints milliseconds per call.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from speedy_ml_tpu.core.geometry import Geometry
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu.runtime.jax_setup import enable_compile_cache


def timeit(fn, *args, reps=10, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps * 1000.0


def main():
    enable_compile_cache()
    print("devices", jax.devices(), file=sys.stderr)
    geom = Geometry()
    gcm = GCM(geom, dtype=jnp.float32)
    print("boundary data:", gcm.bc_source, file=sys.stderr)
    m = int(os.environ.get("BENCH_M", "6000"))
    hyb = build_untrained_hybrid(gcm, m=m, radius_iters=10)
    print("built, m =", m, file=sys.stderr)

    hstate = hyb.init_state(jnp.asarray(gcm.bd.sst12[0]))
    imon = jnp.asarray(0)
    fmon = jnp.asarray(0.5, jnp.float32)
    tyear = jnp.asarray(0.05, jnp.float32)
    params = hyb.params

    # full cycle
    ms = timeit(lambda: hyb.cycle_with_params(params, hstate, imon, fmon, tyear))
    print(f"full cycle:      {ms:9.2f} ms")

    packs, opacks = hyb._with_params(params)

    f_pred = jax.jit(lambda prm, hs: hyb.predict_all(hyb._with_params(prm)[0], hs))
    ms = timeit(lambda: f_pred(params, hstate))
    print(f"predict_all:     {ms:9.2f} ms")

    new_x, outvecs = f_pred(params, hstate)

    f_asm = jax.jit(lambda prm, ov: hyb.assemble_global(hyb._with_params(prm)[0], ov))
    ms = timeit(lambda: f_asm(params, outvecs))
    print(f"assemble_global: {ms:9.2f} ms")
    atmo, logp, precip = f_asm(params, outvecs)

    f_inj = jax.jit(lambda a, l: hyb.inject_to_speedy(a, l))
    ms = timeit(lambda: f_inj(atmo, logp))
    print(f"inject:          {ms:9.2f} ms")
    spec, safe = f_inj(atmo, logp)

    ms = timeit(lambda: hyb.speedy_window(spec, hstate.sst_grid, imon, fmon, tyear))
    print(f"speedy_window:   {ms:9.2f} ms")
    fc_atmo, fc_logp, _ = hyb.speedy_window(spec, hstate.sst_grid, imon, fmon, tyear)

    f_fb = jax.jit(lambda prm, a, l, p, s, t: hyb.build_feedback(
        hyb._with_params(prm)[0], a, l, p, s, t))
    tisr = hyb.tisr_field(tyear)
    ms = timeit(lambda: f_fb(params, atmo, logp, precip, hstate.sst_grid, tisr))
    print(f"build_feedback:  {ms:9.2f} ms")

    f_lm = jax.jit(lambda prm, a, l: hyb.build_local_model(
        hyb._with_params(prm)[0], a, l))
    ms = timeit(lambda: f_lm(params, fc_atmo, fc_logp))
    print(f"build_local:     {ms:9.2f} ms")

    # ESN subparts
    p = packs[0]
    cs = hstate.classes[0]
    from speedy_ml_tpu.esn.reservoir import (esn_step, readout, ell_spmv,
                                             ell_spmv_shift)
    f_step = jax.jit(lambda r, x, u: esn_step(r, x, u, p.hyper.leakage))
    ms = timeit(lambda: f_step(p.res, cs.x, cs.feedback))
    print(f"  esn_step:      {ms:9.2f} ms")
    if p.res.shifts is not None:
        sh = p.res.shifts
        f_sp = jax.jit(lambda v, x: ell_spmv_shift(v, sh, x))
        ms = timeit(lambda: f_sp(p.res.vals, cs.x))
        print(f"  spmv(shift):   {ms:9.2f} ms")
    else:
        f_sp = jax.jit(ell_spmv)
        ms = timeit(lambda: f_sp(p.res.vals, p.res.cols, cs.x))
        print(f"  spmv(gather):  {ms:9.2f} ms")
    f_ro = jax.jit(lambda r, x, lm: readout(r, x, lm))
    ms = timeit(lambda: f_ro(p.res, cs.x, cs.local_model))
    print(f"  readout:       {ms:9.2f} ms")


if __name__ == "__main__":
    main()
