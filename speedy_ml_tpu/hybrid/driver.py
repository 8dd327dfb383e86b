"""Prediction driver: the outer loop of a hybrid forecast run.

Reference: parallelmain.f90:142-272 (trained-weight load, prediction
initialization, the timestep loop with sendrecievegrid) — here a thin
Python loop around the jitted cycle, with a streaming output writer
replacing the root-rank NetCDF appends (mpires.f90:499-543).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.data.calendar import ModelDate


class PredictionWriter:
    """Streaming 6-hourly output to an .npz series.

    Buffers in host memory and flushes in chunks; one file per run like
    the reference's hybrid_prediction_era...nc.  Base streams are
    atmo/logp/precip/sst; any further diag keys present are written too:
    vp_*/vml_* component contributions (mpires.f90:1114-1514) when
    `hyb.emit_components` is on, and truth_* fields when run_prediction
    gets a truth provider (write_truth_data, mpires.f90:918-1112)."""

    BASE = ("atmo", "logp", "precip", "sst")

    def __init__(self, path: str, flush_every: int = 64):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.buf: dict = {}
        self.flush_every = flush_every
        self.chunks = 0
        self._keys = None
        self._worker = None     # in-flight compression thread

    def append(self, diag: dict, sst_grid):
        rec = {k: diag[k] for k in diag
               if k in self.BASE or k.startswith(("vp_", "vml_", "truth_"))}
        rec["sst"] = sst_grid
        if self._keys is None:
            self._keys = sorted(rec)
            self.buf = {k: [] for k in self._keys}
        for k in self._keys:
            self.buf[k].append(np.asarray(rec[k], dtype=np.float32))
        if len(self.buf[self._keys[0]]) >= self.flush_every:
            self.flush()

    def flush(self, wait: bool = False):
        """Write the buffered chunk asynchronously.

        Compression (zlib, releases the GIL) runs in a worker thread so
        the prediction loop never blocks on it — a multi-year run flushes
        hundreds of ~100 MB chunks (the reference's root rank pays this
        serially in its NetCDF appends, mpires.f90:499-543).  At most one
        flush is in flight; the next joins it first, and consolidate()
        passes wait=True to drain."""
        import threading

        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._keys is not None and self.buf[self._keys[0]]:
            out = {k: np.stack(v) for k, v in self.buf.items()}
            path = self.path.with_suffix(f".part{self.chunks}.npz")
            self._worker = threading.Thread(
                target=np.savez_compressed, args=(path,), kwargs=out)
            self._worker.start()
            self.chunks += 1
            self.buf = {k: [] for k in self._keys}
        if wait and self._worker is not None:
            self._worker.join()
            self._worker = None

    def consolidate(self):
        """Merge all parts into one file."""
        self.flush(wait=True)
        parts = sorted(self.path.parent.glob(self.path.stem + ".part*.npz"),
                       key=lambda p: int(p.suffixes[-2][5:]))
        if not parts:
            return
        merged = {}
        for k in np.load(parts[0]).files:
            merged[k] = np.concatenate([np.load(p)[k] for p in parts])
        np.savez_compressed(self.path.with_suffix(".npz"), **merged)
        for p in parts:
            p.unlink()


def run_prediction(hyb, hstate, start_date: ModelDate, n_cycles: int,
                   output_path: str | None = None,
                   stop_if_unsafe: bool = True,
                   timestep_hours: int = 6,
                   sst_bias_per_year: float = 0.0,
                   truth_provider=None,
                   time_mean_path: str | None = None,
                   consolidate: bool = True,
                   progress_every: int = 0,
                   cycles_per_dispatch: int = 1):
    """Run `n_cycles` hybrid 6-h cycles from `hstate`.

    Returns (final state, list of dates).  Stops early if the SPEEDY
    safety gate trips (parallelmain.f90:268-270).  sst_bias_per_year:
    non-stationary-climate SST ramp (K/year) applied to climatological
    SST over open water (mod_utilities.f90:1806-1823 ramp +
    current_sst_bias of get_sst_by_date).  truth_provider: optional
    callable cycle_index -> dict of truth grids, written alongside the
    prediction for the verification workflow (write_truth_data,
    mpires.f90:918-1112).  consolidate=False leaves the stream as
    .partN.npz chunk files — REQUIRED for multi-year runs, whose merged
    arrays (e.g. 17 GB of atmo for 20 years) exceed host RAM; analysis
    reads the parts via analysis.iter_prediction_parts.

    cycles_per_dispatch > 1 runs K cycles inside ONE lax.scan dispatch
    with an on-device output buffer, removing the per-cycle dispatch and
    host sync: the per-cycle diag records come back stacked
    and are drained into the same writer/time-mean path.  The safety
    gate stays in-graph (an unsafe state holds SPEEDY for the rest of
    the dispatch), so batching only coarsens the HOST abort granularity
    from 1 to K cycles; dates past the first unsafe cycle are dropped.
    Requires truth_provider=None (truth joins per-cycle on host)."""
    import time as _time

    from speedy_ml_tpu.data.calendar import hour_of_year_365

    if cycles_per_dispatch > 1 and truth_provider is None:
        return _run_prediction_batched(
            hyb, hstate, start_date, n_cycles, output_path,
            stop_if_unsafe, timestep_hours, sst_bias_per_year,
            time_mean_path, consolidate, progress_every,
            cycles_per_dispatch)

    writer = PredictionWriter(output_path) if output_path else None
    tmean = None
    if time_mean_path:
        # monthly sigma->p time-mean products alongside the stream
        # (ppo_tminc/ppo_tmout; timemean.py)
        from speedy_ml_tpu.timemean import TimeMeanAccumulator
        tmean = TimeMeanAccumulator(hyb.gcm.geom,
                                    phis=np.asarray(hyb.gcm.bd.phis0))
    date = start_date
    dates = []
    params = hyb.params
    dt = hyb.gcm.dtype
    # the gate is checked EVERY cycle with a one-step lag: bool(prev_safe)
    # only blocks on the already-finished previous cycle, keeping host
    # dispatch pipelined; the cycle itself holds SPEEDY in-graph the moment
    # the gate trips, so the lagged step cannot poison state
    # (parallelmain.f90:268-270 immediate-abort semantics).
    prev_safe = None
    for i in range(n_cycles):
        if stop_if_unsafe and prev_safe is not None and not bool(prev_safe):
            print(f"prediction stopped: SPEEDY safety gate at cycle {i - 1}")
            break
        bias = sst_bias_per_year * (i * timestep_hours) / 8760.0
        hstate, diag = hyb.cycle_with_params(
            params, hstate, jnp.asarray(date.month - 1),
            jnp.asarray(date.tmonth, dtype=dt),
            jnp.asarray(date.tyear, dtype=dt),
            jnp.asarray(hour_of_year_365(date), dtype=jnp.int32),
            jnp.asarray(bias, dtype=dt))
        prev_safe = hstate.safe
        dates.append(date)
        date = date.advance_hours(timestep_hours)
        if writer:
            if truth_provider is not None:
                tr = truth_provider(i)
                diag = dict(diag, **{f"truth_{k}": v for k, v in tr.items()})
            writer.append(diag, hstate.sst_grid)
        if tmean is not None:
            tmean.add(dates[-1], np.asarray(diag["atmo"]),
                      np.asarray(diag["logp"]), np.asarray(diag["precip"]),
                      np.asarray(hstate.sst_grid))
        if progress_every and (i + 1) % progress_every == 0:
            print(f"cycle {i + 1}/{n_cycles} ({date.year}-{date.month:02d}"
                  f"-{date.day:02d}) safe={bool(prev_safe)} "
                  f"t={_time.strftime('%H:%M:%S')}", flush=True)
    if writer:
        if consolidate:
            writer.consolidate()
        else:
            writer.flush(wait=True)
    if tmean is not None:
        tmean.save(time_mean_path)
    return hstate, dates


def _run_prediction_batched(hyb, hstate, start_date: ModelDate,
                            n_cycles: int, output_path, stop_if_unsafe,
                            timestep_hours, sst_bias_per_year,
                            time_mean_path, consolidate, progress_every,
                            K: int):
    """K-cycles-per-dispatch product loop (see run_prediction docstring).

    The reference pays a hub round-trip per step (sendrecievegrid,
    mpires.f90:499-543); the per-cycle Python path above still pays one
    dispatch + host sync per step.  Here lax.scan runs K cycles on
    device and returns the diag records stacked, so host work (writer
    compression, time means) overlaps the next dispatch."""
    import time as _time

    from speedy_ml_tpu.data.calendar import hour_of_year_365

    writer = PredictionWriter(output_path) if output_path else None
    tmean = None
    if time_mean_path:
        from speedy_ml_tpu.timemean import TimeMeanAccumulator
        tmean = TimeMeanAccumulator(hyb.gcm.geom,
                                    phis=np.asarray(hyb.gcm.bd.phis0))
    params = hyb.params
    dt = hyb.gcm.dtype

    def body(prm, s, per):
        imon, fmon, tyear, hour, bias = per
        s2, diag = hyb.cycle_with_params(prm, s, imon, fmon, tyear,
                                         hour, bias)
        keep = {k: v for k, v in diag.items()
                if k in ("atmo", "logp", "precip")
                or k.startswith(("vp_", "vml_"))}
        keep["sst"] = s2.sst_grid
        keep["safe"] = s2.safe
        return s2, keep

    # params enter as a jit ARGUMENT, not a closure capture: captured
    # they become giant program constants (3.8 GB of f32 Wout at m=6000)
    # embedded in the compiled program
    run_k = jax.jit(
        lambda prm, s, pers: jax.lax.scan(
            functools.partial(body, prm), s, pers),
        donate_argnums=(1,))

    # per-cycle scalar args for the whole run, precomputed on host
    all_dates = [start_date]
    for _ in range(n_cycles - 1):
        all_dates.append(all_dates[-1].advance_hours(timestep_hours))
    imon_a = np.asarray([d.month - 1 for d in all_dates], np.int32)
    fmon_a = np.asarray([d.tmonth for d in all_dates], np.float32)
    tyear_a = np.asarray([d.tyear for d in all_dates], np.float32)
    hour_a = np.asarray([hour_of_year_365(d) for d in all_dates], np.int32)
    bias_a = np.asarray([sst_bias_per_year * (i * timestep_hours) / 8760.0
                         for i in range(n_cycles)], np.float32)

    dates: list = []
    done = 0
    pending = None            # (stacked host arrays, dates) to drain
    next_progress = progress_every if progress_every else None

    def drain(stacked, chunk_dates):
        n = len(chunk_dates)
        for b in range(n):
            if writer:
                rec = {k: stacked[k][b] for k in stacked
                       if k not in ("safe",)}
                writer.append(rec, stacked["sst"][b])
            if tmean is not None:
                tmean.add(chunk_dates[b], stacked["atmo"][b],
                          stacked["logp"][b], stacked["precip"][b],
                          stacked["sst"][b])

    while done < n_cycles:
        k = min(K, n_cycles - done)
        pers = (jnp.asarray(imon_a[done:done + k]),
                jnp.asarray(fmon_a[done:done + k]).astype(dt),
                jnp.asarray(tyear_a[done:done + k]).astype(dt),
                jnp.asarray(hour_a[done:done + k]),
                jnp.asarray(bias_a[done:done + k]).astype(dt))
        hstate, out = run_k(params, hstate, pers)
        # drain the PREVIOUS chunk while this dispatch runs on device
        if pending is not None:
            drain(*pending)
            pending = None
        safe_flags = np.asarray(out["safe"])        # syncs this dispatch
        stacked = {kk: np.asarray(v) for kk, v in out.items()}
        chunk_dates = all_dates[done:done + k]
        n_ok = k
        if stop_if_unsafe and not safe_flags.all():
            n_ok = int(np.argmin(safe_flags)) + 1   # first unsafe cycle
            stacked = {kk: v[:n_ok] for kk, v in stacked.items()}
            chunk_dates = chunk_dates[:n_ok]
        pending = (stacked, chunk_dates)
        dates.extend(chunk_dates)
        done += k
        if n_ok < k:
            print(f"prediction stopped: SPEEDY safety gate at cycle "
                  f"{len(dates) - 1}")
            break
        if next_progress is not None and done >= next_progress:
            d = all_dates[done - 1]
            print(f"cycle {done}/{n_cycles} ({d.year}-{d.month:02d}"
                  f"-{d.day:02d}) safe={bool(safe_flags[-1])} "
                  f"t={_time.strftime('%H:%M:%S')}", flush=True)
            next_progress += progress_every
    if pending is not None:
        drain(*pending)
    if writer:
        if consolidate:
            writer.consolidate()
        else:
            writer.flush(wait=True)
    if tmean is not None:
        tmean.save(time_mean_path)
    return hstate, dates
