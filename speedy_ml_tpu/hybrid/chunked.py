"""Production-scale reservoir training: region-chunked, host-streamed.

The reference trains 1,152 regions over ~26 years of hourly data
(mod_reservoir.f90:1559-1699 batched normal equations;
mod_io.f90:1878 year-wise streaming NetCDF reads; the strided sub-series
loop at mod_reservoir.f90:287-299 splits the hourly series into
`timestep` interleaves and SUMS their normal equations).  At that scale
neither the packed input series (T, R, I) ~ 100 GB nor the batched Gram
matrices (R, S+n, S+n) ~ 160 GB fit in one chip's HBM, so this module
tiles the problem two ways:

- **region chunks**: the Gram/normal-equation accumulation and the ridge
  solve run over `region_chunk` regions at a time — HBM holds one
  (Rch, S+n, S+n) block (donated across accumulation steps, so XLA
  updates it in place);
- **time chunks**: the input series never materializes whole.  A
  `SeriesSource` yields global grids for requested sample indices
  (in-memory arrays, or year-files via data.era); each chunk is packed,
  standardized, and scanned on device, carrying only the reservoir state
  x between chunks.

The strided sub-series of the reference are supported via `stride`:
sub-series s takes samples s, s+stride, ...; each restarts the reservoir
transient and all accumulate into the SAME normal equations.

Chunking is exact: `tests/test_chunked.py` proves chunked == unchunked
Wout (noise off) and chunk-size invariance (noise on, keys derived from
absolute sample indices).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.esn.domain import RegionLayout, build_layout
from speedy_ml_tpu.esn.reservoir import (BatchedReservoir, ESNHyper, esn_step,
                                         generate, quad_expand, radius_by_lat)
from speedy_ml_tpu.esn.standardize import (Standardizer, component_expansion,
                                           component_sums, n_components)
from speedy_ml_tpu.esn.train import (NormalEq, apply_noise_keys, gram_update,
                                     solve_wout)
from speedy_ml_tpu.hybrid.model import ClassPack
from speedy_ml_tpu.hybrid.training import NVAR
from speedy_ml_tpu.runtime.jax_setup import host_device


def _staging_device():
    """CPU device for training prep (pack/standardize/noise) when the
    default backend is an accelerator; None when already on CPU.

    Prep reads the raw gridded series, ~5x the bytes of the packed
    training series it produces; running it on the in-process CPU backend
    means only the packed series (z, target, model block) crosses to the
    accelerator, and its memory stays free for the Gram blocks.  Whether
    prep on the accelerator would be faster end to end is not measured
    yet."""
    if jax.default_backend() == "cpu":
        return None
    return host_device()


def _staging_ctx(dev):
    return (jax.default_device(dev) if dev is not None
            else contextlib.nullcontext())


class ArraySource:
    """In-memory SeriesSource over the hybrid.training truth/model dicts.

    Protocol (any object with these members works — e.g. a year-file
    streaming reader backed by data.era):
      n_samples: int
      truth_at(idx) -> dict of numpy/jnp arrays indexed at sample indices
                       (atmo (B,4,K,lat,lon), logp/precip/sst/tisr (B,lat,lon))
      model_at(idx) -> dict(atmo, logp) or None
    """

    def __init__(self, truth: dict, model: Optional[dict] = None):
        self.truth = truth
        self.model = model

    @property
    def n_samples(self) -> int:
        return self.truth["atmo"].shape[0]

    def truth_at(self, idx: np.ndarray) -> dict:
        return {k: np.asarray(v)[idx] for k, v in self.truth.items()}

    def model_at(self, idx: np.ndarray) -> Optional[dict]:
        if self.model is None:
            return None
        return {k: np.asarray(v)[idx] for k, v in self.model.items()}


class ERASource:
    """SeriesSource over yearly ERA5 files (data.era.ERA5Reader) plus an
    optional model-forecast reader; loads whole years lazily with an LRU
    of one year, which matches the reference's year-loop streaming reads
    (speedy_res_interface.f90:439-632).

    Sample hours live on the 365-day MODEL calendar (8,760 h/year): leap
    years' Feb-29 records are spliced OUT of the file via
    ERA5Reader.valid_hour_index (the reference's splice at
    speedy_res_interface.f90:588-596), and a requested chunk may span a
    year boundary — the read splits per year-file and concatenates.

    sst_climo: optional (365, lat, lon) daily SST climatology; when given
    SSTs become anomalies against it (train_on_sst_anomalies,
    speedy_res_interface.f90 anomaly option)."""

    VARS = ("t", "u", "v", "q", "logp", "precip", "sst", "tisr")

    def __init__(self, reader, year0: int, n_samples: int,
                 sample_stride_hours: int = 1, model_reader=None,
                 sst_climo=None):
        self.reader = reader
        self.year0 = year0
        self._n = n_samples
        self.stride_h = sample_stride_hours
        self.model_reader = model_reader
        self.sst_climo = None if sst_climo is None else np.asarray(sst_climo)
        self._cache_year = None
        self._cache = None
        self._cache_valid = None

    @property
    def n_samples(self) -> int:
        return self._n

    def _hours(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(idx) * self.stride_h

    def _year_data(self, year: int):
        """(raw year arrays, Feb-29-spliced hour index) with a 1-year LRU."""
        if self._cache_year != year:
            self._cache = self.reader.read_year(year, variables=self.VARS)
            self._cache_valid = self.reader.valid_hour_index(year)
            self._cache_year = year
        return self._cache, self._cache_valid

    def truth_at(self, idx: np.ndarray) -> dict:
        from speedy_ml_tpu.data.era import era_to_truth
        hours = self._hours(idx)
        years = self.year0 + hours // 8760
        parts = []
        # ascending year order keeps sample order AND leaves the latest
        # year cached for the caller's next (time-ordered) chunk
        for y in sorted(int(v) for v in np.unique(years)):
            sel = years == y
            off = hours[sel] - (y - self.year0) * 8760
            data, valid = self._year_data(y)
            fidx = valid[off]
            parts.append({k: data[k][fidx] for k in self.VARS})
        raw = (parts[0] if len(parts) == 1 else
               {k: np.concatenate([p[k] for p in parts]) for k in self.VARS})
        return era_to_truth(raw, sst_climo=self.sst_climo,
                            hour_of_year=(hours % 8760
                                          if self.sst_climo is not None
                                          else None))

    def model_at(self, idx: np.ndarray) -> Optional[dict]:
        if self.model_reader is None:
            return None
        return self.model_reader(self._hours(idx))


# ----------------------------------------------------------------------
# gather-based packing (chunk-friendly: one XLA gather per field, cost
# and compile time proportional to the requested region subset — the
# roll-based class_patches pack unrolls 16 window offsets and costs
# minutes of XLA compile at T30 chunk shapes)
# ----------------------------------------------------------------------

def gather_pack_inputs(chunk_truth: dict, iy, ix, precip_eps: float,
                       dtype) -> jnp.ndarray:
    """Pack input vectors (C, R, I) for regions given window index
    tables iy (R, yi) / ix (R, xi), in the reference packing order
    (atmo z,y,x,v-flattened; then logp/precip/sst/tisr)."""
    ap = RegionLayout.gather_patches(chunk_truth["atmo"], iy, ix)
    # (R, C, V, K, yi, xi) -> (C, R, K, yi, xi, V) -> flatten
    ap = jnp.transpose(ap, (1, 0, 3, 4, 5, 2))
    C, R = ap.shape[0], ap.shape[1]
    parts = [ap.reshape(C, R, -1)]
    for name in ("logp", "precip", "sst", "tisr"):
        f = chunk_truth[name]
        if name == "precip":
            f = jnp.log(1.0 + jnp.maximum(f, 0.0) / precip_eps)
        p = RegionLayout.gather_patches(f, iy, ix)      # (R, C, yi, xi)
        parts.append(jnp.moveaxis(p, 0, 1).reshape(C, R, -1))
    return jnp.concatenate(parts, axis=2).astype(dtype)


# ----------------------------------------------------------------------
# streaming standardizer
# ----------------------------------------------------------------------

def streaming_standardizer(layout: RegionLayout, cls, source, nz: int, *,
                           time_chunk: int = 512, precip_eps: float = 0.001,
                           dtype=jnp.float32,
                           std_floor: float = 0.01) -> Standardizer:
    """Per-component mean/std over the full series without materializing
    it (the streaming twin of esn.standardize.compute_standardizer)."""
    xi, yi = cls.input_shape
    xc, yc = cls.core_shape
    comp_in = component_expansion(xi, yi, NVAR, nz, logp=True, precip=True,
                                  sst=True, tisr=True)
    comp_out = component_expansion(xc, yc, NVAR, nz, logp=True, precip=True,
                                   sst=False, tisr=False)
    nc = n_components(NVAR, nz, logp=True, precip=True, sst=True, tisr=True)
    cm = np.asarray(comp_in)
    onehot_np = np.zeros((len(comp_in), nc), dtype=np.float64)
    onehot_np[np.arange(len(comp_in)), comp_in] = 1.0
    onehot = np.asarray(onehot_np, dtype=dtype)
    iy = np.asarray(cls.iy_in)
    ix = np.asarray(cls.ix_in)

    @jax.jit
    def acc(chunk, s1, s2, cnt):
        series = gather_pack_inputs(chunk, iy, ix, precip_eps, dtype)
        d1, d2 = component_sums(series, onehot)
        cnt = cnt + onehot.sum(axis=0) * series.shape[0]
        return s1 + d1, s2 + d2, cnt

    # the whole accumulation runs on the staging (CPU) device: it reads
    # the raw grids (see _staging_device) and is a single cheap pass
    Rc = cls.count
    T = source.n_samples
    with _staging_ctx(_staging_device()):
        s1 = jnp.zeros((Rc, nc), dtype=dtype)
        s2 = jnp.zeros((Rc, nc), dtype=dtype)
        cnt = jnp.zeros((nc,), dtype=dtype)
        for t0 in range(0, T, time_chunk):
            idx = np.arange(t0, min(t0 + time_chunk, T))
            chunk = {k: np.asarray(v) for k, v in source.truth_at(idx).items()}
            s1, s2, cnt = acc(chunk, s1, s2, cnt)

        cnt = jnp.maximum(cnt, 1.0)
        mean_c = s1 / cnt
        var_c = s2 / cnt - mean_c**2
        # constant components standardize to ~0, not through a ~0 std
        std_c = jnp.where(var_c < 1e-12, 1.0,
                          jnp.sqrt(jnp.maximum(var_c, 0.0)))
        if std_floor:
            from speedy_ml_tpu.esn.standardize import floor_component_std
            std_c = floor_component_std(std_c, NVAR, nz, frac=std_floor)
    # numpy (uncommitted) results: consumers place them where they run
    mean_c = np.asarray(mean_c)
    std_c = np.asarray(std_c)
    return Standardizer(comp_mean=mean_c, comp_std=std_c,
                        in_mean=mean_c[:, cm], in_std=std_c[:, cm],
                        out_mean=mean_c[:, comp_out],
                        out_std=std_c[:, comp_out])


# ----------------------------------------------------------------------
# chunked accumulation
# ----------------------------------------------------------------------

def _chunk_accumulators(hyper: ESNHyper, shifts, n_in: int, cols=None):
    """Build the two jitted inner programs (advance-only and accumulate).

    Noise is already applied to z by the caller (on the FULL class, so
    results are independent of region chunking).  ss/st/x are donated so
    XLA reuses their device memory across calls — at production scale ss
    alone is gigabytes per region chunk.

    shift topology carries `shifts`; the reference's random graphs carry
    the shared ELL `cols` (n, J) (gather spmv)."""

    def mkres(vals, win_vals):
        R, n = win_vals.shape
        return BatchedReservoir(
            cols=(jnp.zeros((0,), dtype=jnp.int32) if cols is None
                  else cols),
            vals=vals,
            win_vals=win_vals, wout=jnp.zeros((R, 0, 0), dtype=vals.dtype),
            mean=jnp.zeros((R, 0)), std=jnp.ones((R, 0)),
            n_in=n_in, shifts=shifts)

    @functools.partial(jax.jit, donate_argnums=(2,))
    def advance(vals, win_vals, x, z):
        res = mkres(vals, win_vals)

        def body(xc, u):
            return esn_step(res, xc, u, hyper.leakage), None

        x, _ = jax.lax.scan(body, x, z)
        return x

    @functools.partial(jax.jit, donate_argnums=(2, 3, 4))
    def accumulate(vals, win_vals, x, ss, st, z, target, model):
        """Pair states with targets over the chunk, chunking_matmul-style
        (mod_reservoir.f90:1592-1699): state x_t (inputs absorbed up to
        t-1) pairs with target[t]; z/target/model have equal length C."""
        res = mkres(vals, win_vals)

        def collect(xc, u):
            xn = esn_step(res, xc, u, hyper.leakage)
            return xn, xn

        x_last, tail = jax.lax.scan(collect, x, z[:-1])
        states = jnp.concatenate([x[None], tail], axis=0)    # (C, Rch, n)
        states = quad_expand(states)
        if model is not None:
            aug = jnp.concatenate([model, states], axis=2)
        else:
            aug = states
        ss, st = gram_update(ss, st, aug, target)
        # advance into the next chunk's first state
        x_next = esn_step(res, x_last, z[-1], hyper.leakage)
        return x_next, ss, st

    return advance, accumulate


def train_class_production(layout: RegionLayout, cls, source, hyper: ESNHyper,
                           key, nz: int, *,
                           region_chunk: int = 32, time_chunk: int = 128,
                           stride: int = 1, n_discard: int = 10,
                           n_pairs: Optional[int] = None,
                           precip_eps: float = 0.001, dtype=jnp.float32,
                           topology: str = "shift",
                           std: Optional[Standardizer] = None,
                           hybrid: bool = True,
                           solve_dtype=None,
                           progress=None) -> ClassPack:
    """Region-chunked + time-streamed train_class (production scale).

    source: SeriesSource of T samples; with `stride` > 1 the samples are
    split into `stride` interleaved sub-series (the reference's hourly
    data against the 6-h reservoir step, mod_reservoir.f90:287-299), each
    restarting the reservoir transient, all summing into one NormalEq.

    n_pairs: per-sub-series cap on (state, target) pairs — used by tests
    to match the unchunked trainer's complete-batch coverage; default all.
    """
    Rc = cls.count
    T = source.n_samples
    if std is None:
        std = streaming_standardizer(layout, cls, source, nz,
                                     time_chunk=max(time_chunk, 128),
                                     precip_eps=precip_eps, dtype=dtype)

    lat_s = layout.lat_start[cls.region_ids]
    lat_e = layout.lat_end[cls.region_ids]
    radius = radius_by_lat(lat_s, lat_e)
    cols, vals, win, shifts = generate(key, Rc, hyper_inputs(layout, cls, nz),
                                       hyper, radius, dtype=dtype,
                                       topology=topology)
    n = vals.shape[2]
    xc, yc = cls.core_shape
    O = NVAR * nz * xc * yc + 2 * xc * yc        # atmo + logp + precip
    S = (O - xc * yc) if hybrid else 0           # model block: atmo + logp

    noise_on = hyper.noise_mag > 0
    noise_key = jax.random.fold_in(key, 99) if noise_on else None
    lay_in = build_layout(*cls.input_shape, NVAR, nz, logp=True, precip=True,
                          sst=True, tisr=True)
    pm_idx = NVAR * nz + 1
    precip_info = None
    if noise_on:
        precip_info = dict(slice=lay_in.precip,
                           mean=std.comp_mean[:, pm_idx:pm_idx + 1],
                           std=std.comp_std[:, pm_idx:pm_idx + 1],
                           eps=precip_eps)

    # jitted prep: pack + standardize one time chunk for the CURRENT
    # region chunk only, via index gathers (cost scales with the subset,
    # not the class — the full-class roll-based pack costs ~0.5 s per
    # call and dominated the streamed trainer).  Training noise (targets
    # stay clean) is keyed by (sub-series key, time index, GLOBAL region
    # id), so every draw is independent of region/time chunking.
    @jax.jit
    def prep(chunk_truth, chunk_model, sub_key, t_idx, rid,
             iy, ix, iyc, ixc, in_mean, in_std, out_mean, out_std,
             pmean, pstd):
        series = gather_pack_inputs(chunk_truth, iy, ix, precip_eps, dtype)
        C, Rch = series.shape[0], series.shape[1]
        z = (series - in_mean) / in_std
        target = layout.input_to_target(
            cls, z.reshape(C * Rch, -1), NVAR, nz, nz, 0,
            logp=True, precip=True, sst=True, tisr=True).reshape(C, Rch, -1)
        if sub_key is not None:
            keys = jax.vmap(lambda t: jax.vmap(
                lambda r: jax.random.fold_in(
                    jax.random.fold_in(sub_key, t), r))(rid))(t_idx)
            def add_noise(kr, u):
                if pmean is None:
                    return apply_noise_keys(kr, u, hyper.noise_mag)
                return apply_noise_keys(kr, u, hyper.noise_mag,
                                        precip_slice=lay_in.precip,
                                        precip_mean=pmean, precip_std=pstd,
                                        precip_eps=precip_eps)
            z = jax.vmap(add_noise)(keys, z)
        if chunk_model is None:
            return z, target, None
        mc = RegionLayout.gather_patches(chunk_model["atmo"], iyc, ixc)
        mc = jnp.transpose(mc, (1, 0, 3, 4, 5, 2))
        mparts = [mc.reshape(C, Rch, -1)]
        lp = RegionLayout.gather_patches(chunk_model["logp"], iyc, ixc)
        mparts.append(jnp.moveaxis(lp, 0, 1).reshape(C, Rch, -1))
        mser = jnp.concatenate(mparts, axis=2).astype(dtype)
        zm = (mser - out_mean[None, :, :S]) / out_std[None, :, :S]
        return z, target, zm

    eq_dtype = jnp.float32 if dtype == jnp.float32 else dtype
    wout_parts = []
    # built ONCE: jit caches by shape, so all full-size region chunks
    # share one compilation (the ragged tail chunk adds one more)
    advance, accumulate = _chunk_accumulators(
        hyper, shifts, std.in_mean.shape[1],
        cols=None if shifts is not None else cols)
    solve = jax.jit(solve_wout, static_argnums=(1, 2, 3))
    stage_dev = _staging_device()
    accel_dev = jax.devices()[0]

    for r0 in range(0, Rc, region_chunk):
        r1 = min(r0 + region_chunk, Rc)
        Rch = r1 - r0
        vals_ch = vals[:, r0:r1]
        win_ch = win[r0:r1]
        # host-side latitude-band slicing: this region chunk only reads
        # the rows its windows cover, so slice every field to that band
        # BEFORE prep and remap the row tables.  Without this each region
        # chunk re-reads the FULL global series (11x the needed bytes at
        # 96-region chunks).
        rows = np.unique(np.asarray(cls.iy_in[r0:r1]))
        row_of = np.full(int(rows.max()) + 1, -1, dtype=np.int64)
        row_of[rows] = np.arange(len(rows))
        iy = np.asarray(row_of[np.asarray(cls.iy_in[r0:r1])])
        ix = np.asarray(cls.ix_in[r0:r1])
        iyc = np.asarray(row_of[np.asarray(cls.iy_core[r0:r1])])
        ixc = np.asarray(cls.ix_core[r0:r1])
        rid = np.asarray(cls.region_ids[r0:r1], dtype=np.int32)
        in_mean, in_std = std.in_mean[r0:r1], std.in_std[r0:r1]
        out_mean, out_std = std.out_mean[r0:r1], std.out_std[r0:r1]
        pmean = pstd = None
        if precip_info is not None:
            pmean = precip_info["mean"][r0:r1]
            pstd = precip_info["std"][r0:r1]
        A = S + n
        ss = jnp.zeros((Rch, A, A), dtype=eq_dtype)
        st = jnp.zeros((Rch, O, A), dtype=eq_dtype)

        # keep at most one chunk in flight: without a periodic sync the
        # host loop dispatches the whole series ahead, holding every
        # queued chunk's inputs in memory until the queue drains.  The
        # sync waits on a tiny marker derived from x (x itself is
        # donated to the next call, so it cannot be waited on later).
        prev_mark = None
        for s in range(stride):
            sub_idx = np.arange(s, T, stride)
            L = len(sub_idx)
            pairs_total = L - n_discard if n_pairs is None else min(
                n_pairs, L - n_discard)
            sub_key = (jax.random.fold_in(noise_key, s) if noise_on
                       else None)
            x = jnp.zeros((Rch, n), dtype=dtype)
            pos = 0     # position within this sub-series
            while pos < n_discard + pairs_total:
                c0 = pos
                c1 = min(pos + time_chunk, n_discard + pairs_total)
                idx = sub_idx[c0:c1]
                truth = {k: np.asarray(v)[..., rows, :]
                         for k, v in source.truth_at(idx).items()}
                model = source.model_at(idx) if hybrid else None
                model = (None if model is None else
                         {k: np.asarray(v)[..., rows, :]
                          for k, v in model.items()})
                # pack/standardize on the CPU staging device; ship ONLY
                # the packed series to the accelerator (_staging_device)
                with _staging_ctx(stage_dev):
                    z, target, zm = prep(
                        truth, model, sub_key, np.arange(c0, c1), rid,
                        iy, ix, iyc, ixc, in_mean, in_std, out_mean,
                        out_std, pmean, pstd)
                if stage_dev is not None:
                    z, target, zm = jax.device_put(
                        (z, target, zm), accel_dev)
                if c1 <= n_discard:
                    x = advance(vals_ch, win_ch, x, z)
                elif c0 >= n_discard:
                    x, ss, st = accumulate(vals_ch, win_ch, x, ss, st,
                                           z, target, zm)
                else:
                    d = n_discard - c0
                    x = advance(vals_ch, win_ch, x, z[:d])
                    x, ss, st = accumulate(
                        vals_ch, win_ch, x, ss, st, z[d:], target[d:],
                        None if zm is None else zm[d:])
                if prev_mark is not None:
                    prev_mark.block_until_ready()
                prev_mark = jnp.abs(x[:1, :1])
                pos = c1
                if progress is not None:
                    progress(r0, s, pos)

        wout_ch = solve(NormalEq(ss=ss, st=st), hyper,
                        S if hybrid else 0, solve_dtype)
        wout_parts.append(np.asarray(wout_ch))
        del ss, st

    wout = jnp.asarray(np.concatenate(wout_parts, axis=0), dtype=dtype)
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win,
                           n_in=std.in_mean.shape[1], wout=wout,
                           mean=std.in_mean, std=std.in_std,
                           shifts=shifts)
    return ClassPack(cls=cls, res=res, hyper=hyper, std=std)


def hyper_inputs(layout: RegionLayout, cls, nz: int) -> int:
    """Input vector length for a class (atmo + logp/precip/sst/tisr)."""
    xi, yi = cls.input_shape
    return build_layout(xi, yi, NVAR, nz, logp=True, precip=True,
                        sst=True, tisr=True).total


def ocean_series_production(layout: RegionLayout, cls, atmo_std, source,
                            nz: int, *, slab_stride: int = 28,
                            stride: int = 1, time_chunk: int = 512,
                            precip_eps: float = 0.001, dtype=jnp.float32):
    """Stream the slab-ocean training series from a SeriesSource.

    The slab inputs are trailing `slab_stride`-sample rolling means of
    the atmo-standardized ocean-input sub-vector, sampled at the slab
    cadence; targets are the SST core at the same cadence
    (get_training_data_from_atmo's rolling average + stride,
    mod_slab_ocean_reservoir.f90:272-376).  The 6-h base series is
    sub-series 0 of `stride` (hourly sources).  Streams time chunks and
    carries the rolling window across chunk edges — the full truth is
    NEVER materialized (the r2 implementation held the whole series on
    host, ~TBs at 26 years).  Also accumulates the mean SST grid
    (base_sst, the land fill of mpires.f90:458-472).

    Returns (o_series (T_slab, Rc, I_o), target (T_slab, Rc, O),
    mean_sst_grid)."""
    from speedy_ml_tpu.esn.ocean import (ocean_index_map, ocean_target_slice,
                                         rolling_mean, sst_core_from_input)
    iy = np.asarray(cls.iy_in)
    ix = np.asarray(cls.ix_in)
    idx_map = np.asarray(ocean_index_map(cls, nz))
    sl = ocean_target_slice(cls, nz)
    W = slab_stride
    sub_idx = np.arange(0, source.n_samples, stride)
    T = len(sub_idx)

    @jax.jit
    def prep(chunk_truth, carry):
        series = gather_pack_inputs(chunk_truth, iy, ix, precip_eps, dtype)
        z = (series - atmo_std.in_mean) / atmo_std.in_std
        o = z[:, :, idx_map]
        full = jnp.concatenate([carry, o], axis=0)
        rm = rolling_mean(full, W)[carry.shape[0]:]
        sst_block = z[:, :, sl[0]:sl[1]]
        C, Rc = sst_block.shape[:2]
        tgt = sst_core_from_input(
            cls, sst_block.reshape(C * Rc, -1)).reshape(C, Rc, -1)
        return rm, tgt, full[-(W - 1):] if W > 1 else full[:0]

    I_o = len(np.asarray(idx_map))
    Rc = cls.count
    o_parts, t_parts = [], []
    sst_sum = None
    n_sst = 0
    pos = 0
    # the rolling-mean prep runs on the CPU staging device: it reads the
    # raw grids (see _staging_device); only the slab-cadence series
    # (tiny) goes to the accelerator below
    with _staging_ctx(_staging_device()):
        carry = jnp.zeros((0, Rc, I_o), dtype=dtype)
        while pos < T:
            idx = sub_idx[pos:pos + time_chunk]
            truth = {k: np.asarray(v)
                     for k, v in source.truth_at(idx).items()}
            rm, tgt, carry = prep(truth, carry)
            # slab-cadence positions within this chunk (global phase W-1)
            loc = np.arange(len(idx))
            keep = (pos + loc) % W == W - 1
            if keep.any():
                o_parts.append(np.asarray(rm[keep]))
                t_parts.append(np.asarray(tgt[keep]))
            s = truth["sst"]
            sst_sum = (s.sum(axis=0) if sst_sum is None
                       else sst_sum + s.sum(axis=0))
            n_sst += s.shape[0]
            pos += len(idx)
    o_series = jnp.asarray(np.concatenate(o_parts, axis=0))
    target = jnp.asarray(np.concatenate(t_parts, axis=0))
    return o_series, target, jnp.asarray(sst_sum / max(n_sst, 1))


_RES_ARRAYS = ("cols", "vals", "win_vals", "wout", "mean", "std",
               "win_cols")


def _res_to(res, convert):
    """Move a BatchedReservoir's array fields with `convert` (host<->device)."""
    import dataclasses as _dc
    move = {}
    for k in _RES_ARRAYS:
        v = getattr(res, k, None)
        if v is not None and hasattr(v, "dtype"):
            move[k] = convert(v)
    return _dc.replace(res, **move)


def train_hybrid_production(gcm, layout: RegionLayout, source,
                            hyper: ESNHyper, key, *, ocean: bool = False,
                            ocean_hyper=None, hybrid: bool = True,
                            hybrid_ocean: bool = False,
                            slab_stride: int = 28,
                            atmo_ckpt: str | None = None,
                            ocean_region_chunk: int = 32, **kw):
    """Train every region class at production scale and assemble the
    hybrid atmosphere (the streaming twin of training.train_hybrid).

    hybrid_ocean: train the slab readout with the lagged-SST local-model
    block (predict_slab, mod_slab_ocean_reservoir.f90:1201-1249) instead
    of the default ml-only slab (ml_only_ocean=.True.,
    initialize_slab_ocean_model:26).

    atmo_ckpt: path for an atmosphere-only partial checkpoint — written
    right after the atmo classes train, loaded instead of retraining if
    it already exists.  A crash in the (later) slab-ocean stage then
    costs only the slab work on retry, not the ~1 h atmo pass.

    ocean_region_chunk: regions per slab Gram chunk (fit_ocean_class);
    the trained atmo packs are offloaded to host for the duration of the
    ocean stage so the slab Gram never shares HBM with them."""
    import os

    from speedy_ml_tpu.hybrid.model import HybridAtmosphere

    dtype = kw.get("dtype", jnp.float32)
    if atmo_ckpt is not None and os.path.exists(atmo_ckpt):
        from speedy_ml_tpu.data.checkpoint import load_hybrid
        packs = list(load_hybrid(gcm, layout, atmo_ckpt, dtype=dtype).packs)
    else:
        packs = []
        for i, cls in enumerate(layout.classes):
            packs.append(train_class_production(
                layout, cls, source, hyper, jax.random.fold_in(key, i),
                gcm.geom.nlev, hybrid=hybrid, **kw))
        if atmo_ckpt is not None:
            from speedy_ml_tpu.data.checkpoint import save_hybrid
            save_hybrid(HybridAtmosphere(gcm, layout, packs,
                                         ml_only=not hybrid), atmo_ckpt)
    ocean_packs = None
    base_sst = sea_mask = None
    if ocean:
        from speedy_ml_tpu.esn.ocean import OCEAN_HYPER
        from speedy_ml_tpu.hybrid.training import fit_ocean_class
        ocean_hyper = ocean_hyper or OCEAN_HYPER
        # free ~4 GB of HBM (m=6000: wout alone is 3.7 GB) while the
        # slab-ocean Grams run; restored to device after the loop
        packs = [p._replace(res=_res_to(p.res, np.asarray)) for p in packs]
        ocean_packs = []
        for i, (cls, p) in enumerate(zip(layout.classes, packs)):
            o_series, target, mean_sst = ocean_series_production(
                layout, cls, p.std, source, gcm.geom.nlev,
                slab_stride=slab_stride, stride=kw.get("stride", 1),
                time_chunk=max(kw.get("time_chunk", 128), 128),
                precip_eps=kw.get("precip_eps", 0.001), dtype=dtype)
            ocean_packs.append(fit_ocean_class(
                cls, o_series, target, p, ocean_hyper,
                jax.random.fold_in(key, 500 + i), gcm.geom.nlev,
                dtype=dtype, topology=kw.get("topology", "shift"),
                hybrid_ocean=hybrid_ocean,
                region_chunk=ocean_region_chunk))
            if i == 0:
                base_sst = mean_sst
        packs = [p._replace(res=_res_to(p.res, jnp.asarray)) for p in packs]
        sea_mask = jnp.asarray(np.asarray(gcm.bd.fmask_l) > 0.0)
    return HybridAtmosphere(gcm, layout, packs, ml_only=not hybrid,
                            ocean_packs=ocean_packs, base_sst=base_sst,
                            sea_mask=sea_mask)
