"""Builders for hybrid model instances (trained or randomly initialized).

A randomly initialized hybrid (untrained Wout) has exactly the compute
graph of the trained one — used for compile checks and benchmarking.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.esn.domain import RegionLayout, build_layout
from speedy_ml_tpu.esn.reservoir import (BatchedReservoir, ESNHyper, generate,
                                         radius_by_lat)
from speedy_ml_tpu.esn.standardize import (Standardizer, component_expansion,
                                           n_components)
from speedy_ml_tpu.hybrid.model import ClassPack, HybridAtmosphere

NVAR = 4


def untrained_pack(layout: RegionLayout, cls, hyper: ESNHyper, key, nz: int,
                   dtype=jnp.float32, radius_iters: int = 30,
                   skip_wout: bool = False,
                   topology: str = "shift") -> ClassPack:
    """Reservoirs with random Wout and unit standardization (benchmark use).

    skip_wout leaves a dummy (Rc, O, 0)-shaped Wout for the caller to fill
    (so the big array can be created directly on the target device)."""
    xi, yi = cls.input_shape
    xc, yc = cls.core_shape
    lay_in = build_layout(xi, yi, NVAR, nz, logp=True, precip=True, sst=True,
                          tisr=True)
    lay_out = build_layout(xc, yc, NVAR, nz, logp=True, precip=True,
                           sst=False, tisr=False)
    I, O = lay_in.total, lay_out.total
    S = O - xc * yc  # speedy vector: output minus precip block

    Rc = cls.count
    radius = radius_by_lat(layout.lat_start[cls.region_ids],
                           layout.lat_end[cls.region_ids])
    cols, vals, win, shifts = generate(key, Rc, I, hyper, radius, dtype=dtype,
                                       radius_iters=radius_iters,
                                       topology=topology)
    n = vals.shape[2]
    if skip_wout:
        wout = jnp.zeros((Rc, O, 0), dtype=dtype)
    else:
        wout = 1e-3 * jax.random.normal(jax.random.fold_in(key, 5),
                                        (Rc, O, S + n), dtype=dtype)

    nc = n_components(NVAR, nz, logp=True, precip=True, sst=True, tisr=True)
    comp_in = component_expansion(xi, yi, NVAR, nz, logp=True, precip=True,
                                  sst=True, tisr=True)
    comp_out = component_expansion(xc, yc, NVAR, nz, logp=True, precip=True,
                                   sst=False, tisr=False)
    ones_c = jnp.ones((Rc, nc), dtype=dtype)
    # physically plausible offsets so the assembled grid is SPEEDY-safe
    mean_c = jnp.zeros((Rc, nc), dtype=dtype)
    # temperature components (var 0) get a 250 K offset
    mean_np = np.zeros((1, nc))
    mean_np[:, 0:nz] = 250.0
    mean_c = jnp.broadcast_to(jnp.asarray(mean_np, dtype=dtype), (Rc, nc))
    std = Standardizer(comp_mean=mean_c, comp_std=ones_c,
                       in_mean=mean_c[:, comp_in], in_std=ones_c[:, comp_in],
                       out_mean=mean_c[:, comp_out],
                       out_std=ones_c[:, comp_out])
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, n_in=I, wout=wout,
                           mean=std.in_mean, std=std.in_std, shifts=shifts)
    return ClassPack(cls=cls, res=res, hyper=hyper, std=std)


def build_untrained_hybrid(gcm, n_regions: int = 1152, m: int = 6000,
                           key=None, ml_only: bool = False,
                           radius_iters: int = 30,
                           topology: str = "shift") -> HybridAtmosphere:
    key = key if key is not None else jax.random.PRNGKey(0)
    layout = RegionLayout(gcm.geom, n_regions=n_regions, overlap=1)
    hyper = ESNHyper(m=m)
    # Structure generation (host-side graph build + power iteration) on
    # the host device; the big Wout is generated directly on the default
    # device to avoid a multi-GB host->device transfer.
    import dataclasses

    from speedy_ml_tpu.runtime.jax_setup import host_device, on_host
    with on_host():
        packs = [untrained_pack(layout, cls, hyper,
                                jax.random.fold_in(key, i), gcm.geom.nlev,
                                dtype=gcm.dtype, radius_iters=radius_iters,
                                skip_wout=True, topology=topology)
                 for i, cls in enumerate(layout.classes)]
    out = []
    # move host-built arrays to the default device when that is another
    # device.  device_put MUST name the target: without it, arrays that
    # already live on the CPU backend STAY there, and every jitted call
    # re-sends them host->device
    dev = jax.devices()[0]
    to_dev = ((lambda t: t) if host_device() == dev
              else (lambda t: jax.device_put(t, dev)))
    for i, p in enumerate(packs):
        res, std = to_dev(p.res), to_dev(p.std)
        Rc, O = p.cls.count, p.res.n_outputs
        xc, yc = p.cls.core_shape
        # speedy vec = output minus precip block; absent in ml_only readout
        S = 0 if ml_only else O - xc * yc
        n = p.res.n
        wout = 1e-3 * jax.random.normal(jax.random.fold_in(key, 1000 + i),
                                        (Rc, O, S + n), dtype=gcm.dtype)
        res = dataclasses.replace(res, wout=wout)
        out.append(ClassPack(cls=p.cls, res=res, hyper=p.hyper, std=std))
    return HybridAtmosphere(gcm, layout, out, ml_only=ml_only)
