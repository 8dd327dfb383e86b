"""Explicit halo exchange over the device mesh (shard_map + ppermute).

The reference materializes halos through the rank-0 hub: root assembles
the full grid and re-tiles per-region windows (sendrecievegrid,
mpires.f90:218-780).  On one device the XLA-compiled gathers from a
replicated grid are fine (round-1 design), but a mesh should not
all-gather the globe every cycle.  This module is the peer-to-peer path:
the global (lat, lon) grid lives LAT-SHARDED across devices, and each
cycle only the `overlap` edge rows move between lat-neighbor devices — a
ring ppermute, O(overlap * nlon) bytes per device instead of
O(nlat * nlon).

Latitude bands map naturally onto a mesh axis because the region tiling
is a regular block grid (res_domain.f90:258-280): device d owns rows
[d*nlat/D, (d+1)*nlat/D) and every region whose core lies in that band.
Pole edges do not wrap (windows are clipped at the poles,
res_domain.f90:155-204); the wrapped rows a ring delivers there are
masked to zero so any accidental use is loud.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def lat_sharding(mesh: Mesh, ndim: int, lat_axis_pos: int = -2,
                 axis: str = "regions") -> NamedSharding:
    """Shard the latitude axis (second-to-last by convention)."""
    spec = [None] * ndim
    spec[lat_axis_pos] = axis
    return NamedSharding(mesh, P(*spec))


def halo_exchange_lat(field: jnp.ndarray, overlap: int, mesh: Mesh,
                      axis: str = "regions") -> jnp.ndarray:
    """Exchange `overlap` edge rows between lat-neighbor shards.

    field: (..., lat, lon) sharded over lat (lat % n_devices == 0).
    Returns (..., n_dev*(band+2*overlap), lon): each device's haloed band
    [south halo | band | north halo], stacked along lat.  South halo of
    the southernmost shard and north halo of the northernmost are ZERO
    (pole clipping; the ring's wrapped rows are masked out)."""
    D = mesh.shape[axis]

    def block(f):
        # f: (..., band, lon) local shard
        idx = jax.lax.axis_index(axis)
        fwd = [(i, (i + 1) % D) for i in range(D)]   # send north
        bwd = [(i, (i - 1) % D) for i in range(D)]   # send south
        # rows arriving from the SOUTH neighbor (its top rows)
        south = jax.lax.ppermute(f[..., -overlap:, :], axis, fwd)
        # rows arriving from the NORTH neighbor (its bottom rows)
        north = jax.lax.ppermute(f[..., :overlap, :], axis, bwd)
        south = jnp.where(idx == 0, 0.0, south)       # no wrap past S pole
        north = jnp.where(idx == D - 1, 0.0, north)   # no wrap past N pole
        return jnp.concatenate([south, f, north], axis=-2)

    ndim = field.ndim
    in_spec = P(*([None] * (ndim - 2)), axis, None)
    return shard_map(block, mesh=mesh, in_specs=(in_spec,),
                     out_specs=in_spec)(field)


def haloed_band(haloed: jnp.ndarray, d: int, band: int, overlap: int
                ) -> jnp.ndarray:
    """Slice device d's haloed band out of halo_exchange_lat's output."""
    w = band + 2 * overlap
    return haloed[..., d * w:(d + 1) * w, :]
