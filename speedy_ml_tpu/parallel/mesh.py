"""Device mesh and sharding for the hybrid model.

The reference's parallelism is 1,152 MPI ranks, one region each, with a
rank-0 hub for the global grid (SURVEY 2.3).  The layout here is a 1-D
mesh over the devices of one host (GPUs joined all to all by NVLink, so
the mesh follows the algorithm alone):

- axis "regions": the batched-reservoir leading axis R is sharded across
  devices (the data/expert-parallel axis — each region has its own
  weights, like hard-routed experts);
- the global (lat, lon) grid and the GCM spectral state are replicated;
  scatters/gathers between sharded region vectors and the replicated
  grid compile to XLA all-gathers — no rank-0 hub, no point-to-point
  plumbing;
- training normal equations (R, A, A) shard over the same axis, so each
  device holds only its regions' Gram matrices (the dominant memory).

Across hosts the same mesh would span them; only the region axis moves
data, and only during the global assembly — the all-gather of core
patches, a few MB.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "regions") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def region_sharding(mesh: Mesh, ndim: int, axis: str = "regions"
                    ) -> NamedSharding:
    """Shard the leading (region) axis; replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_reservoir(res, mesh: Mesh, axis: str = "regions"):
    """Place a BatchedReservoir with its region axis sharded.

    vals is slot-major (J, R, n) -> region axis is axis 1; a shared
    sparsity pattern (cols (n, J)) is replicated, a per-region pattern
    (cols (R, n, J)) shards its leading axis."""
    import dataclasses
    put = lambda a: jax.device_put(a, region_sharding(mesh, a.ndim, axis))
    cols = (jax.device_put(res.cols, replicated(mesh)) if res.cols.ndim == 2
            else put(res.cols))
    vals = jax.device_put(
        res.vals, NamedSharding(mesh, P(None, axis, None)))
    return dataclasses.replace(
        res, cols=cols, vals=vals, win_vals=put(res.win_vals),
        wout=put(res.wout), mean=put(res.mean), std=put(res.std))


def pad_regions(n: int, n_devices: int) -> int:
    """Regions per class must divide the mesh for even sharding; pad count."""
    return ((n + n_devices - 1) // n_devices) * n_devices
