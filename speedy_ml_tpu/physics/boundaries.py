"""Boundary-condition data: orography, masks, monthly climatologies.

Reads the reference's fort.2x direct-access boundary files
(ini_inbcon.f90:463-495 documents the record layout: one little-endian
float32 row of nlon per record, rows stored north->south) and assembles a
`BoundaryData` pytree.  The loader also exports/imports a clean .npz so
deployments don't depend on Fortran unit-file conventions.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.physics import constants as pc

THRSH = 0.1   # land/sea fraction threshold


def read_boundary_records(path: str | Path, offset: int, nlon: int, nlat: int
                          ) -> np.ndarray:
    """Read one (nlat, nlon) field at record-group `offset`; south->north rows."""
    count = nlat * nlon
    size = Path(path).stat().st_size
    if size % (count * 4):
        raise ValueError(
            f"{path}: size {size} is not a multiple of {nlat}x{nlon} "
            "records — boundary file resolution does not match the grid")
    with open(path, "rb") as f:
        f.seek(offset * count * 4)
        raw = np.fromfile(f, dtype="<f4", count=count)
    if raw.size < count:
        raise ValueError(f"{path}: record {offset} out of range")
    field = raw.reshape(nlat, nlon)[::-1].astype(np.float64)  # file is N->S
    field[field <= -999] = 0.0
    return field


def fillsf(sf: np.ndarray, fmis: float = 0.0) -> np.ndarray:
    """Replace missing values working equator->poles (ini_inbcon.f90:412-461)."""
    sf = sf.copy()
    nlat, nlon = sf.shape
    halves = [range(nlat // 2 - 1, -1, -1), range(nlat // 2, nlat)]
    for rows in halves:
        for j in rows:
            row = sf[j]
            miss = row < fmis
            nmis = miss.sum()
            if nmis == 0:
                continue
            if nmis < nlon:
                fmean = row[~miss].sum() / (nlon - nmis)
            sf2 = np.where(miss, fmean, row)
            ext = np.concatenate([[sf2[-1]], sf2, [sf2[0]]])
            sf[j] = np.where(miss, 0.5 * (ext[:-2] + ext[2:]), row)
    return sf


def forchk(mask: np.ndarray, field: np.ndarray, fset: float) -> np.ndarray:
    """Set undefined (mask==0) points to fset (ini_inbcon.f90:283-313)."""
    return np.where(mask > 0.0, field, fset)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BoundaryData:
    """Time-invariant surface fields + monthly climatologies (device arrays)."""
    orog: jnp.ndarray       # surface geopotential g*z (unfiltered)
    phis0: jnp.ndarray      # spectrally truncated surface geopotential (grid)
    fmask: jnp.ndarray      # fractional land-sea mask (1 = land)
    fmask_l: jnp.ndarray    # model land fraction (thresholded)
    bmask_l: jnp.ndarray
    fmask_s: jnp.ndarray
    bmask_s: jnp.ndarray
    alb0: jnp.ndarray       # bare-land annual-mean albedo
    stl12: jnp.ndarray      # (12, lat, lon) land sfc temperature
    snowd12: jnp.ndarray    # (12, lat, lon) snow depth [mm]
    soilw12: jnp.ndarray    # (12, lat, lon) soil water availability
    sst12: jnp.ndarray      # (12, lat, lon)
    sice12: jnp.ndarray     # (12, lat, lon) sea-ice fraction
    forog: jnp.ndarray      # orographic drag factor (sflset)


def load_boundary_data(geom, sht, grav: float = 9.81,
                       path: str | None = None) -> BoundaryData:
    """Load fort.20-26 boundary files and derive masks/filtered orography.

    path defaults to $SPEEDY_ML_BC_PATH; with neither, FileNotFoundError.
    """
    from speedy_ml_tpu.physics.surface import sflset
    from speedy_ml_tpu.runtime.jax_setup import on_host

    path = path or os.environ.get("SPEEDY_ML_BC_PATH")
    if not path:
        raise FileNotFoundError(
            "no boundary-data directory: pass path or set SPEEDY_ML_BC_PATH")
    path = Path(path)
    nlon, nlat = geom.nlon, geom.nlat
    rd = lambda unit, off: read_boundary_records(path / f"fort.{unit}", off,
                                                 nlon, nlat)

    orog_m = rd(20, 0)
    phi0 = grav * orog_m
    # spectral truncation of the surface geopotential (truncg at ntrun):
    # a static table, computed on the host device and kept as numpy
    with on_host():
        phis_spec = sht.grid_to_spec(jnp.asarray(phi0, dtype=sht.dtype))
        phis0 = np.asarray(sht.spec_to_grid(sht.trunct(phis_spec)),
                           dtype=np.float64)

    fmask = rd(20, 1)
    fmask_l = fmask.copy()
    bmask_l = np.where(fmask_l >= THRSH, 1.0, 0.0)
    fmask_l = np.where(fmask_l >= THRSH,
                       np.where(fmask > 1.0 - THRSH, 1.0, fmask_l), 0.0)
    fmask_s = 1.0 - fmask
    bmask_s = np.where(fmask_s >= THRSH, 1.0, 0.0)
    fmask_s = np.where(fmask_s >= THRSH,
                       np.where(fmask_s > 1.0 - THRSH, 1.0, fmask_s), 0.0)

    alb0 = rd(20, 2)

    stl12 = np.stack([forchk(bmask_l, fillsf(rd(23, it)), 273.0)
                      for it in range(12)])
    snowd12 = np.stack([forchk(bmask_l, rd(24, it), 0.0) for it in range(12)])

    # soil water availability from layered soil moisture + vegetation
    veg = np.maximum(0.0, rd(20, 3) + 0.8 * rd(20, 4))
    sdep1, idep2 = 70.0, 3
    swwil2 = idep2 * pc.SWWIL
    rsw = 1.0 / (pc.SWCAP + idep2 * (pc.SWCAP - pc.SWWIL))
    soilw = []
    for it in range(12):
        swl1 = rd(26, 3 * it)
        swl2 = rd(26, 3 * it + 1)
        swroot = idep2 * swl2
        soilw.append(np.minimum(
            1.0, rsw * (swl1 + veg * np.maximum(0.0, swroot - swwil2))))
    soilw12 = np.stack([forchk(bmask_l, s, 0.0) for s in soilw])

    sst12 = np.stack([forchk(bmask_s, fillsf(rd(21, it)), 273.0)
                      for it in range(12)])
    sice12 = np.stack([forchk(bmask_s, np.maximum(rd(22, it), 0.0), 0.0)
                       for it in range(12)])

    f = lambda x: np.asarray(x, dtype=sht.dtype)
    return BoundaryData(
        orog=f(phi0), phis0=f(phis0), fmask=f(fmask), fmask_l=f(fmask_l),
        bmask_l=f(bmask_l), fmask_s=f(fmask_s), bmask_s=f(bmask_s),
        alb0=f(alb0), stl12=f(stl12), snowd12=f(snowd12), soilw12=f(soilw12),
        sst12=f(sst12), sice12=f(sice12),
        forog=f(sflset(phis0, grav)))


def synthetic_boundary_data(geom, sht, grav: float = 9.81,
                            land: bool = False) -> BoundaryData:
    """Analytic aquaplanet (or uniform-land) boundary data for testing and
    for running the model at non-standard resolutions without data files."""
    from speedy_ml_tpu.physics.surface import sflset

    nlat, nlon = geom.nlat, geom.nlon
    zeros = np.zeros((nlat, nlon))
    ones = np.ones((nlat, nlon))
    fmask = ones.copy() if land else zeros.copy()
    lat = geom.lat_radians
    # zonally symmetric SST climatology with a mild seasonal cycle
    sst12 = np.stack([
        273.0 + 27.0 * np.cos(lat)[:, None] ** 2 * ones
        + 2.0 * np.sin(lat)[:, None] * np.cos(2 * np.pi * (m - 0.5) / 12) * ones
        for m in range(12)])
    sst12 = np.maximum(sst12, 271.4)
    stl12 = sst12.copy()
    f = lambda x: np.asarray(x, dtype=sht.dtype)
    return BoundaryData(
        orog=f(zeros), phis0=f(zeros), fmask=f(fmask),
        fmask_l=f(fmask), bmask_l=f(fmask), fmask_s=f(1.0 - fmask),
        bmask_s=f(1.0 - fmask), alb0=f(0.1 * ones),
        stl12=f(stl12), snowd12=f(np.zeros((12, nlat, nlon))),
        soilw12=f(0.5 * np.ones((12, nlat, nlon))),
        sst12=f(sst12), sice12=f(np.zeros((12, nlat, nlon))),
        forog=f(sflset(zeros, grav)))


SYNTHETIC = "synthetic aquaplanet"


def resolve_boundary_data(geom, sht, grav: float = 9.81,
                          path: str | None = None
                          ) -> tuple[BoundaryData, str]:
    """The single rule for which boundary data a model runs on.

    - an explicit `path` is configuration: load the fort.2x files from
      it, and let a missing or bad directory raise (a typo must not
      silently train on the aquaplanet);
    - $SPEEDY_ML_BC_PATH counts the same at the files' own 96x48 grid;
      other grids have no data files (a grid that happens to divide the
      record size would read garbage), so it is ignored there;
    - otherwise use the synthetic aquaplanet and say so.
    Returns (BoundaryData, source), source being the directory or
    SYNTHETIC."""
    if not path and (geom.nlon, geom.nlat) == (96, 48):
        path = os.environ.get("SPEEDY_ML_BC_PATH")
    if path:
        return load_boundary_data(geom, sht, grav, path=path), str(path)
    import warnings
    warnings.warn(f"no boundary-data path configured (bc_path or "
                  f"SPEEDY_ML_BC_PATH at 96x48): using the {SYNTHETIC}",
                  stacklevel=2)
    return synthetic_boundary_data(geom, sht, grav), SYNTHETIC


def save_npz(bd: BoundaryData, path: str):
    np.savez_compressed(path, **{k: np.asarray(getattr(bd, k))
                                 for k in bd.__dataclass_fields__})


def load_npz(path: str, dtype=jnp.float32) -> BoundaryData:
    z = np.load(path)
    f = lambda x: np.asarray(x, dtype=dtype)
    return BoundaryData(**{k: f(z[k]) for k in BoundaryData.__dataclass_fields__})
