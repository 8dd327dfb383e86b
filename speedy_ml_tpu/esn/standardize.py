"""Per-region standardization of packed state vectors.

Reference: the standardize_* overloads of mod_utilities.f90 and
res_domain.f90:1189-1540.  Scalars are per (variable, level) per region —
mean/std layout [v0_z0..v0_zK, v1_z0.., ..., logp, precip, sst, tisr]
(input_grid_to_input_statevec_and_standardization,
res_domain.f90:1209-1246) — here pre-expanded to per-element vectors so
application is a fused multiply-add on the packed vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.esn.domain import RegionClass, VectorLayout, build_layout


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Standardizer:
    """Per-region component scalars + expanded per-element vectors."""
    comp_mean: jnp.ndarray   # (R, C) per-component scalars
    comp_std: jnp.ndarray
    in_mean: jnp.ndarray     # (R, I) expanded over the input vector
    in_std: jnp.ndarray
    out_mean: jnp.ndarray    # (R, O) expanded over the target vector
    out_std: jnp.ndarray

    def standardize_input(self, vec: jnp.ndarray) -> jnp.ndarray:
        return (vec - self.in_mean) / self.in_std

    def unstandardize_input(self, vec: jnp.ndarray) -> jnp.ndarray:
        return vec * self.in_std + self.in_mean

    def standardize_output(self, vec: jnp.ndarray) -> jnp.ndarray:
        return (vec - self.out_mean) / self.out_std

    def unstandardize_output(self, vec: jnp.ndarray) -> jnp.ndarray:
        return vec * self.out_std + self.out_mean


def component_expansion(nx: int, ny: int, nvar: int, nz: int, *, logp: bool,
                        precip: bool, sst: bool, tisr: bool) -> np.ndarray:
    """Map each element of a packed vector to its component index.

    Component order: (v, z) pairs with z fastest (l = v*nz + z, matching
    the l counter of the reference), then logp, precip, sst, tisr."""
    lay = build_layout(nx, ny, nvar, nz, logp=logp, precip=precip,
                       sst=sst, tisr=tisr)
    comp = np.zeros(lay.total, dtype=np.int32)
    # atmo block is flattened from (z, y, x, v) C-order
    idx = np.arange(nvar * nx * ny * nz).reshape(nz, ny, nx, nvar)
    v = np.broadcast_to(np.arange(nvar)[None, None, None, :], idx.shape)
    z = np.broadcast_to(np.arange(nz)[:, None, None, None], idx.shape)
    comp[idx.ravel()] = (v * nz + z).ravel()
    c = nvar * nz
    for name in ("logp", "precip", "sst", "tisr"):
        sl = getattr(lay, name)
        if sl is not None:
            comp[sl[0]:sl[1]] = c
            c += 1
    return comp


def n_components(nvar: int, nz: int, *, logp: bool, precip: bool, sst: bool,
                 tisr: bool) -> int:
    return nvar * nz + sum([logp, precip, sst, tisr])


def core_component_map(nx: int, ny: int, nvar: int, nz_in: int,
                       nz_core: int, z_off: int, *, logp: bool,
                       precip: bool) -> np.ndarray:
    """Component ids of a packed CORE vector, expressed in the INPUT
    vector's component numbering.

    Needed for vertical localization: the core owns levels
    [z_off, z_off+nz_core) of the input window, so core (v, z) shares the
    input component v*nz_in + z + z_off (standardize/unstandardize of
    targets reuse the input statistics, res_domain.f90:1189-1540)."""
    comp = component_expansion(nx, ny, nvar, nz_core, logp=logp,
                               precip=precip, sst=False, tisr=False)
    a_small = nvar * nz_core
    v = comp // nz_core
    z = comp % nz_core
    out = np.where(comp < a_small, v * nz_in + z + z_off,
                   comp - a_small + nvar * nz_in)
    return out.astype(np.int32)


def floor_component_std(std_c: jnp.ndarray, nvar: int, nz: int,
                        frac: float = 0.01) -> jnp.ndarray:
    """Per-variable relative floor on component stds (R, C).

    Near-constant components (stratospheric humidity in a nature run,
    desert precipitation, polar-night TISR) get tiny stds; standardized
    model errors there reach z ~ 1e3-1e5 and the prediction cycle's
    local-model feedback amplifies them into a runaway.  Each atmo
    component's std is floored at `frac` of its VARIABLE's largest
    median-over-regions level std; 2-D fields floor against their own
    median over regions (tames regionally-degenerate components while
    leaving well-conditioned ones untouched).  The reference never hits
    this because ERA5 truth gives every component real variance."""
    med = jnp.median(std_c, axis=0)                      # (C,)
    floors = []
    for v in range(nvar):
        scale_v = jnp.max(med[v * nz:(v + 1) * nz])
        floors.append(jnp.full((nz,), frac * scale_v))
    n2d = std_c.shape[1] - nvar * nz
    floors.append(frac * med[nvar * nz:])
    floor_c = jnp.concatenate(floors)
    return jnp.maximum(std_c, floor_c[None, :])


def component_sums(series: jnp.ndarray, onehot) -> tuple:
    """Per-region first and second moments pooled per component:
    series (T, R, I), onehot (I, C) -> (sum x, sum x^2), each (R, C).

    Precision HIGHEST: the sums pool thousands of samples, and a float32
    contraction at default precision may round its inputs to TF32
    (10-bit mantissa) on tensor-core GPUs — a ~5e-4 relative error in
    every standardization scalar."""
    hi = jax.lax.Precision.HIGHEST
    s1 = jnp.einsum("tri,ic->rc", series, onehot, precision=hi)
    s2 = jnp.einsum("tri,ic->rc", series * series, onehot, precision=hi)
    return s1, s2


def compute_standardizer(series: jnp.ndarray, comp_map_in: np.ndarray,
                         comp_map_out: np.ndarray, n_comp: int,
                         nvar_nz=None, std_floor: float = 0.01
                         ) -> Standardizer:
    """Fit per-component mean/std from a packed input series (T, R, I).

    The statistics pool all elements sharing a component (all gridpoints
    of one variable/level in the region, over time), as the reference's
    standardize_data overloads do.  nvar_nz, when given as (nvar, nz),
    applies the per-variable relative std floor (floor_component_std)."""
    T, R, I = series.shape
    cm = jnp.asarray(comp_map_in)
    onehot = jax.nn.one_hot(cm, n_comp, dtype=series.dtype)      # (I, C)
    count = jnp.maximum(onehot.sum(axis=0) * T, 1.0)             # (C,)
    s1, s2 = component_sums(series, onehot)
    mean_c = s1 / count
    var_c = s2 / count - mean_c**2
    # constant components (frozen polar SST, dry-region precip) must
    # standardize to ~0, not blow up through a ~0 std: unit std there
    std_c = jnp.where(var_c < 1e-12, 1.0, jnp.sqrt(jnp.maximum(var_c, 0.0)))
    if nvar_nz is not None:
        std_c = floor_component_std(std_c, *nvar_nz, frac=std_floor)
    in_mean = mean_c[:, cm]
    in_std = std_c[:, cm]
    cmo = jnp.asarray(comp_map_out)
    return Standardizer(comp_mean=mean_c, comp_std=std_c,
                        in_mean=in_mean, in_std=in_std,
                        out_mean=mean_c[:, cmo], out_std=std_c[:, cmo])
