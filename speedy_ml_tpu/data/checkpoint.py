"""Checkpointing: trained hybrid weights save/load + reference import.

Three formats (SURVEY 5: checkpoint families):
1. native .npz bundles per region class (this framework's format);
2. import of the reference's per-worker NetCDF4 weight files
   (write_trained_res, mod_reservoir.f90:1701-1779: variables win, wout,
   rows, cols, vals, mean, std in files worker_NNNN_level_N_<trial>.nc —
   the Zenodo 10.5281/zenodo.7548902 artifact) via h5py: NetCDF4 is HDF5;
3. GCM restart = the SpectralState pytree itself (np.savez of its leaves).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.esn.reservoir import BatchedReservoir, ESNHyper
from speedy_ml_tpu.esn.standardize import Standardizer


# Checkpoint format history:
#   (unversioned) round-1 early: res_vals row-major (R, n, J), no 'shifts'
#   2: res_vals slot-major (J, R, n); optional 'shifts' key (shift topology)
FORMAT_VERSION = 2


def save_hybrid(hyb, path: str):
    """Save all class packs (+ ocean) of a HybridAtmosphere to `path`/ .

    Weight files are uncompressed .npz: float weights shrink by ~7% under
    deflate, which runs at ~23 MB/s on them, so compressing the 3.8 GB f32
    Wout of the production layout would add close to three minutes."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    meta = {"format_version": FORMAT_VERSION, "vals_layout": "slot_major",
            "n_classes": len(hyb.packs), "ml_only": hyb.ml_only,
            "has_ocean": hyb.ocean_packs is not None}
    for i, pk in enumerate(hyb.packs):
        arrs = {f"res_{k}": np.asarray(getattr(pk.res, k))
                for k in ("cols", "vals", "win_vals", "wout", "mean", "std")}
        arrs.update({f"std_{k}": np.asarray(getattr(pk.std, k))
                     for k in ("comp_mean", "comp_std", "in_mean", "in_std",
                               "out_mean", "out_std")})
        arrs["n_in"] = np.asarray(pk.res.n_in)
        arrs["region_ids"] = pk.cls.region_ids
        if pk.res.shifts is not None:
            arrs["shifts"] = np.asarray(pk.res.shifts, dtype=np.int64)
        if pk.res.win_cols is not None:
            # ragged per-row Win gather map (reference-imported packs,
            # reference_import.assemble_reference_class) — without it a
            # reload silently falls back to the uniform-repeat Win path
            arrs["win_cols"] = np.asarray(pk.res.win_cols, dtype=np.int32)
        np.savez(p / f"class_{i}.npz", **arrs)
        meta[f"hyper_{i}"] = dataclasses.asdict(pk.hyper)
        if pk.zspec is not None:
            meta[f"zspec_{i}"] = list(pk.zspec)
    if hyb.ocean_packs:
        for i, op in enumerate(hyb.ocean_packs):
            arrs = {f"res_{k}": np.asarray(getattr(op.res, k))
                    for k in ("cols", "vals", "win_vals", "wout", "mean", "std")}
            arrs["n_in"] = np.asarray(op.res.n_in)
            arrs["idx_map"] = op.idx_map
            if op.res.shifts is not None:
                arrs["shifts"] = np.asarray(op.res.shifts, dtype=np.int64)
            arrs["mean_sst"] = np.asarray(op.mean_sst)
            arrs["std_sst"] = np.asarray(op.std_sst)
            np.savez(p / f"ocean_{i}.npz", **arrs)
            meta[f"ocean_hyper_{i}"] = dataclasses.asdict(op.hyper)
            meta[f"ocean_hybrid_{i}"] = bool(op.hybrid_readout)
        if hyb.base_sst is not None:
            np.savez_compressed(p / "ocean_aux.npz",
                                base_sst=np.asarray(hyb.base_sst),
                                sea_mask=np.asarray(hyb.sea_mask))
    (p / "meta.json").write_text(json.dumps(meta, indent=1))


def load_hybrid(gcm, layout, path: str, dtype=jnp.float32):
    """Rebuild a HybridAtmosphere from save_hybrid output."""
    from speedy_ml_tpu.hybrid.model import (ClassPack, HybridAtmosphere,
                                            OceanPack)
    p = Path(path)
    meta = json.loads((p / "meta.json").read_text())
    ver = meta.get("format_version", 1)
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint at {path} has format_version {ver}; this build "
            f"reads version {FORMAT_VERSION} (res_vals slot-major (J, R, n)). "
            "Re-save the checkpoint with the matching build.")
    packs = []
    for i in range(meta["n_classes"]):
        z = np.load(p / f"class_{i}.npz")
        f = lambda k: jnp.asarray(z[k], dtype=dtype)
        fi = lambda k: jnp.asarray(z[k])
        cols = fi("res_cols")
        # layout sanity: slot-major vals (J, R, n) must agree with
        # win_vals (R, n) on both trailing dims
        if (z["res_vals"].shape[1:] != z["res_win_vals"].shape
                or (z["res_vals"].shape[0] > z["res_vals"].shape[2])):
            raise ValueError(
                f"class_{i}: res_vals shape {z['res_vals'].shape} is not "
                f"slot-major (J, R, n) consistent with win_vals "
                f"{z['res_win_vals'].shape}")
        shifts = (tuple(int(s) for s in z["shifts"])
                  if "shifts" in z.files else None)
        win_cols = (jnp.asarray(z["win_cols"])
                    if "win_cols" in z.files else None)
        res = BatchedReservoir(cols=cols, vals=f("res_vals"),
                               win_vals=f("res_win_vals"), wout=f("res_wout"),
                               mean=f("res_mean"), std=f("res_std"),
                               n_in=int(z["n_in"]), shifts=shifts,
                               win_cols=win_cols)
        std = Standardizer(comp_mean=f("std_comp_mean"),
                           comp_std=f("std_comp_std"),
                           in_mean=f("std_in_mean"), in_std=f("std_in_std"),
                           out_mean=f("std_out_mean"),
                           out_std=f("std_out_std"))
        hyper = ESNHyper(**meta[f"hyper_{i}"])
        zspec = None
        if f"zspec_{i}" in meta:
            from speedy_ml_tpu.esn.domain import VertSpec
            zspec = VertSpec(*meta[f"zspec_{i}"])
        # with vertical localization classes repeat per group in
        # class-major/group-minor order
        n_groups = max(1, meta["n_classes"] // len(layout.classes))
        packs.append(ClassPack(cls=layout.classes[i // n_groups], res=res,
                               hyper=hyper, std=std, zspec=zspec))
    ocean_packs = None
    base_sst = sea_mask = None
    if meta.get("has_ocean"):
        ocean_packs = []
        for i in range(meta["n_classes"]):
            z = np.load(p / f"ocean_{i}.npz")
            f = lambda k: jnp.asarray(z[k], dtype=dtype)
            o_shifts = (tuple(int(s) for s in z["shifts"])
                        if "shifts" in z.files else None)
            res = BatchedReservoir(cols=jnp.asarray(z["res_cols"]),
                                   vals=f("res_vals"),
                                   win_vals=f("res_win_vals"),
                                   wout=f("res_wout"), mean=f("res_mean"),
                                   std=f("res_std"), n_in=int(z["n_in"]),
                                   shifts=o_shifts)
            hyper = ESNHyper(**meta[f"ocean_hyper_{i}"])
            ocean_packs.append(OceanPack(
                cls=layout.classes[i], res=res, hyper=hyper,
                idx_map=z["idx_map"], mean_sst=f("mean_sst"),
                std_sst=f("std_sst"),
                hybrid_readout=meta.get(f"ocean_hybrid_{i}", False)))
        aux = np.load(p / "ocean_aux.npz")
        base_sst = jnp.asarray(aux["base_sst"], dtype=dtype)
        sea_mask = jnp.asarray(aux["sea_mask"])
    return HybridAtmosphere(gcm, layout, packs, ml_only=meta["ml_only"],
                            ocean_packs=ocean_packs, base_sst=base_sst,
                            sea_mask=sea_mask)


# ----------------------------------------------------------------------
# GCM restart (family 2 of the reference's checkpoints: ppo_restart.f90)
# ----------------------------------------------------------------------

def save_gcm_restart(gstate, path: str):
    """Spectral + surface + radiation state to one npz (restart write)."""
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(gstate)
    np.savez_compressed(path, n_leaves=len(leaves),
                        **{f"leaf_{i}": np.asarray(l)
                           for i, l in enumerate(leaves)})


def load_gcm_restart(path: str, template):
    """Restore a GCMState saved by save_gcm_restart; `template` provides
    the pytree structure (e.g. a freshly built init_state)."""
    import jax
    z = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    n = int(z["n_leaves"])
    assert n == len(leaves), "restart structure mismatch"
    new_leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


# ----------------------------------------------------------------------
# reference weight import (Zenodo artifact)
# ----------------------------------------------------------------------

def read_reference_worker(path: str) -> dict:
    """Read one reference worker weight file — moved to
    data.reference_import (which owns the full end-to-end assembly);
    kept here as a re-export for round-1 callers."""
    from speedy_ml_tpu.data.reference_import import \
        read_reference_worker as _r
    return _r(path)


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    """COO (1-based Fortran indices) -> ELL (cols, vals) padded arrays."""
    r = rows.astype(np.int64) - 1
    c = cols.astype(np.int64) - 1
    counts = np.bincount(r, minlength=n)
    J = int(counts.max())
    ell_cols = np.zeros((n, J), dtype=np.int32)
    ell_vals = np.zeros((n, J), dtype=np.float64)
    slot = np.zeros(n, dtype=np.int64)
    for i in range(len(r)):
        ri = r[i]
        ell_cols[ri, slot[ri]] = c[i]
        ell_vals[ri, slot[ri]] = vals[i]
        slot[ri] += 1
    return ell_cols, ell_vals


def win_to_rowvals(win: np.ndarray) -> np.ndarray:
    """Block-diagonal Win (n, I) -> per-row values (n,).

    The reference fills rows (i-1)q+1..iq of column i
    (mod_reservoir.f90:270-278); verify the structure and compress."""
    n, I = win.shape
    q = n // I
    row_col = np.arange(n) // q
    vals = win[np.arange(n), row_col]
    # structure check: everything off the block diagonal must be zero
    w2 = win.copy()
    w2[np.arange(n), row_col] = 0.0
    if np.abs(w2).max() > 0:
        raise ValueError("win is not block-diagonal; cannot compress")
    return vals
