"""Batched echo-state networks.

Reference: mod_reservoir.f90 (gen_res/makesparse, reservoir_layer,
synchronize, predict).  Design differences from the Fortran:

- all regions live in ONE batched program: every array carries a leading
  region axis R, sharded over the device mesh (the reference assigns one
  region per MPI rank);
- the sparse adjacency uses an ELL layout (n, J) with near-uniform row
  degree — the reference's makesparse (mod_linalg.f90:180-218) draws
  row/col indices from concatenated random permutations, which makes row
  degrees {floor(k/n), floor(k/n)+1}, so J = floor(k/n)+1 pads almost
  nothing.  A x becomes J batched gathers + a small sum (memory-bound),
  the input coupling Win u is a broadcast multiply and the readout a
  batched matrix-vector product;
- the spectral radius is found by batched power iteration instead of
  ARPACK (fixed iteration count for determinism);
- RNG is explicit (jax.random keys derived per region), replacing the
  per-worker seeded Fortran RNG.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedReservoir:
    """Per-region reservoir weights, batched over the leading region axis R.

    Shapes (R regions, n nodes, J nnz/row, I inputs, O outputs, S speedy):
      cols: (R, n, J) int32   ELL column indices of A
      vals: (J, R, n)         ELL values of A (scaled to spectral radius).
                              Slot-major: each slot j is one contiguous
                              (R, n) plane, so every term of the spmv is
                              a plain elementwise multiply-add over it
      win_vals: (R, n)        input coupling values.  Win is block-diagonal
                              (the reference fills rows (i-1)q+1..iq of
                              column i, mod_reservoir.f90:270-278), so one
                              value per row suffices; the implicit column
                              of row j is j // (n/I).
      wout: (R, O, S + n)     readout on [local_model ; x-with-even-squared]
      mean: (R, I)            standardization mean per input element
      std:  (R, I)
      n_in: static input count (needed to derive the Win block map)
    """
    cols: jnp.ndarray
    vals: jnp.ndarray
    win_vals: jnp.ndarray
    wout: jnp.ndarray
    mean: jnp.ndarray
    std: jnp.ndarray
    n_in: int = dataclasses.field(metadata=dict(static=True), default=0)
    # shift topology (the default): cols[i, j] = (i + s_j) mod n for J
    # static shifts s_j.  A x = sum_j vals[:,:,j] * roll(x, -s_j) — pure
    # contiguous memory traffic, no gathers.  None -> the gather path
    # over `cols` (ell_spmv).
    shifts: tuple | None = dataclasses.field(
        metadata=dict(static=True), default=None)
    # per-row input index map (R, n) int32 for Win, used when the block
    # structure is NOT uniform (reference-imported reservoirs are ragged:
    # land regions drop the SST input block, so q = n/I varies per region
    # and padded rows must read a shifted input position).  None -> the
    # uniform repeat-broadcast path.
    win_cols: jnp.ndarray | None = None

    @property
    def n(self):
        return self.win_vals.shape[1]

    @property
    def n_inputs(self):
        return self.n_in

    @property
    def n_outputs(self):
        return self.wout.shape[1]

    @property
    def n_speedy(self):
        return self.wout.shape[2] - self.win_vals.shape[1]

    def win_apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """Win @ u for the block-diagonal Win. u (R, I) -> (R, n).

        Row j couples input j // q, i.e. each input value repeats q times
        - a broadcast/reshape that fuses into the spmv's elementwise pass.
        Ragged imports carry an explicit per-row input map instead."""
        if self.win_cols is not None:
            u_exp = jnp.take_along_axis(u, self.win_cols, axis=1)
            return self.win_vals * u_exp
        q = self.n // self.n_in
        u_exp = jnp.repeat(u, q, axis=1, total_repeat_length=self.n)
        return self.win_vals * u_exp


@dataclasses.dataclass(frozen=True)
class ESNHyper:
    """Static hyperparameters (mod_reservoir.f90:89-101)."""
    m: int = 6000              # target reservoir size
    deg: int = 6               # average degree of A
    sigma: float = 0.5         # input coupling scale
    leakage: float = 1.0
    beta_res: float = 0.001
    beta_model: float = 1.0
    prior_val: float = 0.0
    noise_mag: float = 0.2
    using_prior: bool = True

    def nodes(self, n_inputs: int) -> int:
        npi = int(round(self.m / n_inputs))
        return npi * n_inputs

    def nnz(self, n: int) -> int:
        return int(self.deg / self.m * n * n)


def radius_by_lat(lat_start: np.ndarray, lat_end: np.ndarray) -> np.ndarray:
    """Spectral radius by latitude band (res_domain.f90:1601-1638).

    Reproduces the reference behavior exactly: max_radius above 45 deg,
    otherwise the constant (max-min)/45 + min (the reference formula has
    no latitude factor; its trained weights saw these values)."""
    highest, rmax, rmin = 45.0, 0.7, 0.3
    smallest = np.minimum(np.abs(lat_start), np.abs(lat_end))
    return np.where(smallest >= highest, rmax, (rmax - rmin) / highest + rmin)


# ----------------------------------------------------------------------
# generation
# ----------------------------------------------------------------------

def _ell_from_perms(rng: np.random.Generator, n: int, k: int, J: int):
    """ELL (cols, mask) replicating makesparse's permutation draws (numpy).

    rows and cols are each concatenations of random permutations of 0..n-1
    (plus a partial one); grouping by row index gives degree
    {k//n, k//n+1}.  Host-side: pure index bookkeeping, done once at model
    build.  Returns cols (n, J) int32 and mask (n, J) float32."""
    counter = k // n
    leftover = k - counter * n
    rows = np.concatenate(
        [rng.permutation(n) for _ in range(counter)]
        + ([rng.permutation(n)[:leftover]] if leftover else []))
    colv = np.concatenate(
        [rng.permutation(n) for _ in range(counter)]
        + ([rng.permutation(n)[:leftover]] if leftover else []))
    slot = np.concatenate(
        [np.full(n, i, dtype=np.int32) for i in range(counter)]
        + ([np.full(leftover, counter, dtype=np.int32)] if leftover else []))
    cols = np.zeros((n, J), dtype=np.int32)
    mask = np.zeros((n, J), dtype=np.float32)
    cols[rows, slot] = colv
    mask[rows, slot] = 1.0
    return cols, mask


def ell_spmv(vals: jnp.ndarray, cols: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x for batched ELL A; vals (J, R, n), x (R, n) -> (R, n).

    Two layouts:
    - shared pattern (cols (n, J)): all regions share the sparsity graph
      (values independent per region), so the gather x.T[cols[:, j]]
      grabs CONTIGUOUS (R,)-rows — sequential HBM traffic instead of
      36M random scalar loads.
    - per-region pattern (cols (R, n, J)): needed for weights imported
      from the reference (independent graphs per worker); falls back to
      a batched random gather.
    """
    if cols.ndim == 2:
        n, J = cols.shape
        xt = x.T                                # (n, R) region-minor
        y = None
        for j in range(J):
            g = xt[cols[:, j]].T                # (R, n)
            y = vals[j] * g if y is None else y + vals[j] * g
        return y
    J = cols.shape[2]
    y = None
    for j in range(J):
        g = jnp.take_along_axis(x, cols[:, :, j], axis=1)   # (R, n)
        y = vals[j] * g if y is None else y + vals[j] * g
    return y


def ell_spmv_shift(vals: jnp.ndarray, shifts: tuple, x: jnp.ndarray
                   ) -> jnp.ndarray:
    """y = A x for shift-structured A: y[r,i] = sum_j vals[j,r,i] *
    x[r, (i+s_j) mod n].  Each term is an elementwise multiply against a
    cyclic roll of x — contiguous HBM reads, VPU only."""
    y = vals[0] * jnp.roll(x, -int(shifts[0]), axis=1)
    for j in range(1, len(shifts)):
        y = y + vals[j] * jnp.roll(x, -int(shifts[j]), axis=1)
    return y


def spectral_radius(vals, cols, key, iters: int = 200,
                    shifts: tuple | None = None) -> jnp.ndarray:
    """|lambda_max| of each region's A by batched power iteration."""
    _, R, n = vals.shape
    v = jax.random.normal(key, (R, n), dtype=vals.dtype)
    v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
    spmv = ((lambda w: ell_spmv_shift(vals, shifts, w)) if shifts is not None
            else (lambda w: ell_spmv(vals, cols, w)))

    def body(i, carry):
        v, lam = carry
        w = spmv(v)
        lam = jnp.linalg.norm(w, axis=1)
        v = w / jnp.maximum(lam[:, None], 1e-30)
        return v, lam

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.ones((R,), vals.dtype)))
    return lam


def generate(key, n_regions: int, n_inputs: int, hyper: ESNHyper,
             radius: np.ndarray | float, dtype=jnp.float32,
             radius_iters: int = 200, shared_pattern: bool = True,
             topology: str = "shift"):
    """Random A (ELL) + Win for all regions (gen_res + the Win fill of
    train_reservoir, mod_reservoir.f90:180-281).

    radius: per-region spectral radius (R,) or scalar.
    topology:
      "shift"  (default): cols[i,j] = (i + s_j) mod n for J
               random distinct shifts s_j shared across regions; values
               stay fully random per region.  The spmv then needs no
               gathers at all (ell_spmv_shift).  This is a simple-cycle /
               ring-ensemble reservoir (Rodan & Tino 2011), with the same
               degree, density, and spectral-radius scaling as the
               reference's random graphs.
      "random": the reference's permutation-draw graph (makesparse,
               mod_linalg.f90:180-218); shared_pattern selects one shared
               graph vs independent graphs per region.
    Returns (cols, vals, win, shifts); vals is slot-major (J, R, n);
    shifts is a tuple for "shift" and None for "random"."""
    n = hyper.nodes(n_inputs)
    k = hyper.nnz(n)
    J = k // n + (1 if k % n else 0)
    radius = jnp.broadcast_to(jnp.asarray(radius, dtype=dtype), (n_regions,))

    # host-side structure generation, seeded from the JAX key.  The
    # structure generator draws from key [seed, n_regions] — disjoint from
    # the per-region VALUE keys [seed, 0..n_regions-1] — so the topology
    # never reuses region 0's random stream.
    # the structure seed is read from the raw key data on the host: the
    # graph is built in numpy, so no device op is needed to derive it
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1]
               & 0x7FFFFFFF)
    struct_key = [seed, n_regions]
    shifts = None
    if topology == "shift":
        rng = np.random.Generator(np.random.Philox(key=struct_key))
        shifts = tuple(int(s) for s in rng.choice(n, size=J, replace=False))
        cols = jnp.asarray(
            (np.arange(n)[:, None] + np.asarray(shifts)[None, :]) % n,
            dtype=jnp.int32)
        # keep nnz = k exactly: the last slot is only `leftover` rows deep
        # (matches the reference's degree distribution {k//n, k//n+1})
        leftover = k - (k // n) * n
        mask = np.ones((n, J), dtype=np.float32)
        if leftover:
            off = rng.permutation(n)[leftover:]
            mask[off, J - 1] = 0.0
        # values drawn ON DEVICE in one fused op (the per-region host
        # Philox loop costs minutes at 1,152 x n=5760); per-region
        # independence comes from the batched counter-based PRNG
        vals = (jax.random.uniform(
            jax.random.fold_in(key, 3), (J, n_regions, n), dtype=dtype)
            * jnp.asarray(mask.T[:, None, :], dtype=dtype))
    elif shared_pattern:
        rng = np.random.Generator(np.random.Philox(key=struct_key))
        c, m = _ell_from_perms(rng, n, k, J)
        cols = jnp.asarray(c)
        vals_np = np.zeros((n_regions, n, J), dtype=np.float64)
        for r in range(n_regions):
            rr = np.random.Generator(np.random.Philox(key=[seed, r]))
            vals_np[r] = rr.uniform(size=(n, J)) * m
        vals = jnp.asarray(vals_np.transpose(2, 0, 1), dtype=dtype)
    else:
        cols_np = np.zeros((n_regions, n, J), dtype=np.int32)
        vals_np = np.zeros((n_regions, n, J), dtype=np.float64)
        for r in range(n_regions):
            rng = np.random.Generator(np.random.Philox(key=[seed, r]))
            c, m = _ell_from_perms(rng, n, k, J)
            cols_np[r] = c
            vals_np[r] = rng.uniform(size=(n, J)) * m
        cols = jnp.asarray(cols_np)
        vals = jnp.asarray(vals_np.transpose(2, 0, 1), dtype=dtype)
    lam = spectral_radius(vals, cols, jax.random.fold_in(key, 7),
                          iters=radius_iters, shifts=shifts)
    vals = vals / lam[None, :, None] * radius[None, :, None]

    # Win: block-diagonal, q = n/n_inputs rows per input, +-sigma uniform;
    # stored as one value per row (see BatchedReservoir.win_vals)
    kw = jax.random.fold_in(key, 13)
    ip = jax.random.uniform(kw, (n_regions, n_inputs, n // n_inputs),
                            dtype=dtype, minval=-1.0, maxval=1.0) * hyper.sigma
    win_vals = ip.reshape(n_regions, n)
    return cols, vals, win_vals, shifts


# ----------------------------------------------------------------------
# dynamics
# ----------------------------------------------------------------------

def esn_step(res: BatchedReservoir, x: jnp.ndarray, u: jnp.ndarray,
             leakage: float = 1.0) -> jnp.ndarray:
    """x' = (1-l) x + l tanh(A x + Win u); x (R, n), u (R, I)."""
    if res.shifts is not None:
        y = ell_spmv_shift(res.vals, res.shifts, x)
    else:
        y = ell_spmv(res.vals, res.cols, x)
    y = y + res.win_apply(u)
    xt = jnp.tanh(y)
    if leakage == 1.0:
        return xt
    return (1.0 - leakage) * x + leakage * xt


def quad_expand(x: jnp.ndarray) -> jnp.ndarray:
    """Square every second node (Fortran rows 2:n:2 -> 0-based odd indices)."""
    n = x.shape[-1]
    idx = jnp.arange(n)
    return jnp.where(idx % 2 == 1, x * x, x)


def readout(res: BatchedReservoir, x: jnp.ndarray,
            local_model: jnp.ndarray | None = None) -> jnp.ndarray:
    """outvec = Wout [local_model ; x~]  (predict / predict_ml).

    Wout may be stored in bfloat16 (cast_wout_bf16): the readout is
    bound by the weight read (3.8 GB in f32 at the production m=6000
    layout), which bf16 halves.  The einsum then runs bf16 x bf16 with
    an f32 accumulator, so the output precision loss is the ~0.4%
    relative weight rounding — far below the 0.2-sigma training noise
    the readout was fit under."""
    xt = quad_expand(x)
    if local_model is not None:
        aug = jnp.concatenate([local_model, xt], axis=-1)
    else:
        aug = xt
    if res.wout.dtype == jnp.bfloat16:
        return jnp.einsum("roa,ra->ro", res.wout,
                          aug.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    return jnp.einsum("roa,ra->ro", res.wout, aug)


def synchronize(res: BatchedReservoir, x: jnp.ndarray, inputs: jnp.ndarray,
                leakage: float = 1.0) -> jnp.ndarray:
    """Drive the ESN through inputs (T, R, I) without readout."""
    def body(xc, u):
        return esn_step(res, xc, u, leakage), None
    x, _ = jax.lax.scan(body, x, inputs)
    return x
