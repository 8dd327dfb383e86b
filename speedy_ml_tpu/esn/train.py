"""Batched ESN ridge-regression training via normal equations.

Reference: mod_reservoir.f90 (reservoir_layer_chunking_*, chunking_matmul,
fit_chunk_*, initialize_chunk_training).  The Fortran's per-sample spMV
loop + per-batch DGEMMs become a `lax.scan` over time with per-batch
batched GEMMs (`gram_update`, full f32 precision); the 20-batch
accumulation keeps the (n, T) state matrix from ever materializing
whole, exactly as the reference does.

All arrays carry a leading region axis R.  Time-major inputs:
  train_in:  (T, R, I)  standardized input series (with halos)
  target:    (T, R, O)  standardized target series (region core), SAME time
                        indexing as train_in
  model_in:  (T, R, S)  imperfect-model (SPEEDY) forecast series, or None

Alignment (matches chunking_matmul, mod_reservoir.f90:1643-1699): the
state that has absorbed inputs up to index t-1 is paired with target[t] —
one-step-ahead prediction of the series itself.  The first state (x0 from
the discard segment) pairs with target[0], so target[0] must be the value
one step past the last discard input.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from speedy_ml_tpu.esn.reservoir import (BatchedReservoir, ESNHyper,
                                         esn_step, quad_expand)


class NormalEq(NamedTuple):
    """Accumulated normal equations per region."""
    ss: jnp.ndarray    # (R, S+n, S+n)  aug . aug^T
    st: jnp.ndarray    # (R, O, S+n)    target . aug^T


def gram_update(ss: jnp.ndarray, st: jnp.ndarray, aug: jnp.ndarray,
                tgt: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Add one batch to the normal equations: ss += aug aug^T, st +=
    tgt aug^T per region; aug (B, R, A), tgt (B, R, O).

    Precision HIGHEST: these sums run over thousands of samples into a
    near-singular ridge solve, and a float32 GEMM at default precision
    may round its inputs to TF32 (10-bit mantissa) on tensor-core GPUs."""
    hi = jax.lax.Precision.HIGHEST
    ss = ss + jnp.einsum("brm,brk->rmk", aug, aug, precision=hi)
    st = st + jnp.einsum("bro,brk->rok", tgt, aug, precision=hi)
    return ss, st


def find_closest_divisor(target: int, total: int) -> int:
    """Closest divisor of `total` to `target` (mod_utilities.f90:1591-1629)."""
    best, bestd = 1, abs(target - 1)
    for d in range(1, total + 1):
        if total % d == 0 and abs(target - d) < bestd:
            best, bestd = d, abs(target - d)
    return best


def apply_noise(key, u: jnp.ndarray, noise_mag: float,
                precip_slice: Optional[tuple] = None,
                precip_mean: Optional[jnp.ndarray] = None,
                precip_std: Optional[jnp.ndarray] = None,
                precip_eps: float = 0.001) -> jnp.ndarray:
    """Multiplicative gaussian training noise (mod_utilities.f90:1380-1457).

    u: (R, I).  For the precip block [p0, p1) the noise is additive in
    physical precip space with the log(1+P/eps) transform round-tripped."""
    g = jax.random.normal(key, u.shape, dtype=u.dtype)
    noisy = u + g * noise_mag * u
    if precip_slice is None:
        return noisy
    p0, p1 = precip_slice
    temp = u[:, p0:p1] * precip_std + precip_mean
    temp = precip_eps * (jnp.exp(temp) - 1.0)
    temp = temp + g[:, p0:p1] * noise_mag
    temp = jnp.abs(temp)
    temp = jnp.log(1.0 + temp / precip_eps)
    temp = (temp - precip_mean) / precip_std
    return noisy.at[:, p0:p1].set(temp)


def apply_noise_keys(keys, u: jnp.ndarray, noise_mag: float,
                     precip_slice: Optional[tuple] = None,
                     precip_mean: Optional[jnp.ndarray] = None,
                     precip_std: Optional[jnp.ndarray] = None,
                     precip_eps: float = 0.001) -> jnp.ndarray:
    """apply_noise with one PRNG key PER REGION (keys (R,), u (R, I)).

    Keyed by (time index, global region id) upstream, so the draw for a
    given (t, region) is independent of how regions/time are chunked —
    the invariance anchor of the production trainer."""
    g = jax.vmap(lambda k, row: jax.random.normal(k, row.shape, row.dtype)
                 )(keys, u)
    noisy = u + g * noise_mag * u
    if precip_slice is None:
        return noisy
    p0, p1 = precip_slice
    temp = u[:, p0:p1] * precip_std + precip_mean
    temp = precip_eps * (jnp.exp(temp) - 1.0)
    temp = temp + g[:, p0:p1] * noise_mag
    temp = jnp.abs(temp)
    temp = jnp.log(1.0 + temp / precip_eps)
    temp = (temp - precip_mean) / precip_std
    return noisy.at[:, p0:p1].set(temp)


def accumulate_batches(res: BatchedReservoir, hyper: ESNHyper,
                       train_in: jnp.ndarray, target: jnp.ndarray,
                       model_in: Optional[jnp.ndarray],
                       x0: jnp.ndarray, batch_size: int,
                       noise_key=None,
                       precip_info: Optional[dict] = None):
    """Run the ESN over the series and accumulate normal equations.

    Processes floor((T-1)/batch_size) complete batches like the reference
    (the tail beyond the last complete batch is dropped,
    reservoir_layer_chunking_hybrid:1113-1170).

    Returns (NormalEq, x_final)."""
    T, R, _ = train_in.shape
    n = res.n
    S = 0 if model_in is None else model_in.shape[2]
    O = target.shape[2]
    nbatch = (T - 1) // batch_size

    noise_keys = (jax.random.split(noise_key, T) if noise_key is not None
                  else None)

    def noisy_u(t):
        u = train_in[t]
        if noise_keys is None:
            return u
        if precip_info is None:
            return apply_noise(noise_keys[t], u, hyper.noise_mag)
        return apply_noise(noise_keys[t], u, hyper.noise_mag,
                           precip_slice=precip_info["slice"],
                           precip_mean=precip_info["mean"],
                           precip_std=precip_info["std"],
                           precip_eps=precip_info["eps"])

    def batch_step(carry, b):
        x, ss, st = carry
        base = b * batch_size

        # collect batch_size states: the first state of batch b is x itself
        # (= x_{base}); advance batch_size-1 times with inputs v[base + j]
        def collect(xc, t):
            xn = esn_step(res, xc, noisy_u(t), hyper.leakage)
            return xn, xn

        ts_adv = base + jnp.arange(batch_size - 1)
        x_last, states_tail = jax.lax.scan(collect, x, ts_adv)
        # states: (batch, R, n) = [x_base, ..., x_{base+bs-1}]
        states = jnp.concatenate([x[None], states_tail], axis=0)
        states_sq = quad_expand(states)

        tgt_idx = base + jnp.arange(batch_size)
        if model_in is not None:
            lm = jnp.take(model_in, tgt_idx, axis=0)
            aug = jnp.concatenate([lm, states_sq], axis=2)   # (B, R, S+n)
        else:
            aug = states_sq
        tgt = jnp.take(target, tgt_idx, axis=0)

        ss, st = gram_update(ss, st, aug, tgt)

        # advance into the next batch's first state
        x_next = esn_step(res, x_last, noisy_u(base + batch_size - 1),
                          hyper.leakage)
        return (x_next, ss, st), None

    ss0 = jnp.zeros((R, S + n, S + n), dtype=train_in.dtype)
    st0 = jnp.zeros((R, O, S + n), dtype=train_in.dtype)
    (x, ss, st), _ = jax.lax.scan(batch_step, (x0, ss0, st0),
                                  jnp.arange(nbatch))
    return NormalEq(ss=ss, st=st), x


def discard_transient(res: BatchedReservoir, hyper: ESNHyper,
                      train_in: jnp.ndarray, noise_key=None,
                      precip_info: Optional[dict] = None) -> jnp.ndarray:
    """Spin up from zero state through the discard segment (T, R, I)."""
    T, R, _ = train_in.shape
    x = jnp.zeros((R, res.n), dtype=train_in.dtype)
    keys = jax.random.split(noise_key, T) if noise_key is not None else None

    def body(xc, t):
        u = train_in[t]
        if keys is not None:
            if precip_info is None:
                u = apply_noise(keys[t], u, hyper.noise_mag)
            else:
                u = apply_noise(keys[t], u, hyper.noise_mag,
                                precip_slice=precip_info["slice"],
                                precip_mean=precip_info["mean"],
                                precip_std=precip_info["std"],
                                precip_eps=precip_info["eps"])
        return esn_step(res, xc, u, hyper.leakage), None

    x, _ = jax.lax.scan(body, x, jnp.arange(T))
    return x


def solve_wout(eq: NormalEq, hyper: ESNHyper, n_speedy: int,
               solve_dtype=None) -> jnp.ndarray:
    """Ridge solve for Wout (fit_chunk_hybrid, mod_reservoir.f90:1233-1332).

    Regularization: beta_model^2 on the SPEEDY block diagonal, beta_res^2
    on the reservoir block (squared because using_prior=True in the
    reference config); the prior adds prior_val*beta_model^2 to the RHS
    diagonal of the SPEEDY block."""
    R, A, _ = eq.ss.shape
    out_dtype = eq.ss.dtype
    promote = (solve_dtype is not None
               and jnp.dtype(solve_dtype) != eq.ss.dtype)
    if promote and not jax.config.jax_enable_x64:
        # near-singular Grams (few samples vs A, or degenerate polar/
        # night columns) make the f32 LU fit astronomically large Wout
        # (|Wout| ~ 3e4 with NaNs at T30 real data); the reference solves
        # in full f64 (real*8 + DGESV).  Promote JUST the solve — scoped
        # x64 so the f32 model (and its complex64 spectral arrays) is
        # untouched.
        with jax.enable_x64():
            return solve_wout(eq, hyper, n_speedy, solve_dtype)
    if hyper.using_prior:
        bm, br = hyper.beta_model**2, hyper.beta_res**2
    else:
        bm, br = hyper.beta_model, hyper.beta_res
    ridge = jnp.where(jnp.arange(A) < n_speedy, bm, br)
    pv = (hyper.prior_val * hyper.beta_model**2
          if hyper.using_prior and n_speedy > 0 else 0.0)

    # solve (ss + ridge) . Wout^T = st^T — the reference's mldivide ->
    # DGESV (mod_linalg.f90:109-151).  Promotion happens PER REGION
    # inside the sequential map, so the f64 copy is one region's Gram,
    # not the whole (R, A, A) batch (2x the chunk's f32 footprint).
    # The ridge is also added after the cast — at f32 a 1e-6 ridge
    # rounds away against O(1e3) Gram diagonals.
    def solve_one(ssr, str_):
        if promote:
            ssr = ssr.astype(solve_dtype)
            str_ = str_.astype(solve_dtype)
        ssr = ssr + jnp.diag(ridge.astype(ssr.dtype))
        if pv != 0.0:
            O = str_.shape[0]
            k = min(n_speedy, O)
            str_ = str_.at[jnp.arange(k), jnp.arange(k)].add(pv)
        # Jacobi preconditioning (unit diagonal) stabilizes without
        # changing the solution
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(ssr), 1e-30))
        ssn = ssr / d[:, None] / d[None, :]
        b = (str_ / d[None, :]).T
        if promote:
            # QR, not Cholesky: the f32-accumulated Gram carries
            # ~eps32-relative noise that leaves the normalized matrix
            # slightly INDEFINITE (min eig ~ -1e-7) when near-singular,
            # where Cholesky NaNs; QR, like pivoted LU, tolerates it.
            q, r = jnp.linalg.qr(ssn)
            z = jax.scipy.linalg.solve_triangular(r, q.T @ b, lower=False)
        else:
            z = jnp.linalg.solve(ssn, b)
        return ((z / d[:, None]).T).astype(out_dtype)

    # sequential over regions (lax.map, not vmap): working memory stays
    # one region's factorization (an f64 A=5892 QR holds ~0.8 GB)
    return jax.lax.map(lambda args: solve_one(*args), (eq.ss, eq.st))


def solve_wout_sharded(eq: NormalEq, hyper: ESNHyper, n_speedy: int,
                       mesh, axis: str = "regions") -> jnp.ndarray:
    """solve_wout with the region axis sharded over `mesh`.

    Per-region solves are independent, so the SPMD form is a shard_map
    with a purely LOCAL solve per device — no collectives.  (Naively
    calling solve_wout on sharded inputs makes its sequential lax.map
    dynamic-slice across shards every iteration: 70 s for a (64, 708,
    708) batch on an 8-device host mesh vs <2 s this way.)"""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    spec = P(axis, None, None)

    def block(ss, st):
        return solve_wout(NormalEq(ss=ss, st=st), hyper, n_speedy)

    return shard_map(block, mesh=mesh, in_specs=(spec, spec),
                     out_specs=spec)(eq.ss, eq.st)


def train_subseries(res: BatchedReservoir, hyper: ESNHyper,
                    series_in: jnp.ndarray, series_target: jnp.ndarray,
                    series_model: Optional[jnp.ndarray],
                    n_discard: int, batch_size: int,
                    noise_key=None, precip_info=None) -> tuple[NormalEq, jnp.ndarray]:
    """One strided sub-series pass: discard + batched accumulation."""
    x0 = discard_transient(res, hyper, series_in[:n_discard],
                           noise_key=noise_key, precip_info=precip_info)
    nk = jax.random.fold_in(noise_key, 1) if noise_key is not None else None
    eq, x = accumulate_batches(
        res, hyper, series_in[n_discard:],
        series_target[n_discard:],
        None if series_model is None else series_model[n_discard:],
        x0, batch_size, noise_key=nk, precip_info=precip_info)
    return eq, x


def pinv_svd(a: jnp.ndarray, thres: float = 1e-2) -> jnp.ndarray:
    """Moore-Penrose pseudo-inverse via SVD with a hard singular-value
    threshold (pinv_svd, mod_linalg.f90:27-100): singular values <= thres
    are zeroed outright (not clipped), matching the reference's DSCAL
    branches.  Batched over leading axes; unused in the production solve
    path there and here, kept for API parity."""
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    sinv = jnp.where(s > thres, 1.0 / jnp.where(s > thres, s, 1.0), 0.0)
    return jnp.einsum("...ij,...j,...kj->...ik",
                      jnp.swapaxes(vt, -1, -2), sinv, u)
