"""Promoted-precision ridge solve (solve_dtype) correctness.

The f64 path must (a) match a numpy f64 oracle and (b) stay bounded on
the near-singular Grams that degenerate at f32; the promotion solves by
QR, which tolerates the slight indefiniteness of an f32-accumulated
Gram — this test pins the numerics."""

import jax.numpy as jnp
import numpy as np

from speedy_ml_tpu.esn.reservoir import ESNHyper
from speedy_ml_tpu.esn.train import NormalEq, solve_wout

HYP = ESNHyper(m=64, beta_res=0.001, beta_model=1.0, using_prior=True)


def _oracle(ss, st, n_speedy):
    R, A, _ = ss.shape
    diag = np.where(np.arange(A) < n_speedy, HYP.beta_model**2,
                    HYP.beta_res**2)
    out = []
    for r in range(R):
        m = ss[r].astype(np.float64) + np.diag(diag)
        out.append(np.linalg.solve(m, st[r].astype(np.float64).T).T)
    return np.stack(out)


def test_f64_promotion_matches_oracle():
    rng = np.random.default_rng(0)
    A, O, S, R = 48, 12, 8, 3
    X = rng.normal(size=(R, 200, A))
    ss = np.einsum("rta,rtb->rab", X, X).astype(np.float32)
    st = rng.normal(size=(R, O, A)).astype(np.float32)
    got = np.asarray(solve_wout(NormalEq(ss=jnp.asarray(ss),
                                         st=jnp.asarray(st)),
                                HYP, S, solve_dtype=jnp.float64))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(ss, st, S), rtol=2e-4,
                               atol=2e-4)


def test_f64_promotion_bounded_on_near_singular_gram():
    # rank-deficient Gram (fewer samples than A): the f32 LU fit blows
    # up to ~1e4-1e5; the promoted solve must stay at the ridge scale
    rng = np.random.default_rng(1)
    A, O, R, T = 96, 8, 2, 24           # T << A
    # column scales span ~1e3 — the worst standardized inputs allow
    # (standardize.floor_component_std caps the spread at ~1e2)
    X = rng.normal(size=(R, T, A)) * rng.lognormal(0, 1.5, size=(1, 1, A))
    ss = np.einsum("rta,rtb->rab", X, X).astype(np.float32)
    st = np.einsum("rta,rto->roa", X,
                   rng.normal(size=(R, T, O))).astype(np.float32)
    got = np.asarray(solve_wout(NormalEq(ss=jnp.asarray(ss),
                                         st=jnp.asarray(st)),
                                HYP, 0, solve_dtype=jnp.float64))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _oracle(ss, st, 0), rtol=1e-3,
                               atol=1e-3)
