"""Precision policy of the training sums, and the gather spmv of the
reference's random graphs.

The Gram accumulation and the standardization sums feed a near-singular
ridge solve, so their contractions must ask for full float32
(Precision.HIGHEST): at default precision a tensor-core GPU may round
their inputs to TF32.  On the CPU both give the same numbers, so the
tests read the lowered programs instead.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speedy_ml_tpu.esn.reservoir import (BatchedReservoir, ESNHyper, esn_step,
                                         generate)
from speedy_ml_tpu.esn.standardize import component_sums, compute_standardizer
from speedy_ml_tpu.esn.train import accumulate_batches, gram_update


def dot_generals(lowered_text):
    """The dot_general ops of a lowered StableHLO module."""
    return [ln for ln in lowered_text.splitlines()
            if "stablehlo.dot_general" in ln]


def assert_all_highest(lowered_text, expect_at_least):
    dots = dot_generals(lowered_text)
    assert len(dots) >= expect_at_least, lowered_text[:2000]
    for ln in dots:
        m = re.search(r"precision\s*=\s*\[([^\]]*)\]", ln)
        prec = [p.strip() for p in m.group(1).split(",")] if m else []
        assert prec and all(p == "HIGHEST" for p in prec), ln


F32 = jnp.float32


def test_gram_update_is_highest():
    B, R, A, O = 3, 2, 5, 4
    txt = jax.jit(gram_update).lower(
        jnp.zeros((R, A, A), F32), jnp.zeros((R, O, A), F32),
        jnp.zeros((B, R, A), F32), jnp.zeros((B, R, O), F32)).as_text()
    assert_all_highest(txt, 2)


def test_accumulate_batches_gram_is_highest():
    hyper = ESNHyper(m=40, deg=3)
    cols, vals, win, shifts = generate(jax.random.PRNGKey(0), 2, 4, hyper,
                                       radius=0.5, dtype=F32,
                                       radius_iters=5)
    n = vals.shape[2]
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win,
                           wout=jnp.zeros((2, 0, 0), F32),
                           mean=jnp.zeros((2, 0), F32),
                           std=jnp.ones((2, 0), F32), n_in=4, shifts=shifts)
    T = 9
    fn = jax.jit(accumulate_batches, static_argnames=("hyper", "batch_size"))
    txt = fn.lower(res, hyper, jnp.zeros((T, 2, 4), F32),
                   jnp.zeros((T, 2, 3), F32), jnp.zeros((T, 2, 2), F32),
                   jnp.zeros((2, n), F32), batch_size=4).as_text()
    assert_all_highest(txt, 2)


def test_chunked_accumulate_is_highest():
    from speedy_ml_tpu.hybrid.chunked import _chunk_accumulators
    hyper = ESNHyper(m=40, deg=3)
    cols, vals, win, shifts = generate(jax.random.PRNGKey(1), 2, 4, hyper,
                                       radius=0.5, dtype=F32,
                                       radius_iters=5)
    n = vals.shape[2]
    _, accumulate = _chunk_accumulators(hyper, shifts, 4)
    C, A, O = 5, 2 + n, 3
    txt = accumulate.lower(vals, win, jnp.zeros((2, n), F32),
                           jnp.zeros((2, A, A), F32),
                           jnp.zeros((2, O, A), F32),
                           jnp.zeros((C, 2, 4), F32),
                           jnp.zeros((C, 2, O), F32),
                           jnp.zeros((C, 2, 2), F32)).as_text()
    assert_all_highest(txt, 2)


def test_standardization_sums_are_highest():
    series = jnp.zeros((6, 2, 5), F32)
    onehot = jnp.zeros((5, 3), F32)
    assert_all_highest(jax.jit(component_sums).lower(series, onehot)
                       .as_text(), 2)
    cm = np.array([0, 0, 1, 2, 2], np.int32)
    txt = jax.jit(lambda s: compute_standardizer(
        s, cm, cm[:3], 3).in_std).lower(series).as_text()
    assert_all_highest(txt, 2)


def test_streaming_standardizer_sums_are_highest(monkeypatch):
    """The streamed statistics contract through component_sums too."""
    import speedy_ml_tpu.hybrid.chunked as chunked
    seen = []
    real = chunked.component_sums

    def spy(series, onehot):
        seen.append(jax.jit(real).lower(series, onehot).as_text())
        return real(series, onehot)

    monkeypatch.setattr(chunked, "component_sums", spy)
    from speedy_ml_tpu.core import Geometry
    from speedy_ml_tpu.esn.domain import RegionLayout
    from speedy_ml_tpu.hybrid.chunked import ArraySource
    geom = Geometry(trunc=10, nlon=32, nlat=16, nlev=2)
    layout = RegionLayout(geom, n_regions=32, overlap=1)
    rng = np.random.default_rng(0)
    T = 3
    truth = dict(atmo=rng.standard_normal((T, 4, 2, 16, 32)),
                 logp=rng.standard_normal((T, 16, 32)),
                 precip=np.abs(rng.standard_normal((T, 16, 32))),
                 sst=rng.standard_normal((T, 16, 32)),
                 tisr=rng.standard_normal((T, 16, 32)))
    chunked.streaming_standardizer(layout, layout.classes[0],
                                   ArraySource(truth), 2, dtype=F32)
    assert seen
    for txt in seen:
        assert_all_highest(txt, 2)


@pytest.mark.parametrize("n_regions", [1, 3])
def test_random_topology_esn_step_matches_dense(n_regions):
    """A shared-pattern random graph steps through the gather spmv
    (ell_spmv); the step must equal tanh(A x + Win u) with a dense A."""
    hyper = ESNHyper(m=120, deg=6)
    I = 12
    cols, vals, win, shifts = generate(jax.random.PRNGKey(5), n_regions, I,
                                       hyper, radius=0.8, dtype=jnp.float64,
                                       radius_iters=50, topology="random")
    assert shifts is None and cols.ndim == 2
    J, R, n = vals.shape
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win,
                           wout=jnp.zeros((R, 0, 0)), mean=jnp.zeros((R, 0)),
                           std=jnp.ones((R, 0)), n_in=I)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (R, n))
    u = rng.standard_normal((R, I))
    dense = np.zeros((R, n, n))
    c, v = np.asarray(cols), np.asarray(vals)
    for r in range(R):
        for j in range(J):
            np.add.at(dense[r], (np.arange(n), c[:, j]), v[j, r])
    win_dense = np.asarray(win) * np.repeat(u, n // I, axis=1)
    want = np.tanh(np.einsum("rij,rj->ri", dense, x) + win_dense)
    got = np.asarray(esn_step(res, jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
