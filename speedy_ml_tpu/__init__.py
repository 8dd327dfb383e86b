"""speedy_ml_tpu — a hybrid climate modeling framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the SPEEDY-ML
hybrid model (SPEEDY T30L8 spectral GCM + per-region echo-state
networks, two-way coupled to an ML slab ocean).  The reference
(awikner/SPEEDY-ML-1, Fortran+MPI) is used only as a behavioral spec.
It runs on an NVIDIA H100 (and on the CPU for tests):

- the spectral transform core is batched matmuls + `jnp.fft.rfft`;
- the 1,152 reservoir regions are one batched program (leading region axis),
  sharded over a `jax.sharding.Mesh` instead of MPI ranks;
- halo exchange is `shard_map`+`ppermute` instead of a rank-0 hub;
- the GCM runs as a jitted functional program, not a serial root process.

(The package name is historical.)
"""

__version__ = "0.1.0"
