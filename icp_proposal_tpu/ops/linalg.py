"""Small dense SPD solves for the coefficient-space GP posterior.

The MH step factors one r×r posterior precision M per ICP component per step
(SURVEY §3.1 hot loop, ``NonRigidIcpProposal.scala:152``).  Under ``vmap``
over chains XLA lowers these to batched Cholesky and triangular solves
(cuSOLVER / cuBLAS on the GPU).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def chol_solve(m, rhs):
    """(chol(M), M⁻¹rhs, log det M) for one SPD [r, r] system; L is lower."""
    chol = jnp.linalg.cholesky(m)
    x = jax.scipy.linalg.cho_solve((chol, True), rhs)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return chol, x, logdet


def tri_solve_lt(chol, z):
    """Solve Lᵀ x = z for one lower-triangular [r, r] L (posterior sampling:
    α* = α̂ + L⁻ᵀz)."""
    return jax.scipy.linalg.solve_triangular(chol, z, lower=True, trans=1)
