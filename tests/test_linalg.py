"""XLA chol_solve / tri_solve_lt against scipy, batched and unbatched, at
the ranks the workloads use (femur GPMM-50/100/200 have 51/101/201 columns)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from icp_proposal_tpu.ops.linalg import chol_solve, tri_solve_lt

RANKS = [16, 50, 101, 201]


def _spd_batch(rng, b, r):
    a = rng.randn(b, r, r) * 0.2 / np.sqrt(r / 16)
    return np.einsum("bij,bkj->bik", a, a) + np.eye(r)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("r", RANKS)
def test_chol_solve_matches_scipy(rng, r, batched):
    b = 3
    m = _spd_batch(rng, b, r)
    rhs = rng.randn(b, r)
    m32, rhs32 = jnp.asarray(m, jnp.float32), jnp.asarray(rhs, jnp.float32)
    if batched:
        chol, x, ld = jax.vmap(chol_solve)(m32, rhs32)
    else:
        chol, x, ld = (jnp.stack(t) for t in zip(
            *(chol_solve(m32[i], rhs32[i]) for i in range(b))))
    for i in range(b):
        l_ref = scipy.linalg.cholesky(m[i], lower=True)
        x_ref = scipy.linalg.cho_solve((l_ref, True), rhs[i])
        ld_ref = 2.0 * np.sum(np.log(np.diag(l_ref)))
        np.testing.assert_allclose(np.asarray(chol[i]), l_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(x[i]), x_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(ld[i]), ld_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("r", RANKS)
def test_tri_solve_lt_matches_scipy(rng, r, batched):
    b = 3
    m = _spd_batch(rng, b, r)
    chol = np.linalg.cholesky(m)
    z = rng.randn(b, r)
    c32, z32 = jnp.asarray(chol, jnp.float32), jnp.asarray(z, jnp.float32)
    if batched:
        x = jax.vmap(tri_solve_lt)(c32, z32)
    else:
        x = jnp.stack([tri_solve_lt(c32[i], z32[i]) for i in range(b)])
    for i in range(b):
        x_ref = scipy.linalg.solve_triangular(chol[i], z[i], lower=True, trans=1)
        np.testing.assert_allclose(np.asarray(x[i]), x_ref, rtol=1e-4, atol=1e-4)
