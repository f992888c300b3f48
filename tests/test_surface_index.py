"""Shortlist surface index vs the dense exact kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icp_proposal_tpu.models.synthetic import make_icosphere
from icp_proposal_tpu.ops.closest_point import (
    closest_points_on_surface,
    surface_distances,
)
from icp_proposal_tpu.ops.surface_index import (
    build_surface_index,
    index_closest,
    index_distances,
    validate_index,
)


@pytest.fixture(scope="module")
def sphere_index():
    points, cells = make_icosphere(subdivisions=2, radius=10.0)
    return build_surface_index(points, cells, k=16), points, cells


def test_index_matches_dense(sphere_index, rng):
    index, points, cells = sphere_index
    # near-surface and far queries
    queries = jnp.asarray(
        np.concatenate([rng.randn(25, 3) * 11, rng.randn(8, 3) * 40]),
        jnp.float32,
    )
    cp_f, d2_f, fi_f = index_closest(index, queries)
    cp_r, d2_r, fi_r = closest_points_on_surface(queries, jnp.asarray(index.tri))
    np.testing.assert_allclose(np.asarray(d2_f), np.asarray(d2_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cp_f), np.asarray(cp_r), rtol=1e-4, atol=1e-4)


def test_index_vmap(sphere_index, rng):
    index, _, _ = sphere_index
    queries = jnp.asarray(rng.randn(3, 12, 3) * 11, jnp.float32)
    d2_f, _ = jax.vmap(lambda q: index_distances(index, q))(queries)
    d2_r = jnp.stack(
        [surface_distances(q, jnp.asarray(index.tri))[0] for q in queries]
    )
    np.testing.assert_allclose(np.asarray(d2_f), np.asarray(d2_r), rtol=1e-5, atol=1e-5)


def test_validate_index_helper(sphere_index, rng):
    index, _, _ = sphere_index
    queries = rng.randn(40, 3).astype(np.float32) * 12
    max_err, frac = validate_index(index, queries)
    assert max_err < 1e-4
    assert frac == 0.0


def test_femur_context_roundtrip(femur_data, rng):
    """Femur-scale check: the flagship data's shortlist index must produce
    the same evaluator distances as the dense path."""
    from icp_proposal_tpu.models import gpmm as gp
    from icp_proposal_tpu.ops.surface_index import build_surface_index

    data = femur_data
    ctx_pts = np.asarray(data.target.points, np.float32)
    index = build_surface_index(ctx_pts, np.asarray(data.target.cells), k=32)
    # queries: deformed model instances (prior draws, incl. a wild one)
    key = jax.random.PRNGKey(7)
    for scale in (0.5, 1.0, 2.5):
        coeffs = scale * jax.random.normal(key, (data.model.rank,))
        pts = gp.instance_points(data.model, coeffs)
        q = pts[:: max(1, pts.shape[0] // 150)]
        max_err, frac = validate_index(index, np.asarray(q))
        assert max_err < 1e-3, (scale, max_err)


def test_femur_adversarial_random_init(femur_data):
    """VERDICT r1 item 7: shortlist exactness at random-init chain states —
    coeffs ~ N(0, I) AND perturbed poses put queries far from the target."""
    from tools.validate_index import near_surface_queries, perturbed_queries

    data = femur_data
    index = build_surface_index(
        np.asarray(data.target.points, np.float32),
        np.asarray(data.target.cells), k=64,
    )
    q = perturbed_queries(
        data, jax.random.PRNGKey(3), coeff_scale=1.0, trans_mm=20.0,
        rot_rad=0.2, n_states=4, stride=8,
    )
    max_err, max_rel, _ = validate_index(index, q, with_rel=True)
    # far-query error model (surface_index.validate_index docstring): the
    # shortlist may miss the true face for queries tens of mm out, on
    # <=0.14% of queries and by up to 1.5 mm / 14% over 311k queries; this
    # 812-query sample of the seeded workload has no miss (max 1.1e-5 mm),
    # so the bounds pinned on the reference data still hold unchanged
    assert max_rel < 5e-2, (max_err, max_rel)
    assert max_err < 0.5, (max_err, max_rel)
    # near-surface queries (the regime that decides the posterior) are exact.
    # The seeded target is itself a prior draw, so a second prior draw sits
    # up to ~27 mm from it and is no longer "near"; near means within the
    # likelihood's σ = 2 mm of the target surface.
    q_near = near_surface_queries(data, 5, sigma_mm=2.0, n_copies=2, stride=2)
    max_err_n, frac_n = validate_index(index, q_near)
    assert max_err_n < 1e-3, max_err_n
    assert frac_n == 0.0
