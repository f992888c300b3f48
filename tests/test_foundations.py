"""Foundation tests: IO, mesh topology, geometry kernels, GPMM identities."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icp_proposal_tpu import mesh as meshlib
from icp_proposal_tpu.models import gpmm as gp
from icp_proposal_tpu.ops import closest_point as cp
from icp_proposal_tpu.ops import metrics, rigid


# ---------------------------------------------------------------------- IO

def test_read_femur_stl():
    from icp_proposal_tpu.apps.femur import FEMUR_MESH
    from icp_proposal_tpu.io.stl import read_stl

    points, cells = read_stl(FEMUR_MESH)
    # SURVEY §2.5: 1,622 vertices / 3,240 triangles
    assert points.shape == (1622, 3)
    assert cells.shape == (3240, 3)
    assert cells.min() == 0 and cells.max() == 1621


def test_seeded_femur_workload_deterministic(femur_data):
    """The seeded workload has the reference femur's sizes and is the same
    on every build with the same seed; another seed gives another target."""
    from icp_proposal_tpu.apps.femur import FEMUR_LANDMARK_IDS, make_femur_data

    assert femur_data.model.rank == 51
    assert np.asarray(femur_data.target.points).shape == (1622, 3)
    assert np.asarray(femur_data.target.cells).shape == (3240, 3)
    assert np.asarray(femur_data.model.cells).shape == (3240, 3)
    assert len(femur_data.model_landmarks) == len(FEMUR_LANDMARK_IDS)
    assert not femur_data.target_boundary_mask.any()  # closed surface
    again = make_femur_data(50)
    np.testing.assert_array_equal(np.asarray(again.target.points),
                                  np.asarray(femur_data.target.points))
    np.testing.assert_array_equal(np.asarray(again.model.basis),
                                  np.asarray(femur_data.model.basis))
    other = make_femur_data(50, seed=7)
    assert not np.allclose(np.asarray(other.target.points),
                           np.asarray(femur_data.target.points))
    # landmark alignment undoes most of the seeded rigid motion
    d = np.linalg.norm(np.asarray(femur_data.target.points)
                       - np.asarray(femur_data.model.ref_points), axis=1)
    assert d.mean() < 20.0


def test_femur_data_dir_loader(femur_data, tmp_path):
    """A directory in the reference's layout still loads when passed
    explicitly (statismo model, target STL, landmark JSONs)."""
    from icp_proposal_tpu.apps.femur import load_femur_data
    from icp_proposal_tpu.io.landmarks import write_landmarks
    from icp_proposal_tpu.io.statismo import write_statismo_gpmm
    from icp_proposal_tpu.io.stl import write_stl

    write_statismo_gpmm(tmp_path / "femur_gp_model_50-components.h5", femur_data.model)
    write_stl(tmp_path / "femur_target.stl", np.asarray(femur_data.target.points),
              np.asarray(femur_data.target.cells))
    write_landmarks(tmp_path / "femur_reference.json", femur_data.model_landmarks)
    write_landmarks(tmp_path / "femur_target.json", femur_data.target_landmarks)
    data = load_femur_data(50, data_dir=str(tmp_path))
    assert data.model.rank == 51
    # already aligned, so the landmark alignment is (close to) the identity
    np.testing.assert_allclose(
        np.sort(np.asarray(data.target.points).ravel()),
        np.sort(np.asarray(femur_data.target.points).ravel()), atol=1e-3)


def test_stl_roundtrip(tmp_path):
    from icp_proposal_tpu.apps.femur import FEMUR_MESH
    from icp_proposal_tpu.io.stl import read_stl, write_stl

    points, cells = read_stl(FEMUR_MESH)
    write_stl(tmp_path / "out.stl", points, cells)
    p2, c2 = read_stl(tmp_path / "out.stl")
    assert p2.shape == points.shape
    # welding may reorder; compare sorted point sets
    np.testing.assert_allclose(
        np.sort(points.ravel()), np.sort(p2.ravel()), rtol=1e-6
    )


def test_statismo_reader_matches_reference_mesh(femur_model50, tmp_path):
    from icp_proposal_tpu.apps.femur import FEMUR_MESH
    from icp_proposal_tpu.io.statismo import read_statismo_gpmm, write_statismo_gpmm
    from icp_proposal_tpu.io.stl import read_stl

    points, cells = read_stl(FEMUR_MESH)
    write_statismo_gpmm(tmp_path / "femur_gp_model_50-components.h5", femur_model50)
    model = read_statismo_gpmm(tmp_path / "femur_gp_model_50-components.h5")
    assert model.rank == 51  # 50-component file actually stores 51 columns
    # the representer points should be the same physical surface as the STL
    # (possibly different vertex order) — compare sorted coordinate sets
    np.testing.assert_allclose(
        np.sort(np.asarray(model.ref_points).ravel()),
        np.sort(points.ravel()),
        atol=1e-4,
    )


def test_statismo_roundtrip(tmp_path, femur_model50):
    from icp_proposal_tpu.io.statismo import read_statismo_gpmm, write_statismo_gpmm

    write_statismo_gpmm(tmp_path / "m.h5", femur_model50)
    m2 = read_statismo_gpmm(tmp_path / "m.h5")
    np.testing.assert_allclose(
        np.asarray(m2.basis), np.asarray(femur_model50.basis), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(m2.mean_disp), np.asarray(femur_model50.mean_disp), atol=1e-4
    )


def test_landmarks_and_alignment(femur_data, tmp_path):
    from icp_proposal_tpu.io.landmarks import (
        common_landmarks,
        read_landmarks,
        write_landmarks,
    )

    write_landmarks(tmp_path / "reference.json", femur_data.model_landmarks)
    write_landmarks(tmp_path / "target.json", femur_data.target_landmarks)
    a = read_landmarks(tmp_path / "reference.json")
    b = read_landmarks(tmp_path / "target.json")
    pa, pb, names = common_landmarks(a, b)
    assert len(names) == 6

    # alignment recovers a known rigid transform
    rng = np.random.RandomState(3)
    src = rng.randn(6, 3)
    q = _random_rotation(rng)
    dst = src @ q.T + np.array([1.0, -2.0, 0.5])
    est = rigid.rigid_landmark_alignment(src, dst)
    np.testing.assert_allclose(np.asarray(est.rotation), q, atol=1e-5)
    np.testing.assert_allclose(np.asarray(est.apply(src)), dst, atol=1e-4)


def _random_rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


# ------------------------------------------------------------------- mesh

def test_boundary_mask_plane_patch():
    # 2-triangle square: all 4 vertices are on the boundary
    points = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], dtype=np.float32
    )
    cells = np.array([[0, 1, 2], [1, 3, 2]], dtype=np.int32)
    mask = meshlib.boundary_vertex_mask(cells, 4)
    assert mask.all()


def test_boundary_mask_closed_femur(femur_model50):
    mask = meshlib.boundary_vertex_mask(
        np.asarray(femur_model50.cells), femur_model50.num_points
    )
    assert not mask.any()  # femur reference mesh is closed


def test_vertex_normals_unit(femur_model50):
    n = meshlib.vertex_normals(femur_model50.ref_points, femur_model50.cells)
    norms = np.linalg.norm(np.asarray(n), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


# --------------------------------------------------------- closest point

def test_closest_point_on_triangle_regions():
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 0.0, 0.0])
    c = jnp.array([0.0, 1.0, 0.0])

    cases = [
        (jnp.array([0.25, 0.25, 1.0]), jnp.array([0.25, 0.25, 0.0])),  # interior
        (jnp.array([-1.0, -1.0, 0.0]), a),  # vertex A
        (jnp.array([2.0, 0.0, 0.0]), b),  # vertex B
        (jnp.array([0.0, 2.0, 0.5]), c),  # vertex C
        (jnp.array([0.5, -1.0, 0.0]), jnp.array([0.5, 0.0, 0.0])),  # edge AB
        (jnp.array([-1.0, 0.5, 0.0]), jnp.array([0.0, 0.5, 0.0])),  # edge AC
        (jnp.array([1.0, 1.0, 0.0]), jnp.array([0.5, 0.5, 0.0])),  # edge BC
    ]
    for p, expected in cases:
        point, d2 = cp.closest_point_on_triangle(p, a, b, c)
        np.testing.assert_allclose(np.asarray(point), np.asarray(expected), atol=1e-6)
        np.testing.assert_allclose(
            float(d2), float(jnp.sum((p - expected) ** 2)), atol=1e-6
        )


def test_closest_point_vs_bruteforce_sampling(femur_model50, rng):
    """Cross-validate the surface query against dense point sampling."""
    m = femur_model50.reference_mesh()
    tri = m.triangles()
    queries = jnp.asarray(
        np.asarray(m.points)[rng.choice(m.num_points, 20)] + rng.randn(20, 3) * 5,
        jnp.float32,
    )
    cps, d2, fidx = cp.closest_points_on_surface(queries, tri)

    # densely sample each triangle and verify no sampled point is closer
    t = np.asarray(tri)
    u, v = np.meshgrid(np.linspace(0, 1, 12), np.linspace(0, 1, 12))
    uu, vv = u.ravel(), v.ravel()
    keep = uu + vv <= 1.0
    uu, vv = uu[keep], vv[keep]
    pts = (
        t[:, None, 0] * (1 - uu - vv)[None, :, None]
        + t[:, None, 1] * uu[None, :, None]
        + t[:, None, 2] * vv[None, :, None]
    ).reshape(-1, 3)
    q = np.asarray(queries)
    dmin_sampled = np.min(
        np.linalg.norm(q[:, None, :] - pts[None], axis=-1), axis=1
    )
    d = np.sqrt(np.asarray(d2))
    assert (d <= dmin_sampled + 1e-4).all()


def test_nearest_vertices(femur_model50):
    pts = femur_model50.ref_points
    ids = cp.nearest_vertices(pts[:17] + 1e-4, pts)
    np.testing.assert_array_equal(np.asarray(ids), np.arange(17))


def test_metrics_identity(femur_model50):
    m = femur_model50.reference_mesh()
    assert float(metrics.avg_distance(m, m)) < 1e-3
    assert float(metrics.hausdorff_distance(m, m)) < 1e-3


# -------------------------------------------------------------------- GPMM

def test_instance_coefficients_roundtrip(femur_model50, rng):
    alpha = jnp.asarray(rng.randn(femur_model50.rank), jnp.float32)
    pts = gp.instance_points(femur_model50, alpha)
    alpha_rec = gp.coefficients(femur_model50, pts)
    np.testing.assert_allclose(np.asarray(alpha_rec), np.asarray(alpha), atol=2e-3)


def test_prior_logpdf():
    r = 50
    z = jnp.zeros(r)
    expected = -0.5 * r * np.log(2 * np.pi)
    np.testing.assert_allclose(float(gp.prior_logpdf(z)), expected, rtol=1e-6)


def test_posterior_shrinks_towards_observation(femur_model50, rng):
    """Observing the mean shape displaced along one basis direction should
    recover coefficients close to that direction."""
    model = femur_model50
    alpha_true = jnp.zeros(model.rank).at[0].set(2.0)
    disp = gp.instance_displacement(model, alpha_true)  # [V,3]
    ids = jnp.asarray(rng.choice(model.num_points, 200, replace=False))
    factors = gp.posterior_factors_isotropic(
        model, ids, disp[ids], sigma2=1e-4, mask=jnp.ones(200)
    )
    # alpha_hat should reproduce the generating coefficients
    np.testing.assert_allclose(
        np.asarray(factors.alpha_hat), np.asarray(alpha_true), atol=0.05
    )


def test_posterior_masking_equals_filtering(femur_model50, rng):
    model = femur_model50
    ids = jnp.asarray(rng.choice(model.num_points, 100, replace=False))
    disp = jnp.asarray(rng.randn(100, 3), jnp.float32)
    normals = jnp.asarray(
        rng.randn(100, 3) / np.linalg.norm(rng.randn(100, 3), axis=1, keepdims=True),
        jnp.float32,
    )
    normals = normals / jnp.linalg.norm(normals, axis=1, keepdims=True)
    mask = jnp.asarray((rng.rand(100) > 0.3).astype(np.float32))

    f_masked = gp.posterior_factors_anisotropic(
        model, ids, disp, normals, 5.0, 10.0, mask
    )
    keep = np.asarray(mask) > 0
    f_filtered = gp.posterior_factors_anisotropic(
        model,
        ids[keep],
        disp[keep],
        normals[keep],
        5.0,
        10.0,
        jnp.ones(int(keep.sum())),
    )
    np.testing.assert_allclose(
        np.asarray(f_masked.alpha_hat), np.asarray(f_filtered.alpha_hat), atol=1e-3
    )
    np.testing.assert_allclose(
        float(f_masked.logdet_m), float(f_filtered.logdet_m), rtol=1e-4
    )


def test_posterior_sampling_moments(femur_model50, rng):
    """Sample moments of α* ~ N(α̂, M⁻¹) match the analytic factors."""
    model = femur_model50
    ids = jnp.asarray(rng.choice(model.num_points, 80, replace=False))
    disp = jnp.asarray(rng.randn(80, 3).astype(np.float32) * 2)
    factors = gp.posterior_factors_isotropic(
        model, ids, disp, sigma2=25.0, mask=jnp.ones(80)
    )
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    samples = jax.vmap(lambda k: gp.sample_posterior_coeffs(k, factors))(keys)
    s = np.asarray(samples)
    np.testing.assert_allclose(
        s.mean(axis=0), np.asarray(factors.alpha_hat), atol=0.15
    )
    # covariance check on a few entries
    m = np.asarray(factors.chol_m @ factors.chol_m.T)
    cov_true = np.linalg.inv(m)
    cov_emp = np.cov(s.T)
    np.testing.assert_allclose(
        np.diag(cov_emp), np.diag(cov_true), rtol=0.25, atol=0.01
    )


def test_transition_logpdf_consistency(femur_model50, rng):
    """transition_logpdf equals the dense MVN logpdf of N(α̂, M⁻¹)."""
    model = femur_model50
    ids = jnp.asarray(rng.choice(model.num_points, 60, replace=False))
    disp = jnp.asarray(rng.randn(60, 3), jnp.float32)
    factors = gp.posterior_factors_isotropic(
        model, ids, disp, sigma2=4.0, mask=jnp.ones(60)
    )
    alpha = jnp.asarray(rng.randn(model.rank), jnp.float32) * 0.1 + factors.alpha_hat

    m = np.asarray(factors.chol_m @ factors.chol_m.T).astype(np.float64)
    cov = np.linalg.inv(m)
    diff = np.asarray(alpha - factors.alpha_hat, dtype=np.float64)
    expected = (
        -0.5 * diff @ m @ diff
        - 0.5 * model.rank * np.log(2 * np.pi)
        + 0.5 * np.linalg.slogdet(m)[1]
    )
    got = float(gp.transition_logpdf(factors, alpha, include_logdet=True))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=0.05)

    got_ref = float(gp.transition_logpdf(factors, alpha, include_logdet=False))
    np.testing.assert_allclose(
        got_ref, expected - 0.5 * np.linalg.slogdet(m)[1], rtol=1e-4, atol=0.05
    )


def test_vertex_normals_gather_matches_scatter(femur_model50):
    from icp_proposal_tpu.mesh import (
        vertex_face_adjacency,
        vertex_normals,
        vertex_normals_gather,
    )

    adj = vertex_face_adjacency(
        np.asarray(femur_model50.cells), femur_model50.num_points
    )
    n_scatter = vertex_normals(femur_model50.ref_points, femur_model50.cells)
    n_gather = vertex_normals_gather(
        femur_model50.ref_points, femur_model50.cells, jnp.asarray(adj)
    )
    np.testing.assert_allclose(
        np.asarray(n_gather), np.asarray(n_scatter), atol=1e-5
    )
