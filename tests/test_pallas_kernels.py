"""Closest-point paths: the Triton Pallas kernels (in interpret mode)
against their plain-XLA references, nearest vertices, and the choice of
path at context build.

The Triton kernels run compiled only on the GPU (``chip_smoke.py``); here
the interpreter checks their indexing, padding, tie-breaking and batching.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icp_proposal_tpu.models.synthetic import make_icosphere
from icp_proposal_tpu.ops.closest_point import (
    nearest_face_xla,
    nearest_vertices,
    surface_distances,
)
from icp_proposal_tpu.ops.closest_point_triton import (
    nearest_face_triton,
    refine_shortlist_triton,
)
from icp_proposal_tpu.ops.surface_index import (
    _np_point_tri_dist2,
    build_surface_index,
    refine_shortlist,
    refine_shortlist_xla,
)


@pytest.fixture(scope="module")
def sphere():
    points, cells = make_icosphere(subdivisions=2, radius=10.0)
    tri = jnp.asarray(points)[jnp.asarray(cells)]
    return tri


@pytest.fixture(scope="module")
def sphere_index():
    points, cells = make_icosphere(subdivisions=2, radius=10.0)
    return build_surface_index(points, cells, k=16)


def _assert_same_winners(tri, queries, fa, fb):
    """Face ids agree except at exact-distance ties, where the two faces'
    float64 distances must agree to 1e-6 relative."""
    fa, fb = np.asarray(fa).ravel(), np.asarray(fb).ravel()
    q = np.asarray(queries, np.float64).reshape(-1, 3)
    d2 = _np_point_tri_dist2(q, np.asarray(tri, np.float64))
    rows = np.arange(len(q))
    da, db = d2[rows, fa], d2[rows, fb]
    np.testing.assert_allclose(da, db, rtol=1e-6, atol=1e-9)


def test_pallas_matches_jnp(sphere_index, rng):
    """Interpreted Triton refine == XLA refine; both find the dense winner."""
    index = sphere_index
    queries = jnp.asarray(rng.randn(37, 3) * 12, jnp.float32)  # pads to 48
    nv = nearest_vertices(queries, jnp.asarray(index.points))
    f_x = refine_shortlist_xla(index, queries, nv)
    f_t = refine_shortlist_triton(queries, nv, index.cand_tri, index.cand,
                                  interpret=True)
    assert f_t.shape == (37,) and f_t.dtype == jnp.int32
    _assert_same_winners(index.tri, queries, f_x, f_t)
    _, f_d = surface_distances(queries, jnp.asarray(index.tri))
    _assert_same_winners(index.tri, queries, f_x, f_d)


def test_pallas_vmap_shared_triangles(sphere, sphere_index, rng):
    """Under vmap the batch folds into one kernel launch; unbatched
    triangles and candidate tables are shared by the whole batch."""
    queries = jnp.asarray(rng.randn(4, 37, 3) * 12, jnp.float32)
    f_t = jax.vmap(lambda q: nearest_face_triton(q, sphere, interpret=True))(queries)
    f_x = jax.vmap(lambda q: nearest_face_xla(q, sphere))(queries)
    assert f_t.shape == (4, 37) and f_t.dtype == jnp.int32
    _assert_same_winners(sphere, queries, f_x, f_t)
    f_1 = nearest_face_triton(queries[0], sphere, interpret=True)
    np.testing.assert_array_equal(np.asarray(f_1), np.asarray(f_t[0]))

    index = sphere_index
    queries = jnp.asarray(rng.randn(4, 16, 3) * 12, jnp.float32)
    nv = jax.vmap(lambda q: nearest_vertices(q, jnp.asarray(index.points)))(queries)
    f_x = jax.vmap(lambda q, n: refine_shortlist_xla(index, q, n))(queries, nv)
    f_t = jax.vmap(lambda q, n: refine_shortlist_triton(
        q, n, index.cand_tri, index.cand, interpret=True))(queries, nv)
    assert f_t.shape == (4, 16)
    _assert_same_winners(index.tri, queries, f_x, f_t)
    # unbatched queries with batched ids broadcast inside the vmap rule
    f_b = jax.vmap(lambda n: refine_shortlist_triton(
        queries[0], n, index.cand_tri, index.cand, interpret=True))(nv[:1])
    np.testing.assert_array_equal(np.asarray(f_b)[0], np.asarray(f_t)[0])


def test_pallas_vmap_batched_triangles(sphere, rng):
    """Dense query over per-chain current-mesh soups (the t2m evaluator
    path) under vmap: the Triton kernel against XLA, and the dense query
    against the float64 numpy cascade."""
    tris = jnp.stack([sphere, sphere + 1.0, sphere * 1.1])
    queries = jnp.asarray(rng.randn(3, 9, 3) * 12, jnp.float32)
    f_t = jax.vmap(lambda q, t: nearest_face_triton(q, t, interpret=True))(queries, tris)
    f_x = jax.vmap(nearest_face_xla)(queries, tris)
    for i in range(3):
        _assert_same_winners(tris[i], queries[i], f_x[i], f_t[i])
    d2, idx = jax.vmap(surface_distances)(queries, tris)
    for i in range(3):
        ref = _np_point_tri_dist2(np.asarray(queries[i], np.float64),
                                  np.asarray(tris[i], np.float64))
        np.testing.assert_allclose(np.asarray(d2[i]), ref.min(axis=1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            ref[np.arange(9), np.asarray(idx[i])], ref.min(axis=1),
            rtol=1e-5, atol=1e-5)


def test_auto_dispatch_forced(sphere_index, rng):
    """The closest-point path is chosen once, at context build; off CUDA the
    refine and dense ops lower to their XLA references, with gradients
    through the winner's recomputed distance."""
    from icp_proposal_tpu.mesh import make_mesh
    from icp_proposal_tpu.ops.surface_index import closest_auto
    from icp_proposal_tpu.sampling.context import build_target_context

    points, cells = make_icosphere(subdivisions=2, radius=10.0)
    mesh = make_mesh(points, cells)
    dense = build_target_context(mesh, build_index=False)
    assert dense.index is None
    ctx = build_target_context(mesh)
    assert ctx.index is not None and ctx.index.k == 64

    queries = jnp.asarray(rng.randn(10, 3) * 10.5, jnp.float32)
    _, d2_i, _ = closest_auto(queries, ctx.tri, ctx.index)
    _, d2_d, _ = closest_auto(queries, dense.tri, dense.index)
    np.testing.assert_allclose(np.asarray(d2_i), np.asarray(d2_d), rtol=1e-5, atol=1e-5)

    index = sphere_index
    nv = nearest_vertices(queries, jnp.asarray(index.points))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda q, n: refine_shortlist(index, q, n))(queries, nv)),
        np.asarray(refine_shortlist_xla(index, queries, nv)))
    g = jax.grad(lambda q: jnp.sum(closest_auto(q, ctx.tri, ctx.index)[1]))(queries)
    g_d = jax.grad(lambda q: jnp.sum(surface_distances(q, jnp.asarray(dense.tri))[0]))(queries)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_d), rtol=1e-4, atol=1e-4)


def test_nearest_vertices_pallas(sphere, rng):
    pts = jnp.asarray(np.asarray(sphere)[:, 0, :])  # vertex cloud
    queries = jnp.asarray(rng.randn(21, 3) * 12, jnp.float32)
    ids = nearest_vertices(queries, pts)
    d2 = jnp.sum((queries[:, None] - pts[None]) ** 2, axis=-1)
    # distances must match the optimum (ids may differ on exact ties)
    np.testing.assert_allclose(np.asarray(d2[jnp.arange(21), ids]),
                               np.asarray(jnp.min(d2, axis=1)), rtol=1e-6)

    # vmapped, batched queries over shared points
    qb = jnp.asarray(rng.randn(3, 10, 3) * 12, jnp.float32)
    ids_b = jax.vmap(lambda q: nearest_vertices(q, pts))(qb)
    assert ids_b.shape == (3, 10)

    # vmapped with batched points (current-mesh case)
    ptsb = jnp.stack([pts, pts + 0.5])
    qb2 = jnp.asarray(rng.randn(2, 10, 3) * 12, jnp.float32)
    ids_b2 = jax.vmap(nearest_vertices)(qb2, ptsb)
    for i in range(2):
        d2i = jnp.sum((qb2[i][:, None] - ptsb[i][None]) ** 2, axis=-1)
        np.testing.assert_allclose(
            np.asarray(d2i[jnp.arange(10), ids_b2[i]]),
            np.asarray(jnp.min(d2i, axis=1)),
            rtol=1e-6,
        )
