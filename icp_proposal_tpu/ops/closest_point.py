"""Batched point→surface closest-point queries.

Equivalent of scalismo's ``closestPointOnSurface`` / ``findClosestPoint``
(BVH-accelerated on the JVM; call sites at reference
``NonRigidIcpProposal.scala:97-122`` and
``IndependentPointDistanceEvaluator.scala:40-54``).

Design: for the reference's workload sizes (hundreds of query points × a few
thousand triangles, × many vmapped chains) the exact query is a dense,
branchless brute force — all point/triangle pairs with a min-reduction, no
trees, no data-dependent control flow.  The point-in-triangle region
selection (Ericson, Real-Time Collision Detection §5.1.5) is expressed as a
`where`-cascade so the whole query compiles to a fixed-shape elementwise
program.  Queries against a static surface can use the shortlist index
instead (``ops/surface_index.py``).

Two-pass structure: pass 1 finds the nearest face per query (a Triton
kernel on the GPU, a fused XLA argmin elsewhere); pass 2 recomputes the
closest point for the single winning face per query in jnp.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _safe_div(num, den):
    den_safe = jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    return num / den_safe


def barycentric_cascade(d1, d2, d3, d4, d5, d6):
    """Barycentric (v, w) of the closest point on a triangle from the six
    dot products d1 = ab·ap, d2 = ac·ap, d3 = ab·bp, d4 = ac·bp,
    d5 = ab·cp, d6 = ac·cp.  Branchless region classification; elementwise,
    so it serves both the vector form below and component-form kernels."""
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # interior (lowest priority)
    denom = _safe_div(1.0, va + vb + vc)
    v = vb * denom
    w = vc * denom

    # edge BC
    in_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    v = jnp.where(in_bc, 1.0 - w_bc, v)
    w = jnp.where(in_bc, w_bc, w)

    # edge AC
    in_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    w_ac = _safe_div(d2, d2 - d6)
    v = jnp.where(in_ac, 0.0, v)
    w = jnp.where(in_ac, w_ac, w)

    # edge AB
    in_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    v_ab = _safe_div(d1, d1 - d3)
    v = jnp.where(in_ab, v_ab, v)
    w = jnp.where(in_ab, 0.0, w)

    # vertex C
    in_c = (d6 >= 0.0) & (d5 <= d6)
    v = jnp.where(in_c, 0.0, v)
    w = jnp.where(in_c, 1.0, w)

    # vertex B
    in_b = (d3 >= 0.0) & (d4 <= d3)
    v = jnp.where(in_b, 1.0, v)
    w = jnp.where(in_b, 0.0, w)

    # vertex A (highest priority)
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    v = jnp.where(in_a, 0.0, v)
    w = jnp.where(in_a, 0.0, w)

    # degenerate-triangle safety: clamp to valid barycentric range
    v = jnp.clip(v, 0.0, 1.0)
    w = jnp.clip(w, 0.0, 1.0)
    s = v + w
    scale = jnp.where(s > 1.0, 1.0 / jnp.maximum(s, 1e-30), 1.0)
    return v * scale, w * scale


def closest_point_on_triangle(p, a, b, c):
    """Closest point on triangle (a,b,c) to p; broadcasts over leading dims.

    Returns (point, dist2). Branchless region classification.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    bp = p - b
    cp = p - c
    v, w = barycentric_cascade(
        _dot(ab, ap), _dot(ac, ap), _dot(ab, bp), _dot(ac, bp),
        _dot(ab, cp), _dot(ac, cp),
    )
    point = a + v[..., None] * ab + w[..., None] * ac
    diff = p - point
    return point, _dot(diff, diff)


def triangle_dist2_components(p, a, b, c):
    """Squared point→triangle distance in component form: p, a, b, c are
    3-tuples of broadcastable arrays (x, y, z).  Same operations in the
    same order as ``closest_point_on_triangle``, so both forms round alike
    and exact ties (shared edges and vertices) resolve alike."""
    def sub(x, y):
        return tuple(xi - yi for xi, yi in zip(x, y))

    def dot(x, y):
        return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]

    ab, ac = sub(b, a), sub(c, a)
    ap, bp, cp = sub(p, a), sub(p, b), sub(p, c)
    v, w = barycentric_cascade(dot(ab, ap), dot(ac, ap), dot(ab, bp),
                               dot(ac, bp), dot(ab, cp), dot(ac, cp))
    diff = tuple(pi - (ai + v * abi + w * aci)
                 for pi, ai, abi, aci in zip(p, a, ab, ac))
    return dot(diff, diff)


def nearest_face_xla(queries, triangles):
    """Nearest face id [P] of a triangle soup by dense [P, F] argmin (ties
    to the smallest id).  Plain XLA; the reference for the Triton kernel."""
    d2 = closest_point_on_triangle(
        queries[:, None, :], triangles[None, :, 0], triangles[None, :, 1],
        triangles[None, :, 2],
    )[1]  # [P, F]
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


def nearest_face(queries, triangles):
    """Nearest face id [P] for queries [P, 3] against triangles [F, 3, 3]:
    the Triton streaming kernel on CUDA devices (no [P, F] buffer reaches
    device memory), ``nearest_face_xla`` elsewhere.  No gradient."""
    from icp_proposal_tpu.ops.closest_point_triton import nearest_face_triton

    q, t = jax.lax.stop_gradient(queries), jax.lax.stop_gradient(triangles)
    return jax.lax.platform_dependent(
        q, t, cuda=nearest_face_triton, default=nearest_face_xla)


@jax.jit
def surface_distances(queries, triangles):
    """Squared distance from each query to a triangle soup.

    queries : [P, 3]; triangles : [F, 3, 3] → (dist2 [P], face_idx [P]).
    The winner's distance is recomputed once in jnp, so gradients flow
    through it (the winner id is piecewise-constant in the inputs).
    """
    _, d2, face_idx = closest_points_on_surface(queries, triangles)
    return d2, face_idx


def closest_points_on_surface(queries, triangles):
    """Full closest-point query.

    queries : [P, 3]; triangles : [F, 3, 3]
    Returns (points [P,3], dist2 [P], face_idx [P]).
    """
    face_idx = nearest_face(queries, triangles)
    tri = jnp.asarray(triangles)[face_idx]  # [P, 3, 3]
    cp, dist2 = closest_point_on_triangle(queries, tri[:, 0], tri[:, 1], tri[:, 2])
    return cp, dist2, face_idx


def nearest_vertices(queries, points):
    """Nearest-vertex ids: queries [P,3] vs points [V,3] → ids [P].

    Replaces scalismo's KD-tree ``findClosestPoint`` with a dense [P, V]
    min-reduction.
    """
    d2 = jnp.sum(
        (queries[:, None, :] - points[None, :, :]) ** 2, axis=-1
    )  # [P, V]
    return jnp.argmin(d2, axis=1)


def nearest_vertex_of_faces(cells, face_idx, cp, points):
    """Nearest of the 3 corners of the hit face to the closest point.

    A cheaper stand-in for a full nearest-vertex query when the closest
    surface point is already known: the globally nearest vertex to a point
    lying on face f is one of f's corners for well-shaped meshes.  Used where
    the reference chains ``closestPointOnSurface`` + ``findClosestPoint``
    (e.g. ``NonRigidIcpProposal.scala:97-99``).
    """
    corner_ids = jnp.asarray(cells)[face_idx]  # [P, 3]
    corners = jnp.asarray(points)[corner_ids]  # [P, 3, 3]
    d2 = jnp.sum((corners - cp[:, None, :]) ** 2, axis=-1)  # [P, 3]
    pick = jnp.argmin(d2, axis=1)
    return jnp.take_along_axis(corner_ids, pick[:, None], axis=1)[:, 0]
