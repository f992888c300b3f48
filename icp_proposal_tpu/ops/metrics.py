"""Mesh comparison metrics.

TPU-native equivalents of scalismo's ``MeshMetrics`` (call sites: reference
``api/other/RegistrationComparison.scala:24-48``,
``apps/femur/StdIcpVsChainICPrandomInitComparisonAll.scala:43-48``).
All metrics are reductions over the same batched closest-point kernel.
"""
from __future__ import annotations

import jax.numpy as jnp

from icp_proposal_tpu.mesh import TriangleMesh
from icp_proposal_tpu.ops.closest_point import (
    closest_points_on_surface,
    nearest_vertex_of_faces,
    surface_distances,
)


def directed_distances(points, target: TriangleMesh):
    """Point→surface distances [P] from points to the target mesh."""
    d2, _ = surface_distances(points, target.triangles())
    return jnp.sqrt(d2)


def avg_distance(mesh_a: TriangleMesh, mesh_b: TriangleMesh):
    """Mean distance from mesh_a's vertices to mesh_b's surface
    (scalismo ``MeshMetrics.avgDistance`` convention: one-directional,
    averaged over mesh_a vertices)."""
    return jnp.mean(directed_distances(mesh_a.points, mesh_b))


def hausdorff_distance(mesh_a: TriangleMesh, mesh_b: TriangleMesh):
    """max of the two directed max point→surface distances
    (scalismo ``MeshMetrics.hausdorffDistance``)."""
    d_ab = jnp.max(directed_distances(mesh_a.points, mesh_b))
    d_ba = jnp.max(directed_distances(mesh_b.points, mesh_a))
    return jnp.maximum(d_ab, d_ba)


def dice_coefficient(mesh_a: TriangleMesh, mesh_b: TriangleMesh, key=None,
                     n_samples: int = 20000):
    """Volumetric Dice overlap 2·|A∩B| / (|A|+|B|), Monte-Carlo estimated with
    winding-number inside tests over the joint bounding box (scalismo
    voxelizes instead — ``MeshMetrics.diceCoefficient``; same quantity up to
    discretization)."""
    import jax

    from icp_proposal_tpu.ops.inside import points_inside

    key = key if key is not None else jax.random.PRNGKey(0)
    lo = jnp.minimum(jnp.min(mesh_a.points, axis=0), jnp.min(mesh_b.points, axis=0))
    hi = jnp.maximum(jnp.max(mesh_a.points, axis=0), jnp.max(mesh_b.points, axis=0))
    pts = lo + (hi - lo) * jax.random.uniform(key, (n_samples, 3))
    in_a = points_inside(pts, mesh_a.triangles())
    in_b = points_inside(pts, mesh_b.triangles())
    inter = jnp.sum(in_a & in_b)
    total = jnp.sum(in_a) + jnp.sum(in_b)
    return 2.0 * inter / jnp.maximum(total, 1)


def dice_coefficient_voxel(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                           grid_n: int = 48, chunk: int = 8192):
    """Volumetric Dice on a regular voxel grid — the scalismo convention
    (``MeshMetrics.diceCoefficient`` rasterizes both meshes into a binary
    image and counts voxels).  Voxel centers on a uniform grid_n³ lattice
    over the joint bounding box; inside tests via winding numbers, chunked
    to bound the [P, F] working set.

    Exists to *quantify* the discretization gap between scalismo's
    voxelization and our Monte-Carlo ``dice_coefficient`` (same quantity,
    different quadrature — see tests/test_foundations.py's analytic
    two-sphere check)."""
    import jax

    from icp_proposal_tpu.ops.inside import winding_numbers

    lo = jnp.minimum(jnp.min(mesh_a.points, axis=0), jnp.min(mesh_b.points, axis=0))
    hi = jnp.maximum(jnp.max(mesh_a.points, axis=0), jnp.max(mesh_b.points, axis=0))
    # voxel CENTERS: offset half a cell like an image rasterization
    ax = [lo[i] + (hi[i] - lo[i]) * (jnp.arange(grid_n) + 0.5) / grid_n
          for i in range(3)]
    gx, gy, gz = jnp.meshgrid(*ax, indexing="ij")
    pts = jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)  # [n³, 3]
    n = pts.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(pts, ((0, pad), (0, 0)), constant_values=1e6)
    tri_a, tri_b = mesh_a.triangles(), mesh_b.triangles()

    def one(chunk_pts):
        ina = winding_numbers(chunk_pts, tri_a) > 0.5
        inb = winding_numbers(chunk_pts, tri_b) > 0.5
        return jnp.sum(ina & inb), jnp.sum(ina) + jnp.sum(inb)

    inter, total = jax.lax.map(one, pts.reshape(-1, chunk, 3))
    return 2.0 * jnp.sum(inter) / jnp.maximum(jnp.sum(total), 1)


def avg_and_max_distance_boundary_aware(
    mesh_a: TriangleMesh, mesh_b: TriangleMesh, boundary_mask_b
):
    """(avg, max) distance from mesh_a vertices to mesh_b's surface, excluding
    correspondences whose nearest mesh_b vertex is on the boundary.

    Masked-reduction formulation of reference
    ``RegistrationComparison.scala:31-48`` (which filters a variable-length
    list): excluded entries contribute 0 weight to the mean and -inf to the
    max, keeping shapes static under jit.
    """
    tri = mesh_b.triangles()
    cp, d2, face_idx = closest_points_on_surface(mesh_a.points, tri)
    near_ids = nearest_vertex_of_faces(mesh_b.cells, face_idx, cp, mesh_b.points)
    keep = ~boundary_mask_b[near_ids]
    d = jnp.sqrt(d2)
    wsum = jnp.maximum(jnp.sum(keep), 1)
    avg = jnp.sum(jnp.where(keep, d, 0.0)) / wsum
    mx = jnp.max(jnp.where(keep, d, -jnp.inf))
    return avg, mx
