"""Precomputed, static-shape context shared by proposals and evaluators."""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask


class TargetContext(NamedTuple):
    """Everything the samplers need to know about the (static) target mesh."""

    points: jax.Array  # [Vt, 3]
    cells: jax.Array  # [Ft, 3]
    tri: jax.Array  # [Ft, 3, 3]
    boundary: jax.Array  # [Vt] bool
    # shortlist index for closest-point queries (ops/surface_index.py);
    # None → dense exact query
    index: object = None


def build_target_context(target: TriangleMesh, boundary_mask=None,
                         morton_faces: bool = True,
                         index_k: int = 64,
                         build_index: bool = True) -> TargetContext:
    """build_index: build the K-shortlist index (``ops/surface_index.py``);
    False selects the dense exact query.  Downstream dispatch
    (``closest_auto``/``distances_auto``) depends only on what is built
    here, so the closest-point path is chosen once, at construction."""
    if boundary_mask is None:
        boundary_mask = boundary_vertex_mask(
            np.asarray(target.cells), target.num_points
        )
    points = np.asarray(target.points, np.float32)
    cells = np.asarray(target.cells)
    if morton_faces:
        from icp_proposal_tpu.ops.morton import morton_sort_faces

        # face order is semantically irrelevant; Morton order keeps
        # spatially near faces adjacent
        cells = cells[morton_sort_faces(points, cells)]
    from icp_proposal_tpu.ops.surface_index import build_surface_index

    index = (
        build_surface_index(points, cells, k=index_k) if build_index else None
    )
    # host-side numpy: baked as jit constants, no eager device dispatches
    return TargetContext(
        points=points,
        cells=np.asarray(cells, np.int32),
        tri=points[cells],
        boundary=np.asarray(boundary_mask),
        index=index,
    )
