"""Closest-point kernels in Pallas through Triton (NVIDIA GPUs).

Two kernels, each with a plain-XLA reference of the same contract that
runs everywhere else and in the tests (``jax.lax.platform_dependent`` picks
the kernel on CUDA devices):

* ``nearest_face_triton`` — nearest face of a triangle soup per query, the
  reference being ``closest_point.nearest_face_xla``.  Each program takes
  TQ queries and streams the faces through registers in tiles of TF,
  keeping a running minimum and its face id: no [B, P, F] distance buffer
  reaches device memory (XLA's dense form materialises several).
* ``refine_shortlist_triton`` — winner among the K shortlist candidates of
  each query's nearest vertex, the reference being
  ``surface_index.refine_shortlist_xla``.  Each program takes TQ queries,
  loads their candidate rows from the component-major table
  (``SurfaceIndex.cand_tri``, [V, 9·K], ≈3.7 MB at the femur's V = 1,622,
  K = 64, so it stays in L2) by nearest-vertex id, runs the cascade on
  [TQ, K] register tiles and writes one int32 per query.

Both return the least distance's face id, ties to the smallest id.  Both
use ``closest_point.triangle_dist2_components``, so they round like the
references.  The ``interpret`` flag runs them on the CPU; only the tests
set it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from icp_proposal_tpu.ops.closest_point import triangle_dist2_components

TQ = 16  # queries per program (refine: 16 × K=64 lanes over 4 warps)
TQ_DENSE, TF = 32, 32  # dense: queries per program × faces per tile
_FAR = 1e6  # padding triangles sit this far out (mm) and never win
_NO_FACE = jnp.iinfo(jnp.int32).max
_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=1)


# ---------------------------------------------------------------------------
# dense nearest face
# ---------------------------------------------------------------------------

def _dense_kernel(q_ref, t_ref, out_ref, *, n_tiles: int, shared: bool):
    b, i = pl.program_id(0), pl.program_id(1)
    rows = pl.ds(i * TQ_DENSE, TQ_DENSE)
    bt = 0 if shared else b
    p = tuple(q_ref[c, b, rows][:, None] for c in range(3))  # [TQ, 1]

    def tile(j, carry):
        best, arg = carry
        cols = pl.ds(j * TF, TF)
        t = [t_ref[bt, c, cols][None, :] for c in range(9)]  # [1, TF]
        d2 = triangle_dist2_components(p, t[0:3], t[3:6], t[6:9])  # [TQ, TF]
        t_best = jnp.min(d2, axis=1)
        ids = j * TF + jax.lax.broadcasted_iota(jnp.int32, (TQ_DENSE, TF), 1)
        t_arg = jnp.min(jnp.where(d2 == t_best[:, None], ids, _NO_FACE), axis=1)
        better = t_best < best  # strict: earlier tiles keep ties
        return jnp.where(better, t_best, best), jnp.where(better, t_arg, arg)

    init = (jnp.full((TQ_DENSE,), jnp.inf, jnp.float32),
            jnp.zeros((TQ_DENSE,), jnp.int32))
    out_ref[b, rows] = jax.lax.fori_loop(0, n_tiles, tile, init)[1]


def _dense_call(queries, triangles, shared: bool, interpret: bool):
    """queries [B, P, 3], triangles [Bt, F, 3, 3] (Bt = 1 when shared)
    → nearest face id [B, P]."""
    bsz, p, _ = queries.shape
    bt, f = triangles.shape[:2]
    pp = -(-p // TQ_DENSE) * TQ_DENSE
    fp = -(-f // TF) * TF
    q = jnp.pad(jnp.moveaxis(queries, -1, 0), ((0, 0), (0, 0), (0, pp - p)))
    t = jnp.swapaxes(triangles.reshape(bt, f, 9), 1, 2)  # [Bt, 9, F]
    t = jnp.pad(t, ((0, 0), (0, 0), (0, fp - f)), constant_values=_FAR)
    out = pl.pallas_call(
        functools.partial(_dense_kernel, n_tiles=fp // TF, shared=shared),
        out_shape=jax.ShapeDtypeStruct((bsz, pp), jnp.int32),
        grid=(bsz, pp // TQ_DENSE),
        compiler_params=_PARAMS,
        backend="triton",
        interpret=interpret,
        name="nearest_face",
    )(q, t)
    return out[:, :p]


def nearest_face_triton(queries, triangles, interpret=False):
    """queries [P, 3], triangles [F, 3, 3] → nearest face id [P] int32.
    Under ``vmap`` the batch becomes a grid axis of one launch; unbatched
    triangles are shared by every batch element."""

    @jax.custom_batching.custom_vmap
    def call(q, t):
        return _dense_call(q[None], t[None], True, interpret)[0]

    @call.def_vmap
    def _vmap(axis_size, in_batched, q, t):
        q_b, t_b = in_batched
        if not q_b:
            q = jnp.broadcast_to(q, (axis_size,) + q.shape)
        return _dense_call(q, t if t_b else t[None], not t_b, interpret), True

    return call(queries, triangles)


# ---------------------------------------------------------------------------
# shortlist refine
# ---------------------------------------------------------------------------

def _refine_kernel(qx_ref, qy_ref, qz_ref, nv_ref, tab_ref, cand_ref, out_ref,
                   *, k: int):
    rows = pl.ds(pl.program_id(0) * TQ, TQ)
    nv = nv_ref[rows]  # [TQ]
    p = tuple(r[rows][:, None] for r in (qx_ref, qy_ref, qz_ref))  # [TQ, 1]
    t = [tab_ref[nv, pl.ds(i * k, k)] for i in range(9)]  # [TQ, K] each
    d2 = triangle_dist2_components(p, t[0:3], t[3:6], t[6:9])
    faces = cand_ref[nv, pl.ds(0, k)]  # [TQ, K]
    best = jnp.min(d2, axis=1, keepdims=True)
    out_ref[rows] = jnp.min(jnp.where(d2 == best, faces, _NO_FACE), axis=1)


def _refine_flat(queries, nv, cand_tri, cand, interpret):
    """queries [N, 3], nv [N] → winner face id [N]."""
    n, k = nv.shape[0], cand.shape[1]
    n_pad = -(-n // TQ) * TQ
    q = jnp.pad(queries, ((0, n_pad - n), (0, 0)))
    nv = jnp.pad(nv.astype(jnp.int32), (0, n_pad - n))
    out = pl.pallas_call(
        functools.partial(_refine_kernel, k=k),
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        grid=(n_pad // TQ,),
        compiler_params=_PARAMS,
        backend="triton",
        interpret=interpret,
        name="shortlist_refine",
    )(q[:, 0], q[:, 1], q[:, 2], nv, cand_tri, cand)
    return out[:n]


def refine_shortlist_triton(queries, nv, cand_tri, cand, interpret=False):
    """queries [..., 3] f32, nv [...] nearest-vertex ids, cand_tri [V, 9K],
    cand [V, K] → winner face id [...] int32.  Any leading batch shape;
    under ``vmap`` every batch axis folds into the one launch."""

    @jax.custom_batching.custom_vmap
    def call(q, n):
        out = _refine_flat(q.reshape(-1, 3), n.reshape(-1), cand_tri, cand,
                           interpret)
        return out.reshape(n.shape)

    @call.def_vmap
    def _vmap(axis_size, in_batched, q, n):
        q_b, n_b = in_batched
        if not q_b:
            q = jnp.broadcast_to(q, (axis_size,) + q.shape)
        if not n_b:
            n = jnp.broadcast_to(n, (axis_size,) + n.shape)
        return call(q, n), True

    return call(queries, nv)
