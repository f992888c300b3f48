"""Time each closest-point and solve path on the GPU, alone and in the step.

At the bench shape (femur GPMM-100, 2,048 chains, 400 evaluator queries per
chain, K = 64 shortlist), one process:

  * times one closest-point pass four ways — dense and shortlist index,
    each with its Triton kernel and with the plain-XLA reference — plus the
    kernels alone and the nearest-vertex stage alone;
  * times the dense Hausdorff evaluator (256 states) with each dense form;
  * times ``chol_solve`` and ``tri_solve_lt`` at [2048, r, r], r = 101, 201;
  * times the flagship MH step (20-step scan segments at 2,048 chains) with
    each closest-point path, and once more at the default (TF32) matmul
    precision, and prints each compiled step's ``memory_analysis()``.

Prints one JSON line per measurement and writes them all to
``chiprun_out/kernel_timings.json`` (``--out``).  Needs a GPU.

    python tools/kernel_timings.py
"""
from __future__ import annotations

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import contextlib
import json
import statistics
import time
import traceback


def _time(fn, *args, reps=10):
    """Median wall seconds of ``fn(*args)`` after one warm-up (compile) call."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times), compile_s


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--chains", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/kernel_timings.json")
    args = ap.parse_args()

    from icp_proposal_tpu.utils.profiling import (
        enable_compilation_cache,
        gpu_name_and_power_limit,
        require_platform,
    )

    enable_compilation_cache()
    devices = require_platform("gpu")
    card = gpu_name_and_power_limit()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from icp_proposal_tpu.apps.femur import load_femur_data, make_icp_proposal_setup
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm
    from icp_proposal_tpu.ops import closest_point, surface_index
    from icp_proposal_tpu.ops.closest_point import (
        closest_point_on_triangle,
        nearest_face_xla,
        nearest_vertices,
    )
    from icp_proposal_tpu.ops.closest_point_triton import (
        nearest_face_triton,
        refine_shortlist_triton,
    )
    from icp_proposal_tpu.ops.linalg import chol_solve, tri_solve_lt
    from icp_proposal_tpu.ops.surface_index import refine_shortlist_xla
    from icp_proposal_tpu.sampling import mh
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import HausdorffSpec, build_evaluator
    from icp_proposal_tpu.sampling.state import init_state, transformed_points

    rows = []

    @contextlib.contextmanager
    def guard(what, path):
        """Record a failed measurement and go on with the others."""
        try:
            yield
        except Exception as e:  # noqa: BLE001 — one path's failure is a result
            traceback.print_exc()
            emit(what=what, path=path, error=f"{type(e).__name__}: {e}"[:2000])

    def emit(**row):
        row.update(card=card, device=devices[0].device_kind)
        rows.append(row)
        print(json.dumps(row), flush=True)

    nearest_face_default = closest_point.nearest_face
    refine_default = surface_index.refine_shortlist
    b = args.chains
    data = load_femur_data(100)
    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask)
    idx = ctx.index
    tri = jnp.asarray(ctx.tri)
    pts = jnp.asarray(idx.points)
    _, _, evaluator = make_icp_proposal_setup(data)
    eval_ids = jnp.asarray(evaluator.model_ids("distance"))  # [400]

    # chain-like queries: prior draws at the evaluator ids
    coeffs = jax.random.normal(jax.random.PRNGKey(0), (b, model.rank))
    queries = jax.jit(lambda c: jnp.einsum(
        "vir,br->bvi", jnp.asarray(model.sbasis)[eval_ids], c,
        precision="highest") + jnp.asarray(model.ref_points)[eval_ids])(coeffs)

    def closest(q, fidx):
        w = tri[fidx]
        return closest_point_on_triangle(q, w[:, 0], w[:, 1], w[:, 2])

    def nv_of(q):
        return nearest_vertices(q, pts)

    passes = {
        "dense_xla": lambda q: closest(q, nearest_face_xla(q, tri)),
        "dense_triton": lambda q: closest(q, nearest_face_triton(q, tri)),
        "index_xla": lambda q: closest(q, refine_shortlist_xla(idx, q, nv_of(q))),
        "index_triton": lambda q: closest(q, refine_shortlist_triton(
            q, nv_of(q), idx.cand_tri, idx.cand)),
    }
    for name, f in passes.items():
        with guard("closest_point_pass", name):
            med, lo, hi, comp = _time(jax.jit(jax.vmap(f)), queries)
            emit(what="closest_point_pass", path=name, shape=[b, 400],
                 ms=med * 1e3, ms_min=lo * 1e3, ms_max=hi * 1e3, compile_s=comp)

    nv_fn = jax.jit(jax.vmap(nv_of))
    med, lo, hi, comp = _time(nv_fn, queries)
    emit(what="nearest_vertices", shape=[b, 400, int(pts.shape[0])],
         ms=med * 1e3, ms_min=lo * 1e3, ms_max=hi * 1e3, compile_s=comp)
    nv = nv_fn(queries)
    kernels = {
        "refine_xla": (jax.jit(jax.vmap(lambda q, n: refine_shortlist_xla(idx, q, n))),
                       (queries, nv)),
        "refine_triton": (jax.jit(jax.vmap(lambda q, n: refine_shortlist_triton(
            q, n, idx.cand_tri, idx.cand))), (queries, nv)),
        "nearest_face_xla": (jax.jit(jax.vmap(lambda q: nearest_face_xla(q, tri))),
                             (queries,)),
        "nearest_face_triton": (jax.jit(jax.vmap(lambda q: nearest_face_triton(q, tri))),
                                (queries,)),
    }
    winners = {}
    for name, (fn, fargs) in kernels.items():
        with guard("kernel", name):
            med, lo, hi, comp = _time(fn, *fargs)
            winners[name] = np.asarray(fn(*fargs))
            emit(what="kernel", path=name, ms=med * 1e3, ms_min=lo * 1e3,
                 ms_max=hi * 1e3, compile_s=comp)
    for a_, b_ in (("refine_xla", "refine_triton"),
                   ("nearest_face_xla", "nearest_face_triton")):
        if a_ in winners and b_ in winners:
            emit(what="kernel_agreement", pair=[a_, b_],
                 frac_equal=float(np.mean(winners[a_] == winners[b_])))

    # the dense path's main user: the Hausdorff evaluator (per-chain surface)
    haus = build_evaluator(model, ctx, [HausdorffSpec(rate=1.0)])
    hb = min(256, b)
    hstates = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (hb,) + jnp.shape(x)), init_state(model))
    hstates = hstates._replace(coeffs=0.3 * coeffs[:hb])
    for name, nf in (("xla", nearest_face_xla), ("triton", nearest_face_triton)):
        with guard("hausdorff_evaluator", name):
            closest_point.nearest_face = lambda q, t, nf=nf: nf(
                jax.lax.stop_gradient(q), jax.lax.stop_gradient(t))
            jax.clear_caches()
            fn = jax.jit(jax.vmap(lambda s: haus(s, transformed_points(model, s))[0]))
            med, lo, hi, comp = _time(fn, hstates, reps=5)
            emit(what="hausdorff_evaluator", path=name, shape=[hb, 1622, 3240],
                 ms=med * 1e3, ms_min=lo * 1e3, ms_max=hi * 1e3, compile_s=comp)
    closest_point.nearest_face = nearest_face_default
    jax.clear_caches()

    # batched SPD solves at the posterior's ranks
    rng = np.random.default_rng(0)
    for comps in (100, 200):
        r = comps + 1
        m_model = model if comps == 100 else build_femur_gpmm(
            np.asarray(model.ref_points), np.asarray(model.cells), comps)
        q = np.asarray(m_model.sbasis, np.float64)[rng.choice(
            model.num_points, 200, replace=False)].reshape(-1, r)
        m = np.eye(r) + q.T @ q / 4.0
        m_b = jnp.broadcast_to(jnp.asarray(m, jnp.float32), (b, r, r))
        rhs = jnp.asarray(rng.standard_normal((b, r)), jnp.float32)
        med, lo, hi, comp = _time(jax.jit(jax.vmap(chol_solve)), m_b, rhs)
        emit(what="chol_solve", shape=[b, r, r], ms=med * 1e3,
             ms_min=lo * 1e3, ms_max=hi * 1e3, compile_s=comp)
        chol = jnp.linalg.cholesky(m_b)
        med, lo, hi, comp = _time(jax.jit(jax.vmap(tri_solve_lt)), chol, rhs)
        emit(what="tri_solve_lt", shape=[b, r, r], ms=med * 1e3,
             ms_min=lo * 1e3, ms_max=hi * 1e3, compile_s=comp)

    # the flagship step with each closest-point path
    def step_cell(label, build_index, kernel, precision="highest"):
        data_ctx = load_femur_data(100)
        _, mixture, ev = make_icp_proposal_setup(data_ctx, build_index=build_index)
        if kernel == "xla":
            surface_index.refine_shortlist = refine_shortlist_xla
            closest_point.nearest_face = lambda q, t: nearest_face_xla(
                jax.lax.stop_gradient(q), jax.lax.stop_gradient(t))
        jax.clear_caches()
        step = mh.make_mh_step(data_ctx.model, mixture, ev, store_params=False)
        mh.MATMUL_PRECISION = precision
        try:
            carry0 = jax.jit(lambda s: mh.init_carry(data_ctx.model, ev, s, mixture))(
                init_state(data_ctx.model))
            carries = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), carry0)
            keys = jax.random.split(jax.random.PRNGKey(1), b)
            run = jax.jit(jax.vmap(lambda c, k: mh.run_chain(step, c, k, args.steps)))
            t0 = time.perf_counter()
            compiled = run.lower(carries, keys).compile()
            comp = time.perf_counter() - t0
            mem = compiled.memory_analysis()
            carries, _ = compiled(carries, keys)  # warm
            jax.block_until_ready(carries)
            times = []
            for i in range(5):
                keys = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
                t0 = time.perf_counter()
                carries, rec = compiled(carries, keys)
                jax.block_until_ready(carries)
                times.append(time.perf_counter() - t0)
        finally:
            mh.MATMUL_PRECISION = "highest"
            surface_index.refine_shortlist = refine_default
            closest_point.nearest_face = nearest_face_default
        med = statistics.median(times)
        emit(what="flagship_step", path=label, precision=precision,
             chains=b, steps_per_segment=args.steps,
             ms_per_step=med / args.steps * 1e3,
             samples_per_s=b * args.steps / med,
             seg_s_min=min(times), seg_s_max=max(times), compile_s=comp,
             acceptance=float(jnp.mean(rec.accepted)),
             temp_bytes=int(mem.temp_size_in_bytes),
             argument_bytes=int(mem.argument_size_in_bytes),
             output_bytes=int(mem.output_size_in_bytes),
             generated_code_bytes=int(mem.generated_code_size_in_bytes))

    # the two index cells run in turns (xla, triton, ..., triton, xla): their
    # difference is small next to the dense ones
    for cell in (("index_xla", True, "xla"), ("index_triton", True, "triton"),
                 ("dense_triton", False, "triton"), ("dense_xla", False, "xla"),
                 ("index_triton", True, "triton", "default"),
                 ("index_triton", True, "triton"), ("index_xla", True, "xla")):
        with guard("flagship_step", cell[0]):
            step_cell(*cell)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
