#!/usr/bin/env python3
"""Smoke test of the femur MH sampler on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

One process.  On one GPU it builds the seeded femur GPMM-100 workload and
the flagship setup, compiles the vmapped step at 2,048 chains, runs a few
20-step segments, compares each closest-point path and the r×r solves with
their plain references at real widths, compares the log-posterior and the
ICP posterior factors on the GPU with the CPU backend, and runs every
sampler setup for a few steps.  With ``--four-cards`` it runs 1,024 chains ×
100 steps sharded over four GPUs and compares them with the same chains run
unsharded on one GPU.  Any check outside its limit ends the run with an
error.  The last line of standard output is one JSON object naming the
device; it is printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

CHAINS = 2048
SEGMENT_STEPS = 20
SHARDED_CHAINS, SHARDED_STEPS = 1024, 100  # BASELINE.json config 4


def log(msg):
    print(msg, flush=True)


def check(name, worst, limit):
    """Print a comparison's worst value beside its limit; fail outside it."""
    ok = bool(worst <= limit)
    log(f"[check] {name}: worst {worst:.3e}, limit {limit:.1e} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {worst} > {limit}")


def same_winner(tri, queries, fa, fb):
    """Face ids agree except at exact-distance ties: → (fraction of equal
    ids, worst relative float64 distance gap between the two faces)."""
    from icp_proposal_tpu.ops.surface_index import _np_point_tri_dist2

    fa, fb = np.asarray(fa).ravel(), np.asarray(fb).ravel()
    diff = np.nonzero(fa != fb)[0]
    if diff.size == 0:
        return 1.0, 0.0
    q = np.asarray(queries, np.float64).reshape(-1, 3)[diff]
    t = np.asarray(tri, np.float64)
    da, db = (np.array([_np_point_tri_dist2(q[i:i + 1], t[[f[d]]])[0, 0]
                        for i, d in enumerate(diff)]) for f in (fa, fb))
    gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-12)
    return 1.0 - diff.size / fa.size, float(gap.max())


def timed_segments(label, compiled, carries, keys, card, n=3):
    import jax

    for i in range(n):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, i + 1))(keys)
        t0 = time.perf_counter()
        carries, rec = compiled(carries, keys)
        jax.block_until_ready(carries)
        dt = time.perf_counter() - t0
        log(f"[time] {label} segment {i + 1}: {dt:.4f} s for "
            f"{SEGMENT_STEPS} steps x {CHAINS} chains "
            f"({CHAINS * SEGMENT_STEPS / dt:.1f} samples/s) on {card}")
    return carries, rec


def one_card(card, devices):
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps.femur import SETUPS, load_femur_data, make_icp_proposal_setup
    from icp_proposal_tpu.apps.femur_experiments import _batched_init_states
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm
    from icp_proposal_tpu.ops.closest_point import (
        closest_points_on_surface,
        nearest_face_xla,
        nearest_vertices,
        surface_distances,
    )
    from icp_proposal_tpu.ops.closest_point_triton import (
        nearest_face_triton,
        refine_shortlist_triton,
    )
    from icp_proposal_tpu.ops.linalg import chol_solve
    from icp_proposal_tpu.ops.surface_index import (
        _np_point_tri_dist2,
        index_closest,
        refine_shortlist_xla,
    )
    from icp_proposal_tpu.sampling import mh
    from icp_proposal_tpu.sampling.evaluators import HausdorffSpec, build_evaluator
    from icp_proposal_tpu.sampling.proposals import MixtureProgram, mixed_random_shape_proposal
    from icp_proposal_tpu.sampling.state import init_state
    from tools.validate_index import (
        chunked,
        error_stats,
        near_surface_queries,
        regime_queries,
    )

    # -- phase 2: the seeded workload and the flagship setup ----------------
    t0 = time.perf_counter()
    data = load_femur_data(model_components=100)
    model = data.model
    ctx, mixture, evaluator = make_icp_proposal_setup(data)
    step = mh.make_mh_step(model, mixture, evaluator, store_params=False)
    log(f"[phase 2] femur GPMM-100 (rank {model.rank}, {model.num_points} "
        f"vertices, {int(np.asarray(ctx.tri).shape[0])} faces), closest-point "
        f"path: shortlist index, K={ctx.index.k}; built in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- phase 3: compile the vmapped flagship step, run segments -----------
    carry0 = jax.jit(lambda s: mh.init_carry(model, evaluator, s, mixture))(
        init_state(model))
    carries = jax.tree.map(lambda x: jnp.broadcast_to(x, (CHAINS,) + x.shape), carry0)
    keys = jax.random.split(jax.random.PRNGKey(0), CHAINS)
    run = jax.jit(jax.vmap(lambda c, k: mh.run_chain(step, c, k, SEGMENT_STEPS)))
    t0 = time.perf_counter()
    compiled = run.lower(carries, keys).compile()
    log(f"[phase 3] compiled the flagship step ({CHAINS} chains x "
        f"{SEGMENT_STEPS}-step scan) in {time.perf_counter() - t0:.1f} s on {card}")
    log(f"[phase 3] memory_analysis: {compiled.memory_analysis()}")
    carries, rec = timed_segments("flagship", compiled, carries, keys, card)
    lp = np.asarray(carries.log_post)
    acc = float(np.mean(np.asarray(rec.accepted)))
    check("flagship non-finite log-posteriors", float(np.sum(~np.isfinite(lp))), 0)
    check("flagship acceptance outside (0, 1)", float(not 0.0 < acc < 1.0), 0)
    log(f"[phase 3] acceptance {acc:.4f}, mean log-posterior {lp.mean():.2f}")

    # -- phase 4: each closest-point path and solve against its reference --
    tri = np.asarray(ctx.tri)
    index = ctx.index
    rng = np.random.default_rng(0)
    dense = jax.jit(jax.vmap(lambda q: closest_points_on_surface(q, jnp.asarray(tri))))
    fast = jax.jit(jax.vmap(lambda q: index_closest(index, q)))

    near = near_surface_queries(data, 11, sigma_mm=2.0, n_copies=1)
    near = near[rng.integers(0, len(near), (CHAINS, 400))]  # [B, P, 3]
    _, d2_d, f_d = dense(near)
    _, d2_i, f_i = fast(near)
    err = np.abs(np.sqrt(np.asarray(d2_i)) - np.sqrt(np.asarray(d2_d)))
    check("index vs dense, near queries: |d| error (mm)", float(err.max()), 1e-4)
    frac, gap = same_winner(tri, near, f_i, f_d)
    log(f"[phase 4] index vs dense, near queries: {frac:.6f} of face ids equal")
    check("index vs dense, near queries: f64 distance gap where ids differ",
          gap, 1e-6)

    # the documented error model (surface_index.validate_index, measured
    # by tools/validate_index.py on these query sets): near-surface queries
    # are exact; far ones miss the true face on at most 0.14 % of queries,
    # by at most 1.5 mm / 14 %, and 99.9 % are within 0.08 mm.  The limits
    # carry margin for the other machine's rounding, which moves near-tied
    # nearest vertices and so which far queries miss.
    queries = regime_queries(data)
    d_fast = jax.jit(lambda q: jnp.sqrt(index_closest(index, q)[1]))
    d_dense = jax.jit(lambda q: jnp.sqrt(closest_points_on_surface(q, jnp.asarray(tri))[1]))
    for regime, q in queries.items():
        stats = error_stats(chunked(d_fast, q), chunked(d_dense, q))
        log(f"[phase 4] index vs dense, {regime} ({len(q)} queries): {stats}")
        if regime == "near-2mm":
            check(f"index vs dense, {regime}: |d| error (mm)",
                  stats["max_abs_err_mm"], 1e-4)
            continue
        for key, limit in (("frac_mismatched", 0.005), ("p999_abs_err_mm", 0.2),
                           ("max_rel_err", 0.2), ("max_abs_err_mm", 2.0)):
            check(f"index vs dense, {regime}: {key}", stats[key], limit)
    far = queries["random-init"]

    mixed = np.concatenate([near.reshape(-1, 3)[:2048], far[:2048]])
    d2_g, _ = surface_distances(mixed, jnp.asarray(tri))
    d2_g = np.asarray(d2_g, np.float64)
    d2_np = _np_point_tri_dist2(mixed.astype(np.float64), tri.astype(np.float64)).min(axis=1)
    # float32 coordinates of up to ~230 mm carry ~1.5e-5 mm of rounding, so a
    # relative d^2 limit of 1e-5 holds from ~5 mm out; nearer, |d| is held
    # to 1e-4 mm
    far_rows = d2_np >= 25.0
    check("dense jnp vs float64 numpy: relative d^2 error (d >= 5 mm)",
          float((np.abs(d2_g - d2_np) / d2_np)[far_rows].max()), 1e-5)
    check("dense jnp vs float64 numpy: |d| error (mm)",
          float(np.abs(np.sqrt(d2_g) - np.sqrt(d2_np)).max()), 1e-4)

    prior = jax.jit(lambda c: jnp.einsum(
        "vir,br->bvi", jnp.asarray(model.sbasis)[jnp.asarray(evaluator.model_ids("distance"))],
        c, precision="highest") + jnp.asarray(model.ref_points)[
            jnp.asarray(evaluator.model_ids("distance"))])(
        jax.random.normal(jax.random.PRNGKey(4), (CHAINS, model.rank)))
    pts = jnp.asarray(index.points)
    nv = jax.jit(jax.vmap(lambda q: nearest_vertices(q, pts)))(prior)
    f_x = jax.jit(jax.vmap(lambda q, n: refine_shortlist_xla(index, q, n)))(prior, nv)
    f_t = jax.jit(jax.vmap(lambda q, n: refine_shortlist_triton(
        q, n, index.cand_tri, index.cand)))(prior, nv)
    frac, gap = same_winner(tri, prior, f_t, f_x)
    log(f"[phase 4] Triton vs XLA refine: {frac:.6f} of face ids equal")
    check("Triton vs XLA refine: f64 distance gap where ids differ", gap, 1e-6)
    sub = prior[:256]  # the XLA reference materialises [B, P, F]
    f_x = jax.jit(jax.vmap(lambda q: nearest_face_xla(q, jnp.asarray(tri))))(sub)
    f_t = jax.jit(jax.vmap(lambda q: nearest_face_triton(q, jnp.asarray(tri))))(sub)
    frac, gap = same_winner(tri, sub, f_t, f_x)
    log(f"[phase 4] Triton vs XLA nearest face: {frac:.6f} of face ids equal")
    check("Triton vs XLA nearest face: f64 distance gap where ids differ", gap, 1e-6)

    for comps in (100, 200):
        m_model = model if comps == 100 else build_femur_gpmm(
            np.asarray(model.ref_points), np.asarray(model.cells), comps)
        r = m_model.rank
        sb = np.asarray(m_model.sbasis, np.float64)
        ms, rhss = [], []
        for _ in range(64):  # M = I + QᵀΣ⁻¹Q at 200 ICP points, σ = 2..5 mm
            q = sb[rng.choice(model.num_points, 200, replace=False)].reshape(-1, r)
            ms.append(np.eye(r) + q.T @ q / rng.uniform(4.0, 25.0))
            rhss.append(rng.standard_normal(r) * 10.0)
        ms, rhss = np.stack(ms), np.stack(rhss)
        _, x, ld = jax.jit(jax.vmap(chol_solve))(
            jnp.asarray(ms, jnp.float32), jnp.asarray(rhss, jnp.float32))
        ld_ref = np.linalg.slogdet(ms)[1]
        x_ref = np.linalg.solve(ms, rhss[..., None])[..., 0]
        check(f"chol_solve r={r}: relative log det error",
              float(np.max(np.abs(np.asarray(ld) - ld_ref) / np.abs(ld_ref))), 1e-4)
        check(f"chol_solve r={r}: relative solution error",
              float(np.max(np.linalg.norm(np.asarray(x) - x_ref, axis=1)
                           / np.linalg.norm(x_ref, axis=1))), 1e-3)

    # -- phase 5: log-posterior and ICP factors, GPU vs CPU -----------------
    states = _batched_init_states(model, 64, jax.random.PRNGKey(5), variance=0.1)

    def terms(device):
        st = jax.device_put(states, device)
        c = jax.jit(jax.vmap(lambda s: mh.init_carry(model, evaluator, s, mixture)))(st)
        return (np.asarray(c.log_post),
                [np.asarray(f.alpha_hat) for f in c.icp_factors],
                [np.asarray(f.logdet_m) for f in c.icp_factors])

    cpu = terms(jax.devices("cpu")[0])
    limits = {"log-posterior |diff| (nats)": 1e-2,
              "alpha_hat |diff| / (1 + max|alpha_hat|)": 1e-3,
              "log det M relative diff": 1e-4}

    def worst(gpu):
        return {
            "log-posterior |diff| (nats)": float(np.abs(gpu[0] - cpu[0]).max()),
            "alpha_hat |diff| / (1 + max|alpha_hat|)": max(
                float(np.abs(a - b).max() / (1 + np.abs(b).max()))
                for a, b in zip(gpu[1], cpu[1])),
            "log det M relative diff": max(
                float(np.max(np.abs(a - b) / np.abs(b))) for a, b in zip(gpu[2], cpu[2])),
        }

    log(f"[phase 5] 64 states, log-posterior range "
        f"[{cpu[0].min():.1f}, {cpu[0].max():.1f}] nats on the CPU")
    for name, w in worst(terms(devices[0])).items():
        check(f"GPU vs CPU, precision highest: {name}", w, limits[name])
    mh.MATMUL_PRECISION = "default"
    try:
        for name, w in worst(terms(devices[0])).items():
            log(f"[phase 5] default (TF32) precision would give: {name} worst "
                f"{w:.3e}, limit {limits[name]:.1e} -> "
                f"{'would pass' if w <= limits[name] else 'would fail'}")
    finally:
        mh.MATMUL_PRECISION = "highest"

    # -- phase 6: every setup, and one step of the dense Hausdorff evaluator
    haus_ev = build_evaluator(model, ctx, [HausdorffSpec(rate=1.0)])
    runs = {name: (build(data), 256, 5) for name, build in SETUPS.items()}
    runs["hausdorff"] = ((ctx, MixtureProgram(
        mixed_random_shape_proposal(), model, ctx,
        np.asarray(data.model_boundary_mask)), haus_ev), 32, 1)
    for name, ((_, mix, ev), n, n_steps) in runs.items():
        t0 = time.perf_counter()
        init = _batched_init_states(model, n, jax.random.PRNGKey(6), variance=0.1)
        stp = mh.make_mh_step(model, mix, ev, store_params=False)
        c = jax.jit(jax.vmap(lambda s: mh.init_carry(model, ev, s, mix)))(init)
        final, rec = mh.run_chains(stp, c, jax.random.split(jax.random.PRNGKey(8), n),
                                   n_steps)
        lp = np.asarray(final.log_post)
        acc = float(np.mean(np.asarray(rec.accepted)))
        log(f"[phase 6] setup {name}: {n} chains x {n_steps} steps in "
            f"{time.perf_counter() - t0:.1f} s (compile included), "
            f"acceptance {acc:.3f}")
        check(f"setup {name}: non-finite log-posteriors", float(np.sum(~np.isfinite(lp))), 0)


def four_cards(card, devices):
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps.femur import load_femur_data, make_icp_proposal_setup
    from icp_proposal_tpu.apps.femur_experiments import _batched_init_states
    from icp_proposal_tpu.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu.sampling import diagnostics, mh

    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX has {devices}")
    devices = devices[:4]
    data = load_femur_data(model_components=100)
    model = data.model
    _, mixture, evaluator = make_icp_proposal_setup(data)
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    n_chains, n_steps = SHARDED_CHAINS, SHARDED_STEPS
    burn = n_steps // 5
    key = jax.random.PRNGKey(1024)
    states = _batched_init_states(model, n_chains, key, variance=0.1)
    carries = jax.jit(jax.vmap(lambda s: mh.init_carry(model, evaluator, s, mixture)))(states)
    keys = jax.random.split(jax.random.fold_in(key, 7), n_chains)

    t0 = time.perf_counter()
    final_s, rec_s, stats = run_sharded_chains(
        step, carries, keys, n_steps, make_chain_mesh(devices), burn_in=burn)
    jax.block_until_ready(final_s)
    log(f"[four] sharded: {n_chains} chains x {n_steps} steps over "
        f"{len(devices)} GPUs in {time.perf_counter() - t0:.1f} s "
        f"(compile included) on {card}")
    t0 = time.perf_counter()
    final_u, rec_u = mh.run_chains(step, carries, keys, n_steps)
    jax.block_until_ready(final_u)
    log(f"[four] unsharded: same chains on {devices[0]} in "
        f"{time.perf_counter() - t0:.1f} s (compile included)")

    acc_s, acc_u = np.asarray(rec_s.accepted), np.asarray(rec_u.accepted)
    same = np.all(acc_s == acc_u, axis=1)
    log(f"[four] chains with identical accept sequences: {int(same.sum())} of {n_chains}")
    check("fraction of chains whose accept sequence differs", float(1 - same.mean()), 0.01)
    cs, cu = np.asarray(final_s.state.coeffs), np.asarray(final_u.state.coeffs)
    check("per-chain final coefficients |diff| (chains with identical accepts)",
          float(np.abs(cs[same] - cu[same]).max()), 1e-3)
    tail = jnp.asarray(np.asarray(rec_u.coeffs))[:, burn:, :8]
    host = {
        "pooled acceptance": float(acc_u[:, burn:].mean()),
        "pooled coefficient mean": cu.mean(axis=0),
        "split R-hat (first 8)": np.asarray(diagnostics.split_rhat(tail)),
        "ESS (coefficient 0)": float(diagnostics.ess(tail[..., 0])),
    }
    pooled = {
        "pooled acceptance": float(stats.acceptance),
        "pooled coefficient mean": np.asarray(stats.coeff_mean),
        "split R-hat (first 8)": np.asarray(stats.rhat),
        "ESS (coefficient 0)": float(stats.ess),
    }
    for name in host:
        h, p = np.asarray(host[name]), np.asarray(pooled[name])
        log(f"[four] {name} (first 8): sharded {np.round(np.atleast_1d(p)[:8], 5).tolist()} "
            f"unsharded {np.round(np.atleast_1d(h)[:8], 5).tolist()}")
        check(f"sharded vs unsharded {name}: relative diff",
              float(np.max(np.abs(p - h) / np.maximum(np.abs(h), 1e-2))), 1e-2)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four GPUs")
    args = ap.parse_args()

    import jax

    # the GPU, plus the CPU backend that phase 5 compares against; fails at
    # the first device query when there is no GPU
    jax.config.update("jax_platforms", "cuda,cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU found; JAX has {devices}")

    from icp_proposal_tpu.utils.profiling import (
        enable_compilation_cache,
        gpu_name_and_power_limit,
    )

    enable_compilation_cache()
    card = gpu_name_and_power_limit()
    log(f"[phase 1] JAX devices: {devices}")
    log(card)
    card = card.splitlines()[0]
    if args.four_cards:
        four_cards(card, devices)
    else:
        one_card(card, devices)
    n = 4 if args.four_cards else len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": n}}))


if __name__ == "__main__":
    main()
