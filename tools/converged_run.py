import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702
"""Femur-workload convergence demonstration on the virtual 8-device mesh.

BASELINE.md's correctness north star needs committed evidence that the
sampler *converges on the real workload* — not just on the synthetic
icosphere of ``test_pooled_diagnostics_read_converged_at_convergence``.
Reference analog: the 100k-sample femur chain of
the reference's ``README.md:35`` (the replay artifact the reference ships).

Protocol (VERDICT r4 item 8):
  * 64 chains (8 per device on a virtual 8-device CPU mesh), femur GPMM,
    OVERDISPERSED inits — per-chain coefficient draws from the N(0, I)
    model prior, so split-R̂ starts far above 1 and genuinely has to fall.
  * The recommended exact-mode configuration (``--setup``; default is the
    recommended setup, ``apps.femur.RECOMMENDED_SETUP``).
  * Rounds of ``--round-steps`` steps through
    ``parallel.runner.run_sharded_chains`` — the SAME psum-collectives
    pooling path a real pod slice would use (8 devices ⇒ no single-device
    fast path; every published diagnostic below was computed by psum
    moment sums over the sharded hold-state traces).
  * After each round, the round-internal pooled split-R̂ (first 8 coeffs)
    is read.  Done when a round with at least one full discarded
    predecessor (burn-in) reads max split-R̂ < ``--rhat-target``.

Writes artifacts/converged_run_virtual8.json with the R̂ trajectory,
pooled hold-trace ESS, and posterior-mean coefficients (host cross-check
over all post-burn-in rounds included).

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/converged_run.py
"""
# virtual CPU mesh setup MUST precede the jax import
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from icp_proposal_tpu.parallel.distributed import raise_cpu_collective_timeouts  # noqa: E402

raise_cpu_collective_timeouts()

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--components", type=int, default=50)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--setup", default=None,
                    help="femur setup name (default: recommended_setup())")
    ap.add_argument("--round-steps", type=int, default=10000)
    ap.add_argument("--max-rounds", type=int, default=8)
    ap.add_argument("--segment-steps", type=int, default=1000)
    ap.add_argument("--rhat-target", type=float, default=1.1)
    ap.add_argument("--diag-max-lag", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1024)
    ap.add_argument("--out", default="artifacts/converged_run_virtual8.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps import femur as femur_app
    from icp_proposal_tpu.apps.femur_experiments import _batched_init_states
    from icp_proposal_tpu.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu.sampling import diagnostics, mh

    devices = jax.devices()
    assert len(devices) > 1, (
        "collectives-path demonstration needs a multi-device mesh; run with "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu"
    )
    setup_name = args.setup or femur_app.recommended_setup()
    setup_fn = femur_app.SETUPS[setup_name]

    data = femur_app.load_femur_data(args.components)
    ctx, mixture, evaluator = setup_fn(data)
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)

    chains = (args.chains // len(devices)) * len(devices) or len(devices)
    key = jax.random.PRNGKey(args.seed)
    # OVERDISPERSED inits: full prior variance (1.0), not the reference's
    # 0.1 comparison variance — R̂ must be forced to earn its convergence
    states = _batched_init_states(data.model, chains, key, variance=1.0)
    carries = jax.jit(
        jax.vmap(lambda s: mh.init_carry(data.model, evaluator, s, mixture))
    )(states)
    keys = jax.random.split(jax.random.fold_in(key, 7), chains)

    mesh = make_chain_mesh(devices)
    rounds = []
    post_parts = []  # host copies of post-burn-in hold-state traces
    carry = carries
    converged_round = None
    t_start = time.time()
    for r in range(args.max_rounds):
        t0 = time.time()
        rkeys = jax.vmap(lambda k: jax.random.fold_in(k, 1000 + r))(keys)
        carry, records, stats = run_sharded_chains(
            step, carry, rkeys, args.round_steps, mesh,
            burn_in=0, segment_steps=args.segment_steps,
            diag_max_lag=args.diag_max_lag,
        )
        rhat_max = float(jnp.max(stats.rhat))
        ess0 = float(stats.ess)
        acc = float(stats.acceptance)
        dt = time.time() - t0
        rounds.append({
            "round": r,
            "steps": args.round_steps,
            "collective_split_rhat_max_first8": rhat_max,
            "collective_ess_coeff0": ess0,
            "pooled_acceptance": acc,
            "wall_s": round(dt, 1),
        })
        print(f"[converged] round {r}: split-R^ {rhat_max:.4f} "
              f"ESS0 {ess0:.0f} acc {acc:.3f} ({dt:.0f}s)", flush=True)
        if r >= 1:
            post_parts.append(np.asarray(records.coeffs))
        if r >= 1 and rhat_max < args.rhat_target:
            converged_round = r
            break

    out = {
        "devices": len(devices),
        "mesh": "virtual CPU x8 (collectives path; no single-device "
                "fast path possible)",
        "chains": chains,
        "components": args.components,
        "setup": setup_name,
        "init": "overdispersed (per-chain prior draws, variance 1.0)",
        "round_steps": args.round_steps,
        "rhat_target": args.rhat_target,
        "rounds": rounds,
        "converged": converged_round is not None,
        "converged_at_round": converged_round,
        "total_steps_run": args.round_steps * len(rounds),
        "burn_in_discarded_steps": args.round_steps,  # round 0 discarded
        "trace": "chain_state",
        "diagnostics_via": "collectives",
        "total_wall_s": round(time.time() - t_start, 1),
    }
    if post_parts:
        # host cross-check over ALL post-burn-in rounds pooled (round 0
        # discarded as burn-in) — same formulas, host implementation
        post = np.concatenate(post_parts, axis=1)  # [C, T, r]
        t = jnp.asarray(post[:, :, :8])
        out["host_split_rhat_max_first8_postburn"] = float(
            jnp.max(diagnostics.split_rhat(t))
        )
        ess8 = np.asarray(
            diagnostics.ess(t, max_lag=args.diag_max_lag)
        )
        out["host_ess_first8_postburn"] = ess8.tolist()
        out["host_ess_first8_mean"] = float(ess8.mean())
        flat = post.reshape(-1, post.shape[-1])
        out["posterior_mean_coeffs_first8"] = flat.mean(axis=0)[:8].tolist()
        out["posterior_mean_coeffs_norm"] = float(
            np.linalg.norm(flat.mean(axis=0))
        )
        out["posterior_sd_mean"] = float(flat.std(axis=0).mean())

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "converged", "converged_at_round", "total_steps_run", "chains",
        "setup", "diagnostics_via")}))


if __name__ == "__main__":
    main()
