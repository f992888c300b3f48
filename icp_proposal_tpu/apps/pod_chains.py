"""Pod-scale sharded-chain run with pooled convergence diagnostics.

The BASELINE config[4] workload: many chains (e.g. 1024) sharded over all
devices of one or more hosts, with pooled R-hat/ESS/acceptance computed via
collectives.  On a single host this runs over however many GPUs are present;
``--cpu`` runs it on the host's CPU devices instead (e.g. a virtual mesh
from ``XLA_FLAGS=--xla_force_host_platform_device_count=8``).

    python -m icp_proposal_tpu.apps.pod_chains --chains 1024 --steps 1000
"""
from __future__ import annotations

import argparse
import json
import time


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--components", type=int, default=100)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--init-variance", type=float, default=0.1)
    p.add_argument("--setup", default="flagship",
                   help="proposal/evaluator recipe — any femur SETUPS key: "
                        "flagship = reference ICP mixture; hybrid = "
                        "exact-mode ICP+MALA+RW; rw / rw-adapt / mala = "
                        "fast-mixing exact samplers (convergence "
                        "demonstrations)")
    p.add_argument("--burn-frac", type=float, default=0.2,
                   help="fraction of steps discarded before diagnostics")
    p.add_argument("--diag-max-lag", type=int, default=100,
                   help="autocorrelation window for the pooled ESS; raise "
                        "for slow-mixing setups (τ beyond the window "
                        "truncates the Geyer sum and overestimates ESS)")
    p.add_argument("--segment-steps", type=int, default=100,
                   help="host-looped scan segment length (bounds the "
                        "runtime of one program)")
    p.add_argument("--host-diagnostics", action="store_true",
                   help="also gather the coefficient traces and recompute "
                        "R-hat/ESS on host (cross-check of the collective-"
                        "pooled values; costs the full records transfer)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the result JSON to this path")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU devices; without it a GPU is required")
    args = p.parse_args()

    from icp_proposal_tpu.parallel.distributed import raise_cpu_collective_timeouts
    from icp_proposal_tpu.utils.profiling import enable_compilation_cache, require_platform

    raise_cpu_collective_timeouts()  # no-op unless a CPU mesh; pre-backend
    enable_compilation_cache()
    require_platform("cpu" if args.cpu else "gpu")

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps.femur import SETUPS, load_femur_data
    from icp_proposal_tpu.apps.femur_experiments import initialise_shape_parameters  # noqa: F401
    from icp_proposal_tpu.parallel.distributed import initialize_distributed
    from icp_proposal_tpu.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu.sampling import diagnostics, mh
    from icp_proposal_tpu.sampling.state import init_state

    initialize_distributed()
    devices = jax.devices()
    n_dev = len(devices)
    chains = (args.chains // n_dev) * n_dev or n_dev
    print(f"devices={n_dev} chains={chains} steps={args.steps}")

    data = load_femur_data(args.components)
    ctx, mixture, evaluator = SETUPS[args.setup](data)
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)

    from icp_proposal_tpu.apps.femur_experiments import _batched_init_states

    key = jax.random.PRNGKey(args.seed)
    states = _batched_init_states(data.model, chains, key, args.init_variance)
    carries = jax.jit(
        jax.vmap(lambda s: mh.init_carry(data.model, evaluator, s, mixture))
    )(states)
    keys = jax.random.split(jax.random.fold_in(key, 7), chains)

    mesh = make_chain_mesh(devices)
    t0 = time.perf_counter()
    final, records, stats = run_sharded_chains(
        step, carries, keys, args.steps, mesh,
        burn_in=int(args.steps * args.burn_frac),
        segment_steps=args.segment_steps,
        diag_max_lag=args.diag_max_lag,
    )
    pooled_acc = float(stats.acceptance)
    rhat_max = float(jnp.max(stats.rhat))
    ess_c0 = float(stats.ess)
    dt = time.perf_counter() - t0

    out = {
        "devices": n_dev,
        "chains": chains,
        "steps": args.steps,
        "components": args.components,
        "setup": args.setup,
        # NOTE: this wall-clock includes per-segment host sync and the full
        # [chains, steps, rank] record streaming the diagnostics need — it is
        # a diagnostics-run rate, NOT the sampler's throughput ceiling
        # (bench.py measures that with store_params=False)
        "samples_per_sec": chains * args.steps / dt,
        "samples_per_sec_per_chip": chains * args.steps / dt / n_dev,
        "pooled_acceptance": pooled_acc,
        "coeff_mean_norm": float(jnp.linalg.norm(stats.coeff_mean)),
        # R-hat/ESS pooled INSIDE run_sharded_chains via psum moment sums —
        # the [chains, steps, rank] traces never leave their shard.  The
        # traces are the post-step chain STATE (held) series, so these are
        # true MCMC diagnostics (VERDICT r3 item 1).
        "rhat_max_first8": rhat_max,
        "ess_coeff0": ess_c0,
        "trace": "chain_state",
    }

    if args.host_diagnostics:
        # cross-check: gather the full traces and recompute on host formulas
        @jax.jit
        def diag(coeffs):
            tail = coeffs[:, int(args.steps * args.burn_frac):, :]
            return (
                jnp.max(diagnostics.split_rhat(tail[..., :8])),
                diagnostics.ess(tail[..., 0], max_lag=args.diag_max_lag),
            )

        h_rhat, h_ess = diag(records.coeffs)
        out["host_rhat_max_first8"] = float(h_rhat)
        out["host_ess_coeff0"] = float(h_ess)

    print(json.dumps(out))
    if args.out:
        import os

        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
