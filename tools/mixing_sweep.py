"""Diagnose ICP-proposal mixing on the femur flagship (VERDICT r1 item 2).

Sweeps (parity, step_length, noise scales) on the femur GPMM ICP-proposal
mixture and reports, per configuration:

  * per-component and overall acceptance rates,
  * ESS/step of the log-posterior trace and of the first coefficients,
  * posterior-quality proxies (mean avg-distance of the final states, MAP).

Compares against the random-walk-only chain (the paper's headline claim is
that the informed proposal mixes *better* — reference
``NonRigidIcpProposal.scala:53-85`` with the configuration of
``IcpProposalRegistration.scala:59-87``).

Usage:
    python tools/mixing_sweep.py [--components 50] [--chains 64]
        [--steps 2000] [--out artifacts/mixing_sweep.json]
"""
from __future__ import annotations

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import json
import os
import sys
import time

import numpy as np


def _setup(data, parity, step_length, noise_normal, tangential, rw_sigma=0.1,
           icp_weight=0.9, mala_weight=0.0, mala_h=0.2, adapt=False):
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        gradient_shape_proposal,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask)
    groups = []
    if icp_weight > 0:
        groups.append((icp_weight, mixed_proposal_icp(
            n_points=2 * model.rank,
            projection_direction="model_and_target",
            tangential_noise=tangential,
            noise_along_normal=noise_normal,
            step_length=step_length,
        )))
    if mala_weight > 0:
        groups.append((mala_weight, gradient_shape_proposal((mala_h,))))
    rw_weight = 1.0 - icp_weight - mala_weight
    if rw_weight > 0:
        groups.append((rw_weight, mixed_random_shape_proposal((rw_sigma,))))
    weighted = nest(*groups) if len(groups) > 1 else groups[0][1]
    mixture = MixtureProgram(
        weighted, model, ctx, np.asarray(data.model_boundary_mask), parity=parity,
        adapt=AdaptConfig() if adapt else None,
    )
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=2.0, n_points=4 * model.rank
    )
    return ctx, mixture, evaluator


def run_config(data, label, n_chains, n_steps, **kw):
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.ops.closest_point import surface_distances
    from icp_proposal_tpu.sampling import mh
    from icp_proposal_tpu.sampling.diagnostics import ess
    from icp_proposal_tpu.sampling.state import init_state, transformed_points

    ctx, mixture, evaluator = _setup(data, **kw)
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)

    @jax.jit
    def make_carries(s):
        c0 = mh.init_carry(data.model, evaluator, s, mixture)
        return (
            jax.tree.map(lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), c0),
            jax.random.split(jax.random.PRNGKey(1024), n_chains),
        )

    carries, keys = make_carries(init_state(data.model))
    t0 = time.perf_counter()
    final, records = mh.run_chains(step, carries, keys, n_steps)
    acc = np.asarray(records.accepted)  # [C, T]
    dt = time.perf_counter() - t0

    pidx = np.asarray(records.proposal_idx)
    per_comp = {}
    for i, name in enumerate(mixture.names):
        sel = pidx == i
        per_comp[name] = {
            "selected_frac": float(sel.mean()),
            "acceptance": float(acc[sel].mean()) if sel.any() else None,
        }

    # chain-state traces for ESS — ChainRecord.coeffs stores the post-step
    # chain state directly (round 4), no reconstruction needed
    states = np.asarray(records.coeffs)  # [C, T, r]
    half = n_steps // 2
    post = states[:, half:, :]
    import jax.numpy as jnp2

    ess_c0 = float(ess(jnp2.asarray(post[:, :, 0]), max_lag=200))
    ess_mean = float(np.mean(np.asarray(
        ess(jnp2.asarray(post[:, :, :8]), max_lag=200)
    )))

    # posterior-quality proxy: surface error of final states
    @jax.jit
    def final_err(st):
        pts = jax.vmap(lambda s: transformed_points(data.model, s))(st)

        def one(p):
            d2, _ = surface_distances(p, jnp.asarray(ctx.tri))
            return jnp.mean(jnp.sqrt(d2))

        return jax.vmap(one)(pts)

    errs = np.asarray(final_err(final.state))
    out = {
        "label": label,
        "config": {k: (v if not callable(v) else str(v)) for k, v in kw.items()},
        "chains": n_chains,
        "steps": n_steps,
        "wall_s": round(dt, 2),
        "acceptance_overall": float(acc.mean()),
        "per_component": per_comp,
        "ess_per_step_coeff0": ess_c0 / (n_chains * (n_steps - half)),
        "ess_total_coeff0": ess_c0,
        "ess_mean_first8": ess_mean,
        "final_avg_dist_mm_mean": float(errs.mean()),
        "final_avg_dist_mm_best": float(errs.min()),
        "posterior_mean_c0_first4": np.asarray(post.mean(axis=(0, 1))[:4]).tolist(),
        "posterior_sd_first4": np.asarray(post.std(axis=(0, 1))[:4]).tolist(),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--components", type=int, default=50)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--out", default="artifacts/mixing_sweep.json")
    ap.add_argument("--quick", action="store_true", help="only 3 configs")
    args = ap.parse_args()

    from icp_proposal_tpu.apps.femur import load_femur_data

    data = load_femur_data(model_components=args.components)
    results = []

    def go(label, **kw):
        results.append(run_config(data, label, args.chains, args.steps, **kw))

    # random-walk reference point
    go("rw-only", parity=False, step_length=0.1, noise_normal=5.0,
       tangential=10.0, icp_weight=0.0)
    # reference flagship config, exact + parity densities
    go("flagship-exact-s0.1", parity=False, step_length=0.1,
       noise_normal=5.0, tangential=10.0)
    go("flagship-parity-s0.1", parity=True, step_length=0.1,
       noise_normal=5.0, tangential=10.0)
    if not args.quick:
        for s in (0.3, 0.5, 1.0):
            go(f"exact-s{s}", parity=False, step_length=s,
               noise_normal=5.0, tangential=10.0)
        # tighter proposal noise (posterior closer to likelihood scale σ=2)
        for nn, tg in ((2.0, 4.0), (1.0, 2.0)):
            go(f"exact-s0.5-n{nn}-t{tg}", parity=False, step_length=0.5,
               noise_normal=nn, tangential=tg)
        go("exact-s1.0-n2-t4", parity=False, step_length=1.0,
           noise_normal=2.0, tangential=4.0)
        # gradient-informed (beyond-reference): MALA-only and MALA+ICP hybrid,
        # step size self-tuned toward 0.574 acceptance
        go("mala-adapt", parity=False, step_length=0.1, noise_normal=5.0,
           tangential=10.0, icp_weight=0.0, mala_weight=1.0, mala_h=0.1,
           adapt=True)
        go("mala0.5+rw-adapt", parity=False, step_length=0.1, noise_normal=5.0,
           tangential=10.0, icp_weight=0.0, mala_weight=0.5, mala_h=0.1,
           adapt=True)
        go("icp0.5+mala0.4-adapt", parity=False, step_length=0.1,
           noise_normal=5.0, tangential=10.0, icp_weight=0.5, mala_weight=0.4,
           mala_h=0.1, adapt=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[mixing_sweep] wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
