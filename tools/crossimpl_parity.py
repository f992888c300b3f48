"""Cross-implementation posterior parity: numpy port vs JAX framework.

VERDICT r2 item 2: every prior parity artifact compared JAX samplers against
JAX samplers — a bug shared by the JAX correspondence kernels or factor
assembly would be invisible.  This tool runs the single-core numpy port of
the reference hot loop (``tools/reference_baseline_port.PortSampler`` —
scipy cKDTree + numpy; zero shared code with the JAX path) as a long-chain
*sampler* and compares its posterior coefficient moments against the
framework's parity-mode flagship chain, both targeting the IDENTICAL parity
density (same seeded point subsets, noise frames, mixture weights,
evaluator; reference semantics of ``NonRigidIcpProposal.scala:53-85`` +
``SamplingRegistration.scala:37-94``).

Decision rule: for each of the first N coefficients, z = (m̂_port − m̂_jax) /
sqrt(SE²_port + SE²_jax) with SEs from between-chain variation (chains are
independent).  max |z| < 3 ⇒ within Monte-Carlo error.

    python tools/crossimpl_parity.py --components 50 --steps 20000 \
        --port-chains 6 --jax-chains 64 --out artifacts/posterior_parity_crossimpl.json
"""
from __future__ import annotations

import os
import sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E402,E702

import argparse
import json
import time


def _run_port_chain(args):
    """Worker: one port chain → (chain-mean [r], chain-var [r], acceptance)."""
    components, steps, burn, thin, seed = args
    import numpy as np

    from tools.reference_baseline_port import femur_port_sampler

    sampler = femur_port_sampler(components)
    sampler.target_q.k = min(32, len(sampler.tcells))  # tighter exactness
    trace, acc, _ = sampler.run(
        steps, seed=seed, record_from=burn, record_every=thin
    )
    return trace.mean(axis=0), trace.var(axis=0, ddof=1), acc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--components", type=int, default=50)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--burn", type=int, default=2000)
    ap.add_argument("--thin", type=int, default=10)
    ap.add_argument("--port-chains", type=int, default=6)
    ap.add_argument("--jax-chains", type=int, default=64)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--n-check", type=int, default=10,
                    help="leading coefficients compared by z-score")
    ap.add_argument("--out", default="artifacts/posterior_parity_crossimpl.json")
    ap.add_argument("--port-cache", default="artifacts/crossimpl_port_moments.npz",
                    help="cache of the (expensive) port-chain moments; reused "
                         "when config matches so a JAX-side failure doesn't "
                         "re-pay ~20 min of single-core sampling")
    ap.add_argument("--port-only", action="store_true",
                    help="run only the CPU port phase and write the cache")
    args = ap.parse_args()

    import numpy as np

    # ---------------- CPU port side (multiprocessing, cached) --------------
    # Per-CHAIN cache keyed by (components, steps, burn, thin) + seed, so
    # raising --port-chains ACCUMULATES: already-sampled chains are reused
    # and only the missing seeds run (VERDICT r3 item 5: 6 chains was a
    # small sample; overnight accumulation to 12-16 must not re-pay the
    # first 6).  Backward compatible with the round-3 whole-run cache
    # format (cfg [5] without per-chain seeds: seeds were 1000..1000+K-1).
    cfg4 = np.asarray([args.components, args.steps, args.burn, args.thin])
    seeds_wanted = [1000 + i for i in range(args.port_chains)]
    cached_chains = {}  # seed -> (mean [r], var [r], acc)
    if args.port_cache and os.path.exists(args.port_cache):
        z = np.load(args.port_cache)
        if "cfg4" in z and np.array_equal(z["cfg4"], cfg4):
            for j, s in enumerate(z["seeds"].tolist()):
                cached_chains[int(s)] = (z["means"][j], z["vars"][j],
                                         float(z["accs"][j]))
        elif "cfg" in z and np.array_equal(z["cfg"][:4], cfg4):
            k_old = int(z["cfg"][4])
            for j in range(k_old):
                # old format stored only the pooled acceptance scalar — flag
                # per-chain acceptance as NaN so migrated entries are
                # excluded from the reported mean (ADVICE r4: mixing the
                # pooled scalar with per-chain values biased the blend)
                cached_chains[1000 + j] = (z["means"][j], z["vars"][j],
                                           float("nan"))
        if cached_chains:
            print(f"[port] reusing {len(cached_chains)} cached chains "
                  f"from {args.port_cache}")
    missing = [s for s in seeds_wanted if s not in cached_chains]
    t0 = time.perf_counter()
    if missing:
        from multiprocessing import Pool

        work = [(args.components, args.steps, args.burn, args.thin, s)
                for s in missing]
        with Pool(args.procs) as pool:
            for s, r in zip(missing, pool.map(_run_port_chain, work)):
                cached_chains[s] = (r[0], r[1], float(r[2]))
    port_wall = time.perf_counter() - t0
    port_means = np.stack([cached_chains[s][0] for s in seeds_wanted])
    port_vars = np.stack([cached_chains[s][1] for s in seeds_wanted])
    # nanmean: entries migrated from the old cache format carry NaN acceptance
    port_acc = float(np.nanmean([cached_chains[s][2] for s in seeds_wanted]))
    if args.port_cache:
        os.makedirs(os.path.dirname(args.port_cache), exist_ok=True)
        all_seeds = sorted(cached_chains)
        np.savez(
            args.port_cache, cfg4=cfg4,
            seeds=np.asarray(all_seeds),
            means=np.stack([cached_chains[s][0] for s in all_seeds]),
            vars=np.stack([cached_chains[s][1] for s in all_seeds]),
            accs=np.asarray([cached_chains[s][2] for s in all_seeds]),
        )
    print(f"[port] {args.port_chains} chains x {args.steps} steps "
          f"({len(missing)} newly sampled, {port_wall:.0f}s), "
          f"acceptance {port_acc:.3f}")
    if args.port_only:
        return

    # ---------------- JAX framework side (parity mode) ---------------------
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps.femur import load_femur_data, make_icp_proposal_setup
    from icp_proposal_tpu.sampling import mh
    from icp_proposal_tpu.sampling.state import init_state
    from icp_proposal_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.perf_counter()
    data = load_femur_data(model_components=args.components)
    # the JAX side uses the exact dense query (the K-NN shortlist is
    # near-surface-exact only; the port is exact)
    ctx, mixture, evaluator = make_icp_proposal_setup(
        data, parity=True, build_index=False)

    # hard check: the port targets the IDENTICAL density — same point subsets
    from tools.reference_baseline_port import femur_port_sampler

    probe = femur_port_sampler(args.components, data=data)
    icp_comps = [mixture.icp_components[i] for i in sorted(mixture.icp_components)]
    fw_model_ids = {frozenset(np.asarray(c.model_ids).tolist()) for c in icp_comps}
    fw_target_ids = {frozenset(np.asarray(c.target_ids).tolist()) for c in icp_comps}
    assert frozenset(probe.icp_ids.tolist()) in fw_model_ids, "ICP model ids differ"
    assert frozenset(probe.tgt_ids.tolist()) in fw_target_ids, "ICP target ids differ"
    ev_ids = evaluator.model_ids("distance")
    assert frozenset(probe.eval_ids.tolist()) == frozenset(
        np.asarray(ev_ids).tolist()
    ), "evaluator ids differ"
    del probe
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)
    n_chains = args.jax_chains
    carry0 = jax.jit(
        lambda s: mh.init_carry(data.model, evaluator, s, mixture)
    )(init_state(data.model))
    carries = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), carry0
    )
    keys = jax.random.split(jax.random.PRNGKey(99), n_chains)
    # segmented host loop: bounds the size of one program; identical math
    # in segments (run_chains caches the jitted segment, so one compile)
    seg = 1000
    carry = carries
    cand_parts, acc_parts = [], []
    done = 0
    s_idx = 0
    while done < args.steps:
        n = min(seg, args.steps - done)
        seg_keys = jax.vmap(lambda k: jax.random.fold_in(k, s_idx))(keys)
        carry, records = mh.run_chains(step, carry, seg_keys, n)
        cand_parts.append(np.asarray(records.coeffs))
        acc_parts.append(np.asarray(records.accepted))
        done += n
        s_idx += 1
    # ChainRecord.coeffs stores the post-step chain STATE directly (round 4)
    states = np.concatenate(cand_parts, axis=1)  # [C, T, r] held states
    acc = np.concatenate(acc_parts, axis=1)  # [C, T]
    jax_means, jax_vars = [], []
    for c in range(n_chains):
        tr = states[c][args.burn::args.thin]
        jax_means.append(tr.mean(axis=0))
        jax_vars.append(tr.var(axis=0, ddof=1))
    jax_means = np.stack(jax_means)
    jax_vars = np.stack(jax_vars)
    jax_acc = float(acc.mean())
    jax_wall = time.perf_counter() - t0
    print(f"[jax:{jax.default_backend()}] {n_chains} chains x {args.steps} "
          f"steps in {jax_wall:.0f}s, acceptance {jax_acc:.3f}")

    # ---------------- comparison -------------------------------------------
    n = args.n_check
    m_port = port_means.mean(axis=0)
    m_jax = jax_means.mean(axis=0)
    se_port = port_means.std(axis=0, ddof=1) / np.sqrt(len(port_means))
    se_jax = jax_means.std(axis=0, ddof=1) / np.sqrt(len(jax_means))
    z = (m_port - m_jax) / np.sqrt(se_port**2 + se_jax**2 + 1e-30)
    sd_ratio = np.sqrt(port_vars.mean(axis=0) / np.maximum(jax_vars.mean(axis=0), 1e-30))

    # Welch t-test: with only a handful of port chains the normal-z reading
    # of the statistic is anticonservative (the between-chain variance is
    # itself noisy, df ≈ port_chains − 1); Welch-Satterthwaite df + t
    # p-values are the honest criterion
    from scipy import stats as sstats

    v1, n1 = se_port**2, len(port_means)
    v2, n2 = se_jax**2, len(jax_means)
    df = (v1 + v2) ** 2 / (v1**2 / (n1 - 1) + v2**2 / (n2 - 1) + 1e-300)
    p = 2.0 * sstats.t.sf(np.abs(z), df)
    # discrepancy in units the posterior itself defines
    post_sd = np.sqrt(port_vars.mean(axis=0))
    delta_in_sd = np.abs(m_port - m_jax) / np.maximum(post_sd, 1e-30)

    out = {
        "config": {
            "components": args.components, "steps": args.steps,
            "burn": args.burn, "thin": args.thin,
            "port_chains": args.port_chains, "jax_chains": args.jax_chains,
            "jax_backend": jax.default_backend(),
            "closest_point": "dense",
            "density": "parity (reference semantics)",
        },
        "port": {
            "acceptance": port_acc,
            "mean_first": m_port[:n].tolist(),
            "se_first": se_port[:n].tolist(),
            "wall_s": round(port_wall, 1),
        },
        "jax": {
            "acceptance": jax_acc,
            "mean_first": m_jax[:n].tolist(),
            "se_first": se_jax[:n].tolist(),
            "wall_s": round(jax_wall, 1),
        },
        "z_first": z[:n].tolist(),
        "max_abs_z_first": float(np.max(np.abs(z[:n]))),
        "max_abs_z_all": float(np.max(np.abs(z))),
        "welch_df_first": df[:n].tolist(),
        "welch_p_first": p[:n].tolist(),
        "min_welch_p_first": float(np.min(p[:n])),
        # Bonferroni over the n compared coefficients
        "pass_welch_bonferroni_0p01": bool(np.min(p[:n]) * n > 0.01),
        "delta_in_posterior_sd_first": delta_in_sd[:n].tolist(),
        "max_delta_in_posterior_sd_first": float(np.max(delta_in_sd[:n])),
        "sd_ratio_first": sd_ratio[:n].tolist(),
        "pass_3sigma_first": bool(np.max(np.abs(z[:n])) < 3.0),
    }
    print(json.dumps({k: out[k] for k in
                      ("max_abs_z_first", "max_abs_z_all", "pass_3sigma_first",
                       "min_welch_p_first", "pass_welch_bonferroni_0p01",
                       "max_delta_in_posterior_sd_first")}))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
