"""Benchmark: samples/s/chip on the femur GPMM ICP-proposal chain.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
where value is the MEDIAN of ``BENCH_REPS`` (default 3) independently timed
segments and ``spread`` reports their min/max (VERDICT r2 bench-rigor item:
single-shot timings had unquantified run-to-run noise).

Baseline anchors: the reference publishes no numbers (SURVEY §6) and the
Scala toolchain cannot be built in this environment (sbt needs network), so
the anchors are **measured** single-core CPU ports of the reference hot loop
(``tools/reference_baseline_port.py`` — same per-step algorithm: full-mesh
decode, KD-tree+exact closest-point correspondences both directions, two
r×r GP-posterior assemblies, compensated-projection transition densities,
4·rank-point evaluator; BLAS pinned to one thread), one anchor PER MODEL
RANK (ADVICE r2: dividing a gpmm-50 run by the slower gpmm-100 anchor
overstated speedup):

    rank  50: 73.3  samples/s
    rank 100: 38.15 samples/s
    rank 200: 10.54 samples/s

Each anchor is the MAX over repeated quiet-machine measurements (history in
``artifacts/cpu_baselines.json``) — the generous-to-the-reference choice.
The ports are deliberately generous to the JVM reference already (vectorized
numpy + KD-tree vs boxed-object BVH), so ``vs_baseline`` is a LOWER bound on
the true speedup.  The north-star target (≥50×) is on the rank-100 row.
"""
import json
import statistics
import time

# measured per-rank single-core anchors (see module docstring)
CPU_SINGLE_CORE_BASELINES = {50: 73.3, 100: 38.15, 200: 10.54}


def main():
    import os
    import sys

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

    from icp_proposal_tpu.apps.femur import load_femur_data, make_icp_proposal_setup
    from icp_proposal_tpu.sampling import mh
    from icp_proposal_tpu.sampling.state import init_state

    verbose = os.environ.get("BENCH_VERBOSE", "1") == "1"

    def log(msg):
        if verbose:
            print(f"[bench] {msg}", file=sys.stderr, flush=True)

    print(f"[bench] card: {card}", file=sys.stderr, flush=True)
    log(f"devices: {devices}")

    n_chains = int(os.environ.get("BENCH_CHAINS", "2048"))
    n_steps = int(os.environ.get("BENCH_STEPS", "100"))
    n_components = int(os.environ.get("BENCH_COMPONENTS", "100"))
    n_reps = int(os.environ.get("BENCH_REPS", "3"))

    t = time.perf_counter()
    data = load_femur_data(model_components=n_components)
    log(f"load_femur_data took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    ctx, mixture, evaluator = make_icp_proposal_setup(data)
    # BENCH_FUSE=0 disables the fused target-surface query pass (A/B knob;
    # fused and unfused are numerically identical — test_fused_step_matches_unfused)
    fuse = os.environ.get("BENCH_FUSE", "1") == "1"
    step = mh.make_mh_step(
        data.model, mixture, evaluator, store_params=False, fuse=fuse
    )
    log(f"setup took {time.perf_counter() - t:.1f}s (fuse={fuse})")

    t = time.perf_counter()

    @jax.jit
    def make_carries(s):
        c0 = mh.init_carry(data.model, evaluator, s, mixture)
        carries = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), c0
        )
        return carries, jax.random.split(jax.random.PRNGKey(0), n_chains)

    carries, keys = make_carries(init_state(data.model))
    jax.block_until_ready(carries)
    log(f"init carries (jit) took {time.perf_counter() - t:.1f}s")

    run = jax.jit(
        lambda c, k: jax.vmap(lambda ci, ki: mh.run_chain(step, ci, ki, n_steps))(c, k)
    )

    def force(x):
        return float(jnp.sum(x.log_post))

    # compile + warmup (persistent cache makes warm starts fast)
    t = time.perf_counter()
    final, records = run(carries, keys)
    force(final)
    log(f"compile+first-run ({n_chains} chains x {n_steps} steps) took "
        f"{time.perf_counter() - t:.1f}s")

    # median-of-n timed segments, each continuing the chains with fresh keys
    rates = []
    for rep in range(n_reps):
        t0 = time.perf_counter()
        final, records = run(
            final, jax.vmap(lambda k: jax.random.fold_in(k, rep + 1))(keys)
        )
        force(final)
        dt = time.perf_counter() - t0
        rates.append(n_chains * n_steps / dt)
        log(f"segment {rep + 1}/{n_reps}: {rates[-1]:.1f} samples/s")

    value = statistics.median(rates)
    baseline = CPU_SINGLE_CORE_BASELINES.get(n_components)
    out = {
        "metric": f"samples_per_sec_per_chip_femur_gpmm{n_components}_icp_proposal",
        "value": round(value, 1),
        "unit": "samples/s/chip",
        # per-rank measured anchor; null when no anchor was measured for
        # this component count (never divide by a mismatched rank's anchor)
        "vs_baseline": round(value / baseline, 1) if baseline else None,
        "spread": {
            "reps": n_reps,
            "min": round(min(rates), 1),
            "max": round(max(rates), 1),
        },
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
