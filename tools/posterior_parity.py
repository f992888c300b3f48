"""Posterior-parity evidence at femur scale (VERDICT r1 items 2+9).

Long-run comparison of three samplers on the femur flagship target:

  * ``rw-only``      — random-walk shape proposal only.  Symmetric, hence an
                       *exact* MH sampler: its long-run moments are the ground
                       truth posterior (the reference's correctness contract,
                       BASELINE.md "Target: correctness").
  * ``icp-exact``    — the flagship 0.9·ICP + 0.1·RW mixture with the exact
                       transition density (state-dependent ½·logdet M and the
                       relaxation Jacobian included — also an exact sampler).
  * ``icp-parity``   — same mixture with the reference's transition density
                       (``NonRigidIcpProposal.scala:71-85``), which omits both
                       terms: high acceptance but a biased invariant
                       distribution.

For each run we accumulate posterior moments over the second half of the
chain, estimate the Monte-Carlo standard error of each coefficient mean via
ESS, and report whether the exact samplers agree within MC error and how far
the parity sampler deviates.

Usage:
    python tools/posterior_parity.py [--components 50] [--chains 64]
        [--steps 50000] [--out artifacts/posterior_parity.json]
"""
from __future__ import annotations

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import json
import time

import numpy as np


def np_ess(trace: np.ndarray, max_lag: int = 500) -> np.ndarray:
    """Geyer initial-positive-sequence ESS in numpy (FFT autocovariance).

    trace: [C, T, D] → ESS [D].  Host-side, one FFT instead of 500
    eager lag ops."""
    c, t, d = trace.shape
    x = trace - trace.mean(axis=1, keepdims=True)
    n_fft = 1
    while n_fft < 2 * t:
        n_fft *= 2
    f = np.fft.rfft(x, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :t].real
    acov /= np.arange(t, 0, -1)[None, :, None]  # unbiased normalization
    var = acov[:, 0].mean(axis=0)  # [D]
    max_lag = min(max_lag, t - 1)
    rho = acov[:, 1 : max_lag + 1].mean(axis=0) / np.maximum(var, 1e-20)  # [L, D]
    positive = np.cumprod(rho > 0, axis=0)
    tau = 1.0 + 2.0 * (rho * positive).sum(axis=0)
    return c * t / np.maximum(tau, 1.0)


def np_split_rhat(trace: np.ndarray) -> np.ndarray:
    """Split-R̂ in numpy: trace [C, T, D] → [D]."""
    c, t, d = trace.shape
    t2 = t // 2
    halves = np.concatenate([trace[:, :t2], trace[:, t2 : 2 * t2]], axis=0)
    n = t2
    cm = halves.mean(axis=1)
    cv = halves.var(axis=1, ddof=1)
    w = cv.mean(axis=0)
    b = n * cm.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * w + b / n
    return np.sqrt(var_hat / np.maximum(w, 1e-20))


def run_long(data, label, n_chains, n_steps, segment, thin, **kw):
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.ops.closest_point import surface_distances
    from icp_proposal_tpu.sampling import mh
    from icp_proposal_tpu.sampling.state import init_state, transformed_points
    from tools.mixing_sweep import _setup

    ctx, mixture, evaluator = _setup(data, **kw)
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)

    @jax.jit
    def make_carries(s):
        c0 = mh.init_carry(data.model, evaluator, s, mixture)
        return (
            jax.tree.map(lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), c0),
            jax.random.split(jax.random.PRNGKey(1024), n_chains),
        )

    carries, chain_keys = make_carries(init_state(data.model))
    half = n_steps // 2
    r = data.model.rank

    # accumulated over post-burn-in steps (host, float64)
    s1 = np.zeros(r)
    s2 = np.zeros(r)
    n_acc_steps = 0
    acc_count = 0
    icp_sel = 0
    icp_acc = 0
    thin_trace = []  # [C, T/thin, 8] thinned post-burn-in coefficient traces

    cur = np.zeros((n_chains, r), np.float64)
    t0 = time.perf_counter()
    done = 0
    seg_idx = 0
    while done < n_steps:
        n = min(segment, n_steps - done)
        seg_keys = jax.vmap(lambda k: jax.random.fold_in(k, seg_idx))(chain_keys)
        carries, rec = mh.run_chains(step, carries, seg_keys, n)
        acc = np.asarray(rec.accepted)  # [C, n]
        cand = np.asarray(rec.coeffs, np.float64)  # [C, n, r]
        pidx = np.asarray(rec.proposal_idx)
        for i, name in enumerate(mixture.names):
            if "Icp" in name:
                sel = pidx == i
                icp_sel += int(sel.sum())
                icp_acc += int(acc[sel].sum())
        # forward-fill chain states through the segment
        for t in range(n):
            cur = np.where(acc[:, t][:, None], cand[:, t], cur)
            gstep = done + t
            if gstep >= half:
                s1 += cur.sum(axis=0)
                s2 += (cur ** 2).sum(axis=0)
                n_acc_steps += 1
                if (gstep - half) % thin == 0:
                    thin_trace.append(cur[:, :8].astype(np.float32).copy())
        acc_count += int(acc.sum())
        done += n
        seg_idx += 1
        print(f"[{label}] {done}/{n_steps} ({time.perf_counter()-t0:.0f}s)",
              file=sys.stderr, flush=True)
    wall = time.perf_counter() - t0

    n_post = n_acc_steps * n_chains
    mean = s1 / n_post
    var = s2 / n_post - mean ** 2
    sd = np.sqrt(np.maximum(var, 0))

    trace = np.stack(thin_trace, axis=1)  # [C, T_thin, 8]
    ess8 = np_ess(trace, max_lag=min(500, trace.shape[1] - 1))
    rhat8 = np_split_rhat(trace)
    # MC standard error of the mean per coordinate: sd / sqrt(ESS_unthinned).
    # ESS was computed on the thinned trace; thinning by `thin` divides the
    # sample count but (at most) divides autocorrelation time equally, so
    # ESS_unthinned >= ESS_thinned — using ESS_thinned is conservative.
    mcse8 = sd[:8] / np.sqrt(np.maximum(ess8, 1.0))

    import jax
    @jax.jit
    def final_err(st):
        pts = jax.vmap(lambda s: transformed_points(data.model, s))(st)

        def one(p):
            d2, _ = surface_distances(p, jnp.asarray(ctx.tri))
            return jnp.mean(jnp.sqrt(d2))

        return jax.vmap(one)(pts)

    import jax.numpy as jnp
    errs = np.asarray(final_err(carries.state))

    out = {
        "label": label,
        "config": kw,
        "chains": n_chains,
        "steps": n_steps,
        "wall_s": round(wall, 1),
        "samples_per_sec": round(n_steps * n_chains / wall, 1),
        "acceptance_overall": acc_count / (n_steps * n_chains),
        "icp_acceptance": (icp_acc / icp_sel) if icp_sel else None,
        "posterior_mean_first8": mean[:8].tolist(),
        "posterior_sd_first8": sd[:8].tolist(),
        "posterior_mean_norm": float(np.linalg.norm(mean)),
        "mcse_first8": mcse8.tolist(),
        "ess_first8": ess8.tolist(),
        "rhat_first8": rhat8.tolist(),
        "final_avg_dist_mm_mean": float(errs.mean()),
        "final_avg_dist_mm_best": float(errs.min()),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--components", type=int, default=50)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--segment", type=int, default=5000)
    ap.add_argument("--thin", type=int, default=10)
    ap.add_argument("--out", default="artifacts/posterior_parity.json")
    args = ap.parse_args()

    from icp_proposal_tpu.apps.femur import load_femur_data

    data = load_femur_data(model_components=args.components)
    common = dict(n_chains=args.chains, n_steps=args.steps,
                  segment=args.segment, thin=args.thin)
    results = [
        run_long(data, "rw-only", parity=False, step_length=0.1,
                 noise_normal=5.0, tangential=10.0, icp_weight=0.0, **common),
        run_long(data, "icp-exact", parity=False, step_length=0.1,
                 noise_normal=5.0, tangential=10.0, **common),
        run_long(data, "icp-parity", parity=True, step_length=0.1,
                 noise_normal=5.0, tangential=10.0, **common),
    ]

    # pairwise agreement of posterior means, in units of combined MC error
    def compare(a, b):
        ma, mb = np.array(a["posterior_mean_first8"]), np.array(b["posterior_mean_first8"])
        ea, eb = np.array(a["mcse_first8"]), np.array(b["mcse_first8"])
        z = np.abs(ma - mb) / np.sqrt(ea ** 2 + eb ** 2)
        return {"pair": f"{a['label']} vs {b['label']}",
                "mean_abs_diff_first8": np.abs(ma - mb).tolist(),
                "z_scores_first8": z.tolist(),
                "max_z": float(z.max())}

    comparisons = [
        compare(results[0], results[1]),  # two exact samplers: expect max_z ~ O(3)
        compare(results[0], results[2]),  # parity vs exact: quantifies the bias
    ]
    payload = {"runs": results, "comparisons": comparisons}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(comparisons, indent=1))
    print(f"[posterior_parity] wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
