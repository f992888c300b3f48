"""Shortlist-index exactness sweep (VERDICT r1 item 7).

Validates ``ops/surface_index.index_closest`` against the dense exact query
in the regime that matters for random-init chains: queries from model
instances with coefficients ~ N(0, s²·I) AND perturbed poses (translation,
rotation), and queries within 2 mm of the target, for a range of shortlist
sizes K.  Writes the max absolute and relative distance error, the 99.9th
percentile and the mismatch fraction per (K, regime) to an artifact, so the
K=64 default's error model is documented evidence rather than folklore.

Usage:
    python tools/validate_index.py [--components 100]
        [--out artifacts/index_validation.json]
"""
from __future__ import annotations

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import json

import numpy as np


def perturbed_queries(data, key, coeff_scale, trans_mm, rot_rad, n_states=8,
                      stride=4):
    """Sampled chain-like states: coeffs ~ N(0, s²I), pose ~ U(±trans, ±rot).
    Computed on the CPU backend at full float32, so the queries are the same
    on every machine, whatever the default device."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        return _perturbed_queries(data, key, coeff_scale, trans_mm, rot_rad,
                                  n_states, stride)


def _perturbed_queries(data, key, coeff_scale, trans_mm, rot_rad, n_states,
                       stride):
    import jax

    from icp_proposal_tpu.sampling.state import init_state, transformed_points

    out = []
    base = init_state(data.model)
    for i in range(n_states):
        k1, k2, k3, key = jax.random.split(jax.random.fold_in(key, i), 4)
        st = base._replace(
            coeffs=coeff_scale * jax.random.normal(k1, (data.model.rank,)),
            trans=trans_mm * jax.random.uniform(k2, (3,), minval=-1, maxval=1),
            rot=rot_rad * jax.random.uniform(k3, (3,), minval=-1, maxval=1),
        )
        pts = transformed_points(data.model, st)
        out.append(np.asarray(pts)[::stride])
    return np.concatenate(out, axis=0).astype(np.float32)


def near_surface_queries(data, seed, sigma_mm=2.0, n_copies=4, stride=1):
    """Queries within the likelihood's σ of the target: target vertices plus
    N(0, σ²I) offsets — the regime a chain near the posterior queries in."""
    pts = np.asarray(data.target.points, np.float32)[::stride]
    rng = np.random.default_rng(seed)
    q = pts[None] + sigma_mm * rng.standard_normal((n_copies,) + pts.shape)
    return q.reshape(-1, 3).astype(np.float32)


REGIMES = {
    "prior-s1.0": dict(coeff_scale=1.0, trans_mm=0.0, rot_rad=0.0),
    "prior-s2.5": dict(coeff_scale=2.5, trans_mm=0.0, rot_rad=0.0),
    "random-init": dict(coeff_scale=1.0, trans_mm=20.0, rot_rad=0.2),
    "far-init": dict(coeff_scale=2.0, trans_mm=50.0, rot_rad=0.5),
}


def regime_queries(data):
    """The validation's query sets by regime name (fixed seeds): 48 states
    of 1,622 queries per far regime, two noisy copies of the target for the
    near one."""
    import jax

    key = jax.random.PRNGKey(1024)
    queries = {name: perturbed_queries(data, key, n_states=48, stride=1, **kw)
               for name, kw in REGIMES.items()}
    queries["near-2mm"] = near_surface_queries(data, 1024, n_copies=2)
    return queries


def chunked(fn, queries, chunk=4096):
    """fn over [N, 3] queries in chunks (bounds the dense query's memory)."""
    return np.concatenate([np.asarray(fn(queries[i:i + chunk]))
                           for i in range(0, len(queries), chunk)])


def error_stats(d_fast, d_ref):
    """Index-vs-dense distance errors → the artifact's row fields."""
    err = np.abs(d_fast - d_ref)
    rel = err / np.maximum(d_ref, 1e-6)
    return {"max_abs_err_mm": float(err.max()), "max_rel_err": float(rel.max()),
            "p999_abs_err_mm": float(np.quantile(err, 0.999)),
            "frac_mismatched": float(np.mean(err > 1e-4))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--components", type=int, default=100)
    ap.add_argument("--ks", type=int, nargs="+", default=[16, 32, 64, 128])
    ap.add_argument("--out", default="artifacts/index_validation.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps.femur import load_femur_data
    from icp_proposal_tpu.ops.closest_point import surface_distances
    from icp_proposal_tpu.ops.surface_index import index_distances
    from icp_proposal_tpu.sampling.context import build_target_context

    data = load_femur_data(model_components=args.components)
    queries = regime_queries(data)
    # the index the samplers use: the target context's
    indexes = {k: build_target_context(data.target, data.target_boundary_mask,
                                       index_k=k).index for k in args.ks}
    tri = jnp.asarray(indexes[args.ks[0]].tri)
    dense = jax.jit(lambda q: jnp.sqrt(surface_distances(q, tri)[0]))
    refs = {name: chunked(dense, q) for name, q in queries.items()}

    rows = []
    for k, index in indexes.items():
        fast = jax.jit(lambda q, index=index: jnp.sqrt(index_distances(index, q)[0]))
        for name, q in queries.items():
            row = {"k": k, "regime": name, "n_queries": int(q.shape[0]),
                   **error_stats(chunked(fast, q), refs[name])}
            rows.append(row)
            print(f"K={k:4d} {name:12s} n={q.shape[0]:6d} "
                  f"max_err={row['max_abs_err_mm']:.2e} mm "
                  f"rel={row['max_rel_err']:.2e} "
                  f"p99.9={row['p999_abs_err_mm']:.2e} mm "
                  f"frac>1e-4={row['frac_mismatched']:.5f}", flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"[validate_index] wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
