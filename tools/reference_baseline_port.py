"""Single-core NumPy port of the reference hot loop: baseline + cross-impl sampler.

Two jobs:

1. **Measured CPU baseline** (``main()``): the Scala reference cannot be
   built here (sbt needs network; zero egress), so the ``vs_baseline``
   denominators in ``bench.py`` are measured from this faithful
   single-threaded NumPy port of the reference's per-step algorithm
   (SURVEY §3.1 hot loop; reference
   ``apps/femur/IcpProposalRegistration.scala:50-104``,
   ``api/sampling/proposals/NonRigidIcpProposal.scala:53-153``), timed on
   one CPU core.

2. **Cross-implementation posterior parity** (``PortSampler``): run the
   port as a *sampler* (VERDICT r2 item 2) with geometry (point subsets,
   noise frames, densities) matched to the JAX framework's parity mode, so
   its long-chain posterior moments provide an INDEPENDENT check of the JAX
   sampler — scipy KD-tree + numpy vs our JAX/Pallas kernels share no code.

Faithfulness notes (everything is tilted IN THE REFERENCE'S FAVOR, so the
measured number is an upper bound on what the Scala/JVM code does):

* Per-step work mirrors the reference exactly: one full-mesh eigenbasis
  decode of the candidate, closest-point correspondence searches for BOTH
  ICP directions at the candidate anchor (2·rank queries each), two r×r
  GP-posterior assemblies + Cholesky factorizations (the mixture transition
  density needs every ICP component at the reverse anchor every step —
  scalismo ``MixtureProposal.fromProposalsWithTransition`` sums component
  densities; the LRU (``NonRigidIcpProposal.scala:49``) only saves the
  *current*-state anchor, which we replicate by caching it across steps),
  two relaxation-compensated projections per transition evaluation
  (decode + posterior-basis least squares, ``NonRigidIcpProposal.scala:77-83``),
  and the 4·rank-point Euclidean evaluator at the candidate
  (``IndependentPointDistanceEvaluator.scala:40-46``; the accept/reject
  logger's re-evaluation is absorbed by the reference's LRU and is NOT
  counted here).
* Closest-point queries use a scipy cKDTree over triangle centroids plus
  exact point→triangle refinement on the K=16 nearest — at 3,240 triangles
  this does *less* work than scalismo's per-query BVH descent over boxed
  JVM ``Point`` objects.
* All linear algebra is C-backed BLAS via NumPy, pinned to ONE thread
  (JVM breeze/netlib is the same class of backend).
* The transition density is the reference's parity form (no ½·log det M /
  relaxation-Jacobian corrections — they cost nothing anyway, the Cholesky
  is already computed).  Round-3 fix: the normalized-coordinate quadratic
  is δᵀMδ (y = Lᵀδ); an earlier revision computed δᵀM⁻¹δ (y = L⁻¹δ), which
  left the per-step FLOPs identical (baseline timing unaffected) but
  sampled a different density — unusable for the cross-impl parity study.

Usage (baseline):
    OMP_NUM_THREADS=1 python tools/reference_baseline_port.py \
        [--components 100] [--steps 300] [--out artifacts/cpu_baseline.json]
"""
from __future__ import annotations

import os

# pin BLAS to one core BEFORE numpy import
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E402,E702

import argparse
import json
import time

import numpy as np
from scipy.spatial import cKDTree

# ---------------------------------------------------------------------------
# exact point -> triangle (numpy, single query batch)
# ---------------------------------------------------------------------------


def _point_tri_d2(p: np.ndarray, tri: np.ndarray):
    """p [n,3] queries, tri [n,k,3,3] candidate triangles per query →
    (d2 [n,k], closest [n,k,3]).  Ericson's region decomposition."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    p = p[:, None, :]
    ab, ac, ap = b - a, c - a, p - a
    d1 = np.sum(ab * ap, -1)
    d2_ = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2_ - d1 * d6
    vc = d1 * d4 - d3 * d2_
    denom = va + vb + vc
    v = np.where(np.abs(denom) > 1e-30, vb / np.where(denom == 0, 1, denom), 0.0)
    w = np.where(np.abs(denom) > 1e-30, vc / np.where(denom == 0, 1, denom), 0.0)
    inside = a + v[..., None] * ab + w[..., None] * ac

    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0, 1)
    on_ab = a + t_ab[..., None] * ab
    t_ac = np.clip(d2_ / np.where(d2_ - d6 == 0, 1, d2_ - d6), 0, 1)
    on_ac = a + t_ac[..., None] * ac
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1,
                                        (d4 - d3) + (d5 - d6)), 0, 1)
    on_bc = b + t_bc[..., None] * (c - b)

    cand = np.stack([inside, on_ab, on_ac, on_bc, a, b, c], axis=-2)
    # invalidate the interior candidate when barycentric coords are outside
    valid_inside = (va >= 0) & (vb >= 0) & (vc >= 0)
    d2s = np.sum((cand - p[..., None, :]) ** 2, -1)
    d2s[..., 0] = np.where(valid_inside, d2s[..., 0], np.inf)
    best = np.argmin(d2s, -1)
    ii = np.indices(best.shape)
    closest = cand[ii[0], ii[1], best]
    return d2s[ii[0], ii[1], best], closest


class SurfaceQuery:
    """KD-tree (triangle centroids) + exact refine — generous stand-in for
    scalismo's BVH ``closestPointOnSurface``."""

    def __init__(self, points, cells, k=16):
        self.cells = cells
        self.tri = points[cells]  # [F,3,3]
        self.k = min(k, len(cells))
        self.tree = cKDTree(self.tri.mean(axis=1))

    def closest(self, q):
        """→ (dist [n], closest point [n,3], face idx [n])."""
        _, idx = self.tree.query(q, k=self.k)
        d2, cp = _point_tri_d2(q, self.tri[idx])
        j = np.argmin(d2, axis=1)
        ii = np.arange(len(q))
        return np.sqrt(d2[ii, j]), cp[ii, j], idx[ii, j]


def vertex_normals(points, cells):
    fn = np.cross(points[cells[:, 1]] - points[cells[:, 0]],
                  points[cells[:, 2]] - points[cells[:, 0]])
    vn = np.zeros_like(points)
    for i in range(3):
        np.add.at(vn, cells[:, i], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.where(n == 0, 1, n)


# ---------------------------------------------------------------------------
# the ported hot loop as a reusable sampler
# ---------------------------------------------------------------------------


class PortSampler:
    """Reference-semantics MH sampler (parity transition density) on numpy.

    Geometry is configurable so the chain can target EXACTLY the same
    density as the JAX framework's parity mode: pass the framework's seeded
    id subsets (``icp_model_ids``/``icp_target_ids``/``eval_ids``) and the
    same noise scales.  Boundary handling matches the framework: the
    model→target direction masks correspondences whose nearest vertex OF THE
    HIT FACE is a target-boundary vertex; the target→model direction masks
    on the model-side nearest vertex (reference ``NonRigidIcpProposal.scala:
    94-131`` semantics with the framework's hit-face convention).
    """

    def __init__(self, model, target_points, target_cells, target_boundary,
                 model_boundary, icp_model_ids, icp_target_ids, eval_ids,
                 sigma_n=5.0, sigma_t=10.0, step_len=0.1, sigma_eval=2.0,
                 weights=(0.45, 0.45, 0.1), rw_sigma=0.1):
        self.rank = model.rank
        self.ref = np.asarray(model.ref_points, np.float64)
        self.mu = np.asarray(model.mean_disp, np.float64)
        self.Q = np.asarray(model.sbasis, np.float64)  # [V,3,r]
        self.cells = np.asarray(model.cells)
        self.V = self.ref.shape[0]
        self.Qf = self.Q.reshape(3 * self.V, self.rank)

        self.tpts = np.asarray(target_points, np.float64)
        self.tcells = np.asarray(target_cells)
        self.target_q = SurfaceQuery(self.tpts, self.tcells)
        self.t_boundary = np.asarray(target_boundary, bool)
        self.m_boundary = np.asarray(model_boundary, bool)

        self.icp_ids = np.asarray(icp_model_ids)
        self.tgt_ids = np.asarray(icp_target_ids)
        self.eval_ids = np.asarray(eval_ids)
        self.sigma_n, self.sigma_t = sigma_n, sigma_t
        self.a_prec, self.b_prec = 1.0 / sigma_n**2, 1.0 / sigma_t**2
        self.step_len = step_len
        self.sigma_eval = sigma_eval
        self.comp_w = np.asarray(weights, np.float64)
        self.log_w = np.log(self.comp_w)
        self.rw_sigma = rw_sigma

    def decode(self, alpha):
        return self.ref + self.mu + (self.Qf @ alpha).reshape(self.V, 3)

    def factors(self, alpha, pts=None, normals=None):
        """Both ICP components' posterior factors anchored at alpha.
        → dict dir → (alpha_hat, chol(M))."""
        if pts is None:
            pts = self.decode(alpha)
        if normals is None:
            normals = vertex_normals(pts, self.cells)
        out = {}
        # model direction: sampled model vertices -> target surface; boundary
        # checked on the nearest vertex of the HIT face (framework convention)
        qp = pts[self.icp_ids]
        _, cp, fidx = self.target_q.closest(qp)
        face_verts = self.tcells[fidx]  # [m, 3]
        vd = np.linalg.norm(self.tpts[face_verts] - cp[:, None, :], axis=-1)
        nv = face_verts[np.arange(len(fidx)), np.argmin(vd, axis=1)]
        mask = ~self.t_boundary[nv]
        # noise frame anchored on the CURRENT-MESH normal at the sampled
        # model vertex (framework: cur_normals[model_ids])
        nrm = normals[self.icp_ids]
        obs = cp - self.ref[self.icp_ids]  # displacement observation (pose = id)
        out["model"] = self._assemble(self.icp_ids[mask], obs[mask], nrm[mask])
        # target direction: sampled target points -> nearest model vertex
        mtree = cKDTree(pts)
        _, mv = mtree.query(self.tpts[self.tgt_ids])
        mask2 = ~self.m_boundary[mv]
        obs2 = self.tpts[self.tgt_ids] - self.ref[mv]
        nrm2 = normals[mv]
        out["target"] = self._assemble(mv[mask2], obs2[mask2], nrm2[mask2])
        return out

    def _assemble(self, ids, obs, nrm):
        rank = self.rank
        qo = self.Q[ids]  # [m,3,r]
        resid = obs - self.mu[ids]
        ntq = np.einsum("mi,mir->mr", nrm, qo)
        pq = self.b_prec * qo + (self.a_prec - self.b_prec) * nrm[:, :, None] * ntq[:, None, :]
        M = np.eye(rank) + np.einsum("mir,mis->rs", qo, pq)
        rhs = np.einsum("mir,mi->r", pq, resid)
        L = np.linalg.cholesky(M)
        alpha_hat = np.linalg.solve(M, rhs)
        return alpha_hat, L

    def q_log_density(self, fac, alpha_from, alpha_to):
        """Reference parity density (NonRigidIcpProposal.scala:71-85):
        project the relaxation-compensated state into the posterior,
        standard-normal logpdf in normalized coordinates (quadratic δᵀMδ,
        i.e. y = Lᵀδ).  Includes the two full-mesh ops the reference pays:
        instance decode of the compensated state + coefficients projection."""
        alpha_hat, L = fac
        comp = alpha_from + (alpha_to - alpha_from) / self.step_len
        mesh = self.decode(comp)  # reference: model.instance(compensatedTo)
        # posterior.coefficients(toMesh): r-dim least squares through the
        # model basis (the posterior basis spans the same space)
        resid3v = (mesh - self.ref - self.mu).reshape(-1)
        proj = np.linalg.solve(
            self.Qf.T @ self.Qf + 1e-5 * np.eye(self.rank), self.Qf.T @ resid3v
        )
        d = proj - alpha_hat
        y = L.T @ d
        return -0.5 * float(y @ y) - 0.5 * self.rank * np.log(2 * np.pi)

    def evaluator(self, pts):
        d, _, _ = self.target_q.closest(pts[self.eval_ids])
        s = self.sigma_eval
        return float(np.sum(-0.5 * (d / s) ** 2 - np.log(s)
                            - 0.5 * np.log(2 * np.pi)))

    def prior(self, alpha):
        return float(-0.5 * alpha @ alpha - 0.5 * self.rank * np.log(2 * np.pi))

    def run(self, steps, seed=1024, init_alpha=None, record_from=0,
            record_every=1):
        """Run the MH chain; → (trace [n_rec, r], acceptance, wall_s)."""
        rank = self.rank
        rng = np.random.default_rng(seed)
        alpha = (np.zeros(rank) if init_alpha is None
                 else np.asarray(init_alpha, np.float64))
        cur_factors = self.factors(alpha)
        cur_post = self.prior(alpha) + self.evaluator(self.decode(alpha))
        n_acc = 0
        trace = []

        t0 = time.perf_counter()
        for it in range(steps):
            # candidate generation
            c = rng.choice(len(self.comp_w), p=self.comp_w)
            if c == 2:  # random walk
                cand = alpha + self.rw_sigma * rng.standard_normal(rank)
            else:
                ahat, L = cur_factors["model" if c == 0 else "target"]
                astar = ahat + np.linalg.solve(L.T, rng.standard_normal(rank))
                cand = alpha + (astar - alpha) * self.step_len
            # candidate decode + reverse-anchor factors (both components: the
            # mixture transition density needs them regardless of c)
            cand_pts = self.decode(cand)
            cand_normals = vertex_normals(cand_pts, self.cells)
            cand_factors = self.factors(cand, cand_pts, cand_normals)
            # mixture transition densities (parity form), forward + reverse
            diff = cand - alpha

            def mix_q(fac, a_from, a_to):
                comps = np.asarray([
                    self.q_log_density(fac["model"], a_from, a_to),
                    self.q_log_density(fac["target"], a_from, a_to),
                    -0.5 * float(diff @ diff) / self.rw_sigma**2
                    - rank * np.log(self.rw_sigma)
                    - 0.5 * rank * np.log(2 * np.pi),
                ])
                m = np.max(comps + self.log_w)
                return m + np.log(np.sum(np.exp(comps + self.log_w - m)))

            lq_fwd = mix_q(cur_factors, alpha, cand)
            lq_rev = mix_q(cand_factors, cand, alpha)
            cand_post = self.prior(cand) + self.evaluator(cand_pts)
            log_alpha_mh = (cand_post - cur_post) + (lq_rev - lq_fwd)
            if np.log(rng.uniform()) < log_alpha_mh:
                alpha, cur_post, cur_factors = cand, cand_post, cand_factors
                n_acc += 1
            if it >= record_from and (it - record_from) % record_every == 0:
                trace.append(alpha.copy())
        dt = time.perf_counter() - t0
        return np.asarray(trace), n_acc / steps, dt


def port_vertex_subset(num_points: int, n: int, seed: int) -> np.ndarray:
    """The port's OWN id-subset selection (VERDICT r3 item 5: the cross-impl
    comparison must not share the framework's
    ``ops.surface_sampling.seeded_vertex_subset`` — a bug there would be
    invisible).  Contract being matched, written independently: sorted,
    int32, n ids drawn without replacement by ``RandomState(seed).choice``.
    If the framework's selection ever deviates from this contract, the two
    samplers target different densities and the parity study FAILS — which
    is the point."""
    n = min(n, num_points)
    picked = np.random.RandomState(seed).choice(num_points, n, replace=False)
    picked.sort()
    return picked.astype(np.int32)


def port_boundary_mask(cells: np.ndarray, num_points: int) -> np.ndarray:
    """The port's OWN boundary-vertex detection (independent of the
    framework's ``mesh.boundary_vertex_mask``): a vertex is on the boundary
    iff it belongs to an edge used by exactly one triangle.  Hash-map edge
    counting instead of the framework's vectorized unique/counts."""
    from collections import Counter

    counts: Counter = Counter()
    for tri in np.asarray(cells):
        a, b, c = int(tri[0]), int(tri[1]), int(tri[2])
        for e in ((a, b), (b, c), (c, a)):
            counts[(min(e), max(e))] += 1
    mask = np.zeros(num_points, dtype=bool)
    for (u, v), k in counts.items():
        if k == 1:
            mask[u] = mask[v] = True
    return mask


def femur_port_sampler(components=100, data=None, **kw):
    """PortSampler over the femur workload, targeting the identical parity
    density as ``apps.femur.make_icp_proposal_setup(..., parity=True)``:
    same seeds (MixtureProgram 1024/1025; EvaluatorProgram 1024), but the id
    subsets and boundary masks are computed by the port's OWN code above —
    only the raw mesh/model arrays are shared (IO)."""
    from icp_proposal_tpu.apps.femur import load_femur_data

    data = data or load_femur_data(model_components=components)
    model = data.model
    tpts = np.asarray(data.target.points)
    tcells = np.asarray(data.target.cells)
    return PortSampler(
        model,
        tpts,
        tcells,
        port_boundary_mask(tcells, len(tpts)),
        port_boundary_mask(np.asarray(model.cells), model.num_points),
        icp_model_ids=port_vertex_subset(model.num_points, 2 * model.rank, 1024),
        icp_target_ids=port_vertex_subset(len(tpts), 2 * model.rank, 1025),
        eval_ids=port_vertex_subset(model.num_points, 4 * model.rank, 1024),
        **kw,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--components", type=int, default=100)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="artifacts/cpu_baseline.json")
    args = ap.parse_args()

    sampler = femur_port_sampler(args.components)
    _, acceptance, dt = sampler.run(args.steps, seed=1024)

    out = {
        "metric": "cpu_single_core_samples_per_sec_femur_gpmm"
                  f"{args.components}_icp_proposal",
        "value": round(args.steps / dt, 2),
        "unit": "samples/s (1 CPU core, numpy port of reference hot loop)",
        "steps": args.steps,
        "wall_s": round(dt, 2),
        "acceptance": round(acceptance, 4),
        "threads": {k: os.environ.get(k) for k in
                    ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")},
        "notes": "upper bound on the Scala/JVM reference (see module docstring)",
    }
    print(json.dumps(out))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
