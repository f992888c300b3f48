"""Low-rank Gaussian-Process Morphable Models (GPMMs) in JAX.

Replacement for scalismo's ``StatisticalMeshModel`` /
``DiscreteLowRankGaussianProcess`` (the reference's L1 dependency; call sites
``ModelFittingParameters.scala:93-98``, ``NonRigidIcpProposal.scala:51-83``,
``IcpBasedSurfaceFitting.scala:81-84``).

Model contract (statismo layout, see ``io/statismo.py``):

    instance(α)        x = ref + μ + Φ (√λ ⊙ α)            — dense matmul decode
    coefficients(x)    regularized least squares (σ² = 1e-5) onto span(Φ√λ)
    prior logpdf(α)    standard normal N(0, I_r)
    posterior          analytic low-rank GP regression with per-observation
                       3×3 noise, reduced to an r×r system

Key analytical reduction (the redesign's core): with Q = Φ√λ and
observations (ids, ỹ_i, Σ_i), the GP posterior over *model coefficients* is

    α | y  ~  N( α̂, M⁻¹ ),   M = I + Σᵢ QᵢᵀΣᵢ⁻¹Qᵢ,   α̂ = M⁻¹ Σᵢ QᵢᵀΣᵢ⁻¹ỹᵢ

and the reference's propose/project/logpdf pipeline
(``NonRigidIcpProposal.scala:53-83``: sample the posterior *function*, decode
a mesh, re-project into the model basis, evaluate the posterior coefficient
logpdf) collapses *exactly* (up to the 1e-5 projection regularizer) to
coefficient-space operations on (α̂, chol M):

    posterior sample   α* = α̂ + L⁻ᵀ z,  z ~ N(0, I),  M = L Lᵀ
    reference log-q    -½ (α†-α̂)ᵀ M (α†-α̂) - (r/2)·log 2π

No mesh decode, no least-squares projection, no posterior-basis
eigendecomposition in the hot loop — just one r×r Cholesky per proposal.

Boundary-aware correspondence filtering (reference filters variable-length
lists, ``NonRigidIcpProposal.scala:104,124``) is expressed as zero-precision
masking: a masked observation contributes nothing to M or the rhs, which is
mathematically identical to removing it, with static shapes.

Note on the transition density: scalismo's ``LowRankGaussianProcess.logpdf``
evaluates a *standard* normal in the posterior's normalized coordinates and
therefore omits the ½·log det M term of the true density of α† under
N(α̂, M⁻¹).  That term does not cancel between the forward and reverse MH
directions.  ``transition_logpdf`` takes ``include_logdet``: True (default)
gives the mathematically exact MH correction; False reproduces the
reference's behavior bit-for-bit in semantics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from icp_proposal_tpu.mesh import TriangleMesh

_LOG_2PI = math.log(2.0 * math.pi)
_PROJECTION_SIGMA2 = 1e-5  # scalismo StatisticalMeshModel.coefficients regularizer


class Gpmm(NamedTuple):
    """A discrete low-rank GPMM as a JAX pytree of arrays."""

    ref_points: jax.Array  # [V, 3]
    cells: jax.Array  # [F, 3] int32
    mean_disp: jax.Array  # [V, 3]   GP mean displacement μ
    basis: jax.Array  # [V, 3, r]    raw basis Φ (statismo pcaBasis)
    variance: jax.Array  # [r]       λ
    noise_variance: jax.Array  # []  statismo noiseVariance (informational)
    sbasis: jax.Array  # [V, 3, r]   Q = Φ·diag(√λ), precomputed
    coeff_chol: jax.Array  # [r, r]  chol(σ²I + QᵀQ), lower, for coefficients()

    @property
    def rank(self) -> int:
        return self.basis.shape[-1]

    @property
    def num_points(self) -> int:
        return self.ref_points.shape[0]

    def reference_mesh(self) -> TriangleMesh:
        return TriangleMesh(points=self.ref_points, cells=self.cells)

    def mean_mesh(self) -> TriangleMesh:
        return TriangleMesh(points=self.ref_points + self.mean_disp, cells=self.cells)


def make_gpmm(ref_points, cells, mean_disp, basis, variance, noise_variance=0.0,
              morton_faces: bool = True) -> Gpmm:
    """Build a Gpmm, precomputing the scaled basis and the projection factor
    (in float64 on host for conditioning, stored float32).

    morton_faces: reorder faces by Morton code of their centroid (vertex ids
    and all model semantics unchanged; ``ops/morton.py``)."""
    if morton_faces:
        from icp_proposal_tpu.ops.morton import morton_sort_faces

        cells = np.asarray(cells)[morton_sort_faces(ref_points, cells)]
    basis64 = np.asarray(basis, dtype=np.float64)
    var64 = np.asarray(variance, dtype=np.float64)
    v, _, r = basis64.shape
    q = (basis64 * np.sqrt(var64)[None, None, :]).reshape(3 * v, r)
    gram = q.T @ q + _PROJECTION_SIGMA2 * np.eye(r)
    chol = np.linalg.cholesky(gram)
    # fields stay host-side numpy: they become baked constants inside jitted
    # programs (no eager device dispatches at build time)
    return Gpmm(
        ref_points=np.asarray(ref_points, np.float32),
        cells=np.asarray(cells, np.int32),
        mean_disp=np.asarray(mean_disp, np.float32),
        basis=np.asarray(basis, np.float32),
        variance=np.asarray(variance, np.float32),
        noise_variance=np.asarray(noise_variance, np.float32),
        sbasis=np.asarray(q.reshape(v, 3, r), np.float32),
        coeff_chol=np.asarray(chol, np.float32),
    )


# ---------------------------------------------------------------------------
# decode / project / prior
# ---------------------------------------------------------------------------

def instance_displacement(gpmm: Gpmm, coeffs: jax.Array) -> jax.Array:
    """u(α) = μ + Q α  → [V, 3].  The eigenbasis decode — one [3V, r] matmul
    per call; batches over leading coeff dims via einsum."""
    return gpmm.mean_disp + jnp.einsum(
        "vir,...r->...vi", gpmm.sbasis, coeffs, preferred_element_type=jnp.float32
    )


def instance_points(gpmm: Gpmm, coeffs: jax.Array) -> jax.Array:
    """x(α) = ref + u(α)  (reference ``StatisticalMeshModel.instance``)."""
    return gpmm.ref_points + instance_displacement(gpmm, coeffs)


def instance_mesh(gpmm: Gpmm, coeffs: jax.Array) -> TriangleMesh:
    return TriangleMesh(points=instance_points(gpmm, coeffs), cells=gpmm.cells)


def coefficients(gpmm: Gpmm, points: jax.Array) -> jax.Array:
    """Project a shape back to coefficients: regularized least squares
    α = (σ²I + QᵀQ)⁻¹ Qᵀ(x - ref - μ), σ² = 1e-5 — the scalismo
    ``StatisticalMeshModel.coefficients`` contract (tiny-noise GP regression).
    """
    resid = (points - gpmm.ref_points - gpmm.mean_disp).reshape(-1)  # [3V]
    v = gpmm.num_points
    q = gpmm.sbasis.reshape(3 * v, gpmm.rank)
    rhs = q.T @ resid
    return jax.scipy.linalg.cho_solve((gpmm.coeff_chol, True), rhs)


def prior_logpdf(coeffs: jax.Array) -> jax.Array:
    """N(0, I_r) over shape coefficients (reference
    ``ModelPriorEvaluator.scala:25-30``)."""
    r = coeffs.shape[-1]
    return -0.5 * jnp.sum(coeffs * coeffs, axis=-1) - 0.5 * r * _LOG_2PI


# ---------------------------------------------------------------------------
# analytic GP posterior in coefficient space
# ---------------------------------------------------------------------------

class PosteriorFactors(NamedTuple):
    """Factors of the coefficient-space GP posterior N(α̂, M⁻¹)."""

    alpha_hat: jax.Array  # [r]
    chol_m: jax.Array  # [r, r] lower, M = L Lᵀ
    logdet_m: jax.Array  # []


def _assemble(q_o: jax.Array, pq: jax.Array, resid: jax.Array) -> PosteriorFactors:
    """Shared tail: M = I + QᵀPQ, rhs = (PQ)ᵀỹ, solve & factor.

    q_o, pq : [m, 3, r];  resid : [m, 3].
    The big contraction reshapes to [3m, r]ᵀ[3m, r] — a single matmul.
    """
    m3, r = q_o.shape[0] * 3, q_o.shape[2]
    qf = q_o.reshape(m3, r)
    pqf = pq.reshape(m3, r)
    m_mat = jnp.eye(r, dtype=q_o.dtype) + jnp.dot(
        qf.T, pqf, preferred_element_type=jnp.float32
    )
    # symmetrize against fp round-off before Cholesky
    m_mat = 0.5 * (m_mat + m_mat.T)
    rhs = jnp.einsum("mir,mi->r", pq, resid, preferred_element_type=jnp.float32)
    from icp_proposal_tpu.ops.linalg import chol_solve

    chol, alpha_hat, logdet = chol_solve(m_mat, rhs)
    return PosteriorFactors(alpha_hat=alpha_hat, chol_m=chol, logdet_m=logdet)


def posterior_factors_anisotropic(
    gpmm: Gpmm,
    ids: jax.Array,  # [m] vertex ids of the observations
    obs_disp: jax.Array,  # [m, 3] observed displacement from ref points
    normals: jax.Array,  # [m, 3] unit normals defining the noise frame
    noise_along_normal: float,
    tangential_noise: float,
    mask: jax.Array,  # [m] float/bool; 0 ⇒ observation excluded
) -> PosteriorFactors:
    """Posterior factors for normal-aligned anisotropic observation noise.

    The reference builds an explicit 3×3 eigen-system per correspondence
    (``SurfaceNoiseHelpers.scala:32-60``, including a buggy degenerate-frame
    guard).  The noise covariance is σ_n² nnᵀ + σ_t² (I − nnᵀ), whose
    *precision* is available in closed form:

        P = (1/σ_t²) I + (1/σ_n² − 1/σ_t²) nnᵀ

    so no tangent frame is ever constructed (this also sidesteps the
    reference's inverted guard, which is irrelevant because the noise only
    depends on n through nnᵀ — documented deviation, SURVEY §2.1).
    """
    q_o = jnp.asarray(gpmm.sbasis)[ids]  # [m, 3, r]
    resid = obs_disp - jnp.asarray(gpmm.mean_disp)[ids]  # [m, 3]
    a = 1.0 / (noise_along_normal * noise_along_normal)
    b = 1.0 / (tangential_noise * tangential_noise)
    ntq = jnp.einsum("mi,mir->mr", normals, q_o)  # [m, r]
    pq = b * q_o + (a - b) * normals[:, :, None] * ntq[:, None, :]
    pq = pq * mask.astype(q_o.dtype)[:, None, None]
    return _assemble(q_o, pq, resid)


def posterior_factors_anisotropic_static(
    gpmm: Gpmm,
    q_static,  # [m, 3, r] np — sbasis rows at the STATIC observation ids
    gram_static,  # [m, r, r] np — per-observation Gram matrices QᵢᵀQᵢ
    mean_static,  # [m, 3] np — mean_disp at the static ids
    obs_disp: jax.Array,  # [m, 3]
    normals: jax.Array,  # [m, 3]
    noise_along_normal: float,
    tangential_noise: float,
    mask: jax.Array,  # [m]
) -> PosteriorFactors:
    """Same posterior as ``posterior_factors_anisotropic`` for STATIC
    observation ids (the ICP model-sampling direction uses a fixed vertex
    subset, reference ``NonRigidIcpProposal.scala:45,94``), assembled
    analytically:

        M = I + b·Σᵢ wᵢ QᵢᵀQᵢ + (a−b)·Σᵢ wᵢ gᵢgᵢᵀ,   gᵢ = Qᵢᵀnᵢ

    With QᵢᵀQᵢ precomputed per id, no [m,3,r] per-chain tensor is ever
    materialized — under a 2k-chain vmap the naive pipeline (gather,
    precision-scale, contract) builds [B,m,3,r] intermediates (≈0.5 GB each
    at B=2048, m=200, r=101, computed from the shapes); this form is two
    contractions against static tables.
    """
    a = 1.0 / (noise_along_normal * noise_along_normal)
    b = 1.0 / (tangential_noise * tangential_noise)
    w = mask.astype(jnp.float32)
    resid = obs_disp - jnp.asarray(mean_static)  # [m, 3]
    ntq = jnp.einsum(
        "mi,mir->mr", normals, jnp.asarray(q_static),
        preferred_element_type=jnp.float32,
    )  # [m, r]
    r = ntq.shape[-1]
    m_mat = (
        jnp.eye(r, dtype=jnp.float32)
        + b * jnp.einsum("m,mrs->rs", w, jnp.asarray(gram_static),
                         preferred_element_type=jnp.float32)
        + (a - b) * jnp.einsum("m,mr,ms->rs", w, ntq, ntq,
                               preferred_element_type=jnp.float32)
    )
    m_mat = 0.5 * (m_mat + m_mat.T)
    n_dot_y = jnp.sum(normals * resid, axis=-1)  # [m]
    rhs = b * jnp.einsum(
        "mir,mi->r", jnp.asarray(q_static), w[:, None] * resid,
        preferred_element_type=jnp.float32,
    ) + (a - b) * jnp.einsum("mr,m->r", ntq, w * n_dot_y,
                             preferred_element_type=jnp.float32)
    from icp_proposal_tpu.ops.linalg import chol_solve

    chol, alpha_hat, logdet = chol_solve(m_mat, rhs)
    return PosteriorFactors(alpha_hat=alpha_hat, chol_m=chol, logdet_m=logdet)


def posterior_factors_isotropic(
    gpmm: Gpmm,
    ids: jax.Array,
    obs_disp: jax.Array,
    sigma2: float | jax.Array,
    mask: jax.Array,
) -> PosteriorFactors:
    """Posterior factors for isotropic observation noise σ²I — the
    deterministic-ICP regression (reference ``IcpBasedSurfaceFitting.scala:81``,
    scalismo ``StatisticalMeshModel.posterior(corr, sigma2)``)."""
    q_o = jnp.asarray(gpmm.sbasis)[ids]
    resid = obs_disp - jnp.asarray(gpmm.mean_disp)[ids]
    pq = q_o / sigma2 * mask.astype(q_o.dtype)[:, None, None]
    return _assemble(q_o, pq, resid)


def sample_posterior_coeffs(key, factors: PosteriorFactors) -> jax.Array:
    """Draw α* ~ N(α̂, M⁻¹) via α̂ + L⁻ᵀ z (cov = L⁻ᵀL⁻¹ = M⁻¹)."""
    from icp_proposal_tpu.ops.linalg import tri_solve_lt

    z = jax.random.normal(key, factors.alpha_hat.shape, factors.alpha_hat.dtype)
    delta = tri_solve_lt(factors.chol_m, z)
    return factors.alpha_hat + delta


def transition_logpdf(
    factors: PosteriorFactors, alpha_star: jax.Array, include_logdet: bool = True
) -> jax.Array:
    """log N(α*; α̂, M⁻¹), the ICP-proposal transition density.

    include_logdet=False reproduces the reference's
    ``LowRankGaussianProcess.logpdf``-in-normalized-coordinates behavior
    (``NonRigidIcpProposal.scala:71-84``), which drops ½·log det M; see module
    docstring.
    """
    delta = alpha_star - factors.alpha_hat
    lt_delta = jnp.einsum("ij,...j->...i", factors.chol_m.T, delta)
    quad = jnp.sum(lt_delta * lt_delta, axis=-1)
    r = alpha_star.shape[-1]
    out = -0.5 * quad - 0.5 * r * _LOG_2PI
    if include_logdet:
        out = out + 0.5 * factors.logdet_m
    return out
