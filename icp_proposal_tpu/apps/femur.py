"""Femur workload: data loading and experiment configurations.

Equivalent of the reference's ``apps/femur`` package: ``Paths.scala``,
``LoadTestData.scala`` (model + target, landmark-aligned at load time), and
the entry-point configurations of ``IcpProposalRegistration.scala`` /
``IcpRegistration.scala``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from icp_proposal_tpu.io.landmarks import common_landmarks, read_landmarks
from icp_proposal_tpu.io.stl import read_stl
from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
from icp_proposal_tpu.models.gpmm import Gpmm
from icp_proposal_tpu.ops.rigid import rigid_landmark_alignment

# Femur surface of the reference's topology (1,622 vertices, 3,240 faces):
# the posterior-mean shape of a femur GPMM fit to the reference's target,
# written by this repository's posterior analysis (``analysis/``).
FEMUR_MESH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "femur_mesh.stl",
)
# Fixed landmark vertices of FEMUR_MESH: the extreme vertices along x, y, z.
FEMUR_LANDMARK_IDS = (370, 1193, 385, 590, 684, 1350)


@dataclass
class FemurData:
    model: Gpmm
    target: TriangleMesh
    model_landmarks: Dict[str, np.ndarray]
    target_landmarks: Dict[str, np.ndarray]
    target_boundary_mask: np.ndarray = field(default=None)
    model_boundary_mask: np.ndarray = field(default=None)


def _aligned_femur_data(model: Gpmm, model_lms, points, cells, target_lms):
    """Rigidly align the target to the model frame via the shared landmarks
    (reference ``LoadTestData.scala:32-50``: transform computed target→model
    landmarks with rotation center at the origin)."""
    src, dst, names = common_landmarks(target_lms, model_lms)
    transform = rigid_landmark_alignment(src, dst, center=np.zeros(3))
    aligned_points = np.asarray(transform.apply(points.astype(np.float32)))
    aligned_lms = {n: np.asarray(transform.apply(target_lms[n][None, :]))[0] for n in target_lms}
    return FemurData(
        model=model,
        target=make_mesh(aligned_points, cells),
        model_landmarks=model_lms,
        target_landmarks=aligned_lms,
        target_boundary_mask=boundary_vertex_mask(cells, len(points)),
        model_boundary_mask=boundary_vertex_mask(
            np.asarray(model.cells), model.num_points
        ),
    )


def make_femur_data(model_components: int = 50, seed: int = 1024) -> FemurData:
    """The seeded femur workload, built from ``FEMUR_MESH`` alone.

    Model: the reference's femur kernel + Nyström GPMM
    (``build_femur_gpmm``; ``model_components + 1`` basis columns).  Target:
    a model instance with coefficients ~ N(0, I), turned by 2–5° about a
    random axis through its centroid and shifted by 10–40 mm per axis.
    Landmarks: ``FEMUR_LANDMARK_IDS`` on the reference and the same vertices
    on the target, so the load-time landmark alignment runs as for real data.
    """
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm

    ref_points, cells = read_stl(FEMUR_MESH)
    model = build_femur_gpmm(ref_points, cells, model_components, seed)
    rng = np.random.default_rng(seed)
    coeffs = rng.standard_normal(model.rank)
    shape = (
        np.asarray(model.ref_points, np.float64)
        + np.asarray(model.mean_disp, np.float64)
        + np.asarray(model.sbasis, np.float64) @ coeffs
    )
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(2.0, 5.0))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)
    shift = rng.uniform(10.0, 40.0, 3) * rng.choice([-1.0, 1.0], 3)
    centroid = shape.mean(axis=0)
    target_points = (shape - centroid) @ rot.T + centroid + shift
    names = [f"L{i}" for i in range(len(FEMUR_LANDMARK_IDS))]
    ids = np.asarray(FEMUR_LANDMARK_IDS)
    model_lms = dict(zip(names, np.asarray(ref_points, np.float64)[ids]))
    target_lms = dict(zip(names, target_points[ids]))
    return _aligned_femur_data(
        model, model_lms, target_points.astype(np.float32), cells, target_lms
    )


def load_femur_data(model_components: int = 50, data_dir: str | None = None,
                    seed: int = 1024) -> FemurData:
    """The femur workload: the seeded one (``make_femur_data``) by default,
    or the reference's statismo model, target mesh and landmark files from
    ``data_dir`` (reading them needs ``h5py``)."""
    if data_dir is None:
        return make_femur_data(model_components, seed)
    from icp_proposal_tpu.io.statismo import read_statismo_gpmm

    model = read_statismo_gpmm(
        os.path.join(data_dir, f"femur_gp_model_{model_components}-components.h5")
    )
    model_lms = read_landmarks(os.path.join(data_dir, "femur_reference.json"))
    points, cells = read_stl(os.path.join(data_dir, "femur_target.stl"))
    target_lms = read_landmarks(os.path.join(data_dir, "femur_target.json"))
    return _aligned_femur_data(model, model_lms, points, cells, target_lms)


# ---------------------------------------------------------------------------
# flagship configurations (reference ``IcpProposalRegistration.scala:50-104``)
# ---------------------------------------------------------------------------

def make_icp_proposal_setup(data: FemurData, parity: bool = False,
                            build_index: bool = True):
    """The flagship MH configuration: 0.9·ICP-mixture (model+target dirs) +
    0.1·random-shape; Euclidean evaluator σ=2, ModelToTarget; evaluator
    points = 4·rank, ICP points = 2·rank (reference :59-87).
    build_index=False queries the target densely (exact everywhere, as the
    reference's BVH; the cross-implementation parity run needs it)."""
    import jax.numpy as jnp

    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask,
                               build_index=build_index)
    n_icp = 2 * model.rank
    n_eval = 4 * model.rank
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=2.0, n_points=n_eval
    )
    # Query fusion (exact mode only): make the ICP model-vertex subset a
    # stride-2 slice of the evaluator's Morton-sorted subset, so the MH step
    # runs ONE target-surface closest-point pass for both (mh._fusion_plan;
    # ~600 → ~400 queries/step).  Any seeded subset is an equally valid
    # configuration (SURVEY §7 quirk (a)); parity mode keeps the round-3
    # independent subsets so the cross-impl port targets the same density.
    icp_model_ids = (
        None if parity
        else np.asarray(evaluator.model_ids("distance"))[::2]
    )
    mixture = MixtureProgram(
        nest(
            (0.9, mixed_proposal_icp(
                n_points=n_icp,
                projection_direction="model_and_target",
                tangential_noise=10.0,
                noise_along_normal=5.0,
                step_length=0.1,
            )),
            (0.1, mixed_random_shape_proposal()),
        ),
        model,
        ctx,
        np.asarray(data.model_boundary_mask),
        parity=parity,
        icp_model_ids=icp_model_ids,
    )
    return ctx, mixture, evaluator


def make_hybrid_setup(data: FemurData, icp_weight=0.5, mala_weight=0.4,
                      mala_step=0.1, rw_sigma=0.1, step_length=0.1,
                      sigma_eval=2.0, adapt=True):
    """The RECOMMENDED exact-mode configuration (docs/MIXING.md §5):
    0.5·ICP-mixture + 0.4·MALA + 0.1·random-walk with Robbins–Monro scale
    adaptation, exact transition densities.

    Rationale: under the exact density (½·log det M + relaxation Jacobian
    restored — the corrections the reference omits), the paper's ICP
    proposal alone accepts at only 2–5% because its normalizer is anchored
    at the from-state (docs/MIXING.md §3); the gradient-informed MALA
    component restores informed moves with a cheap exact reverse density,
    and the hybrid has the best exact-mode ESS/step of every configuration
    swept (docs/MIXING.md §4).  Use ``make_icp_proposal_setup``
    (optionally ``parity=True``) for reference-faithful comparison or
    MAP-style fitting; use this for posterior inference."""
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
    rw_weight = 1.0 - icp_weight - mala_weight
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=sigma_eval,
        n_points=4 * model.rank,
    )
    mixture = MixtureProgram(
        nest(
            (icp_weight, mixed_proposal_icp(
                n_points=2 * model.rank,
                projection_direction="model_and_target",
                step_length=step_length,
            )),
            (mala_weight, gradient_shape_proposal((mala_step,))),
            (rw_weight, mixed_random_shape_proposal((rw_sigma,))),
        ),
        model,
        ctx,
        np.asarray(data.model_boundary_mask),
        parity=False,
        adapt=AdaptConfig() if adapt else None,
        # fused query pass (see make_icp_proposal_setup)
        icp_model_ids=np.asarray(evaluator.model_ids("distance"))[::2],
    )
    return ctx, mixture, evaluator


def make_random_walk_setup(data: FemurData, shape_steps=(0.1,), sigma_eval=2.0,
                           adapt=False):
    """Random-walk-only configuration (the comparison chain of
    ``RunMHRandomInitComparison.scala``).

    adapt=True adds diminishing Robbins–Monro scale adaptation targeting
    acceptance 0.234 (the fixed σ=0.1 walk runs at ~0.09 — under-tuned;
    adaptation is free per step and raises hold-trace ESS/wall-second)."""
    import jax.numpy as jnp

    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        mixed_random_shape_proposal,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask)
    mixture = MixtureProgram(
        mixed_random_shape_proposal(shape_steps),
        model,
        ctx,
        np.asarray(data.model_boundary_mask),
        adapt=AdaptConfig() if adapt else None,
    )
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=sigma_eval, n_points=4 * model.rank
    )
    return ctx, mixture, evaluator


def make_random_walk_adapt_setup(data: FemurData, **kw):
    """``make_random_walk_setup`` with scale adaptation on (registry entry)."""
    return make_random_walk_setup(data, adapt=True, **kw)


def make_mala_setup(data: FemurData, step_sizes=(0.1,), sigma_eval=2.0,
                    adapt=True):
    """MALA-only configuration with scale adaptation (beyond-reference;
    candidate recommended exact-mode config, VERDICT r4 item 4: it skips the
    two GP-posterior solves of the ICP proposal entirely — one reverse-mode
    gradient of the product posterior per step — while targeting the 0.574
    Langevin-optimal acceptance)."""
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        gradient_shape_proposal,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask)
    mixture = MixtureProgram(
        gradient_shape_proposal(step_sizes),
        model,
        ctx,
        np.asarray(data.model_boundary_mask),
        adapt=AdaptConfig() if adapt else None,
    )
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=sigma_eval, n_points=4 * model.rank
    )
    return ctx, mixture, evaluator


# Named setup registry (CLI --setup values, quality rows, pod/convergence
# tools).  "parity" is the reference recipe WITH the reference's own
# (normalizer-anchored) transition density; every other row is exact-MH.
SETUPS = {
    "flagship": make_icp_proposal_setup,
    "parity": lambda data: make_icp_proposal_setup(data, parity=True),
    "hybrid": make_hybrid_setup,
    "rw": make_random_walk_setup,
    "rw-adapt": make_random_walk_adapt_setup,
    "mala": make_mala_setup,
}

# The recommended default: the argmax of ess_per_wall_second in an earlier
# round's quality run (tools/quality_run.py).  That record was measured on
# the machine the system was first built for and was removed; re-measuring
# on the GPU is owed (ROADMAP), and the decision follows that measurement.
RECOMMENDED_SETUP = "rw"


def recommended_setup() -> str:
    """Name of the recommended exact-mode configuration (see RECOMMENDED_SETUP)."""
    return RECOMMENDED_SETUP


def run_icp_proposal_registration(
    num_samples: int = 10000,
    model_components: int = 50,
    n_chains: int = 1,
    json_path=None,
    seed: int = 1024,
    verbose: bool = True,
    resume_log=None,
    resume_mode: str = "best",
    setup: str | None = None,
):
    """End-to-end registration run (reference ``IcpProposalRegistration.main``).

    setup: any ``SETUPS`` key — "flagship" = the reference recipe with exact
    densities; "parity" = the reference recipe with its own (biased)
    transition density; "hybrid" = exact-mode ICP+MALA+RW; "rw"/"rw-adapt"/
    "mala" = the cheap fast-mixing samplers.  Default = ``recommended_setup()``
    (see RECOMMENDED_SETUP; the reference's ICP recipe stays one flag
    away).
    resume_log: restart from a previous run's JSON chain log (mode "best" =
    MAP record, "last" = continue the chain)."""
    import jax

    from icp_proposal_tpu.registration.comparison import evaluate_reconstruction
    from icp_proposal_tpu.registration.sampling_registration import SamplingRegistration
    from icp_proposal_tpu.sampling.state import transformed_mesh

    data = load_femur_data(model_components)
    ctx, mixture, evaluator = SETUPS[setup or recommended_setup()](data)
    reg = SamplingRegistration(
        data.model, data.target, mixture, evaluator, verbose=verbose
    )
    result = reg.runfitting(
        num_samples,
        key=jax.random.PRNGKey(seed),
        n_chains=n_chains,
        json_path=json_path,
        resume_log=resume_log,
        resume_mode=resume_mode,
    )
    best_mesh = transformed_mesh(data.model, result.best_state)
    if verbose:
        evaluate_reconstruction("SAMPLE", best_mesh, data.target)
    return result, data


def run_deterministic_icp(
    num_iterations: int = 100,
    model_components: int = 50,
    n_sample_points: int = None,
    seed: int = 1024,
    verbose: bool = True,
):
    """Deterministic non-rigid ICP entry point (reference
    ``IcpRegistration.main``: full-resolution point counts, 100 iterations,
    σ=1e-15, ModelAndTargetSampling)."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.mesh import TriangleMesh
    from icp_proposal_tpu.models.gpmm import instance_points
    from icp_proposal_tpu.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )
    from icp_proposal_tpu.registration.comparison import evaluate_reconstruction
    from icp_proposal_tpu.registration.icp_fitting import icp_surface_fitting
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.utils.profiling import wall_timer

    data = load_femur_data(model_components)
    model = data.model
    n = n_sample_points or model.num_points
    ctx = build_target_context(data.target, data.target_boundary_mask)
    model_ids = jnp.asarray(seeded_vertex_subset(model.num_points, n, seed))
    target_pts = sample_points_on_surface(jax.random.PRNGKey(seed), data.target, n)
    with wall_timer("ICP", verbose):
        coeffs = icp_surface_fitting(
            model, ctx, model_ids, target_pts,
            num_iterations=num_iterations, sigma_seq=(1e-15,),
            projection_direction="model_and_target", key=jax.random.PRNGKey(seed),
        )
        coeffs.block_until_ready()
    fitted = TriangleMesh(points=instance_points(model, coeffs), cells=model.cells)
    if verbose:
        evaluate_reconstruction("SAMPLE", fitted, data.target)
    return coeffs, fitted, data


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Femur registration entry points")
    p.add_argument("mode", nargs="?", default="proposal",
                   choices=["proposal", "icp"],
                   help="proposal = MH ICP-proposal chain; icp = deterministic ICP")
    p.add_argument("--samples", type=int, default=10000)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--components", type=int, default=50)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--resume-log", type=str, default=None,
                   help="restart from a previous run's JSON chain log")
    p.add_argument("--resume-mode", choices=["best", "last"], default="best")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU; without it a GPU is required")
    p.add_argument("--setup", choices=sorted(SETUPS), default=None,
                   help="flagship = reference recipe, exact densities; "
                        "parity = reference recipe + reference density; "
                        "hybrid = exact-mode ICP+MALA+RW; rw/rw-adapt/mala "
                        "= fast-mixing exact samplers.  Default: "
                        f"{RECOMMENDED_SETUP!r} — best measured "
                        "ess_per_wall_second in an earlier quality run (the "
                        "reference's ICP recipe freezes after ~10k steps "
                        "under the exact density — docs/MIXING.md)")
    args = p.parse_args()
    from icp_proposal_tpu.utils.profiling import require_platform

    require_platform("cpu" if args.cpu else "gpu")
    if args.mode == "proposal":
        run_icp_proposal_registration(
            num_samples=args.samples,
            model_components=args.components,
            n_chains=args.chains,
            json_path=args.json,
            resume_log=args.resume_log,
            resume_mode=args.resume_mode,
            setup=args.setup,
        )
    else:
        run_deterministic_icp(
            num_iterations=args.iterations, model_components=args.components
        )
