"""Femur experiment harnesses.

TPU-native redesigns of the reference's comparison drivers:
  * ``RunMHRandomInitComparison.scala:34-89`` — N random inits, ICP-proposal
    chain vs random-walk chain;
  * ``StdIcpVsChainICPrandomInitComparisonAll.scala:40-166`` — the paper
    harness: per target × per random init, deterministic ICP + MH(Euclidean)
    + MH(Hausdorff), all results into the experiment JSON log.

Where the reference fans out with ``.par`` ForkJoinPools and paired Futures
(SURVEY §5.8), the inits here are the *batch axis*: all inits of a method run
as one vmapped chain batch in a single device program (and shard over a mesh
via ``parallel.runner`` at pod scale).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from icp_proposal_tpu.mesh import TriangleMesh
from icp_proposal_tpu.models import gpmm as gp
from icp_proposal_tpu.ops.metrics import avg_distance, dice_coefficient, hausdorff_distance
from icp_proposal_tpu.sampling import mh
from icp_proposal_tpu.sampling.context import build_target_context
from icp_proposal_tpu.sampling.evaluators import (
    proximity_and_hausdorff,
    proximity_and_independent,
)
from icp_proposal_tpu.sampling.proposals import (
    MixtureProgram,
    mixed_proposal_icp,
    mixed_random_shape_proposal,
    nest,
)
from icp_proposal_tpu.sampling.state import FitState, init_state, transformed_mesh


def generate_model_samples(model, n: int, out_dir: str, variance: float = 0.1,
                           seed: int = 1024):
    """Write n random model-instance meshes to ``out_dir/{i}.stl`` — the
    ``modelsamples`` assets that ``RunMHRandomInitComparison.scala:71-72``
    reads for its random initializations (index 0 = mean shape)."""
    import os

    from icp_proposal_tpu.io.stl import write_stl
    from icp_proposal_tpu.models.gpmm import instance_points

    os.makedirs(out_dir, exist_ok=True)
    key = jax.random.PRNGKey(seed)
    cells = np.asarray(model.cells)
    for i in range(n):
        coeffs = initialise_shape_parameters(model.rank, i, key, variance)
        pts = np.asarray(instance_points(model, coeffs))
        write_stl(os.path.join(out_dir, f"{i}.stl"), pts, cells)
    return out_dir


def initialise_shape_parameters(rank: int, index: int, key, variance: float = 0.1):
    """Random init coefficients: index 0 → zeros, else ~ N(0, variance·I)
    (reference ``RandomSamplesFromModel.scala:28-36``)."""
    if index == 0:
        return jnp.zeros((rank,), jnp.float32)
    return jnp.sqrt(variance) * jax.random.normal(
        jax.random.fold_in(key, index), (rank,), jnp.float32
    )


def _batched_init_states(model, n_inits: int, key, variance: float = 0.1) -> FitState:
    """All inits generated in ONE jitted call (no python loop of eager RNG
    draws)."""
    base = init_state(model)

    @jax.jit
    def gen(k):
        def one(i):
            coeffs = jnp.sqrt(variance) * jax.random.normal(
                jax.random.fold_in(k, i), (model.rank,), jnp.float32
            )
            return jnp.where(i == 0, jnp.zeros(model.rank, jnp.float32), coeffs)

        return jax.vmap(one)(jnp.arange(n_inits))

    coeffs = gen(key)
    return FitState(
        scale=jnp.broadcast_to(jnp.asarray(base.scale), (n_inits,)),
        rot=jnp.broadcast_to(jnp.asarray(base.rot), (n_inits, 3)),
        trans=jnp.broadcast_to(jnp.asarray(base.trans), (n_inits, 3)),
        center=jnp.broadcast_to(jnp.asarray(base.center), (n_inits, 3)),
        coeffs=coeffs,
    )


def _run_batch(model, mixture, evaluator, init_states: FitState, n_steps: int, key):
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    carries = jax.jit(jax.vmap(lambda s: mh.init_carry(model, evaluator, s, mixture)))(init_states)
    n = init_states.coeffs.shape[0]
    keys = jax.random.split(key, n)
    final, records = mh.run_chains(step, carries, keys, n_steps)
    return jax.tree.map(np.asarray, records)


def _best_states_per_chain(records, center) -> List[FitState]:
    acc = records.accepted  # [C, T]
    logv = np.where(acc, records.log_product, -np.inf)
    out = []
    for c in range(acc.shape[0]):
        t = int(np.argmax(logv[c]))
        pose = records.pose[c, t]
        out.append(
            FitState(
                scale=jnp.asarray(1.0, jnp.float32),
                trans=jnp.asarray(pose[0:3], jnp.float32),
                rot=jnp.asarray(pose[3:6], jnp.float32),
                center=jnp.asarray(pose[6:9], jnp.float32),
                coeffs=jnp.asarray(records.coeffs[c, t]),
            )
        )
    return out


def run_random_init_comparison(
    model,
    target: TriangleMesh,
    model_boundary,
    target_boundary,
    n_inits: int = 5,
    n_icp_samples: int = 1000,
    rnd_multiplier: int = 5,
    n_icp_points: Optional[int] = None,
    n_eval_points: Optional[int] = None,
    seed: int = 1024,
    verbose: bool = True,
):
    """ICP-proposal chains vs random-walk chains from N random inits
    (reference ``RunMHRandomInitComparison``: ICP 1,000 samples, RND 5,000,
    ModelSampling ICP, symmetric Euclidean evaluator, full-resolution point
    counts)."""
    ctx = build_target_context(target, target_boundary)
    n_icp_points = n_icp_points or model.num_points
    n_eval_points = n_eval_points or model.num_points

    evaluator = proximity_and_independent(
        model, ctx, mode="symmetric", sigma=2.0, n_points=n_eval_points
    )
    mix_icp = MixtureProgram(
        mixed_proposal_icp(n_points=n_icp_points, projection_direction="model"),
        model, ctx, model_boundary,
    )
    mix_rnd = MixtureProgram(
        mixed_random_shape_proposal((0.1, 0.01, 0.001)),
        model, ctx, model_boundary,
    )

    key = jax.random.PRNGKey(seed)
    inits = _batched_init_states(model, n_inits, jax.random.fold_in(key, 0))

    rec_icp = _run_batch(model, mix_icp, evaluator, inits, n_icp_samples,
                         jax.random.fold_in(key, 1))
    rec_rnd = _run_batch(model, mix_rnd, evaluator, inits,
                         n_icp_samples * rnd_multiplier, jax.random.fold_in(key, 2))

    center = np.asarray(inits.center[0])
    results = []
    for tag, recs in (("icp", rec_icp), ("rnd", rec_rnd)):
        for i, best in enumerate(_best_states_per_chain(recs, center)):
            mesh = transformed_mesh(model, best)
            results.append(
                {
                    "method": tag,
                    "init": i,
                    "avg": float(avg_distance(mesh, target)),
                    "hausdorff": float(hausdorff_distance(mesh, target)),
                    "best_coeffs": np.asarray(best.coeffs),
                }
            )
            if verbose:
                r = results[-1]
                print(f"{tag} init={i} avg={r['avg']:.3f} hausdorff={r['hausdorff']:.3f}")
    return results


def run_std_icp_vs_chain_comparison(
    model,
    targets: Sequence[TriangleMesh],
    target_paths: Sequence[str],
    model_boundary,
    experiment_path: str,
    model_path: str = "",
    n_inits: int = 100,
    n_samples: int = 1000,
    normal_noise: float = 5.0,
    seed: int = 1024,
    verbose: bool = True,
    compute_dice: bool = True,
):
    """The paper harness (``StdIcpVsChainICPrandomInitComparisonAll``):
    per target, run all inits as chain batches for (a) deterministic ICP,
    (b) MH with Euclidean evaluator, (c) MH with Hausdorff evaluator; append
    avg/hausdorff/dice + best coefficients per run to the experiment log."""
    from icp_proposal_tpu.io.experiment_log import ExperimentLogger
    from icp_proposal_tpu.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )
    from icp_proposal_tpu.registration.icp_fitting import icp_surface_fitting

    logger = ExperimentLogger(experiment_path, model_path)
    key = jax.random.PRNGKey(seed)
    n_eval = model.num_points // 2
    n_icp_pts = model.rank * 2

    for t_idx, (target, tpath) in enumerate(zip(targets, target_paths)):
        ctx = build_target_context(target)
        tkey = jax.random.fold_in(key, t_idx)

        eval_euclid = proximity_and_independent(
            model, ctx, mode="model_to_target", sigma=2.0, n_points=n_eval
        )
        eval_hausdorff = proximity_and_hausdorff(model, ctx, rate=100.0)
        mixture = MixtureProgram(
            nest(
                (0.9, mixed_proposal_icp(
                    n_points=n_icp_pts, projection_direction="model_and_target",
                    tangential_noise=10.0, noise_along_normal=normal_noise,
                    step_length=0.1,
                )),
                (0.1, mixed_random_shape_proposal()),
            ),
            model, ctx, model_boundary,
        )

        inits = _batched_init_states(model, n_inits, jax.random.fold_in(tkey, 0))

        # (a) deterministic ICP, batched over inits via vmap
        model_ids = jnp.asarray(
            seeded_vertex_subset(model.num_points, model.num_points, seed=seed)
        )
        target_pts = sample_points_on_surface(
            jax.random.fold_in(tkey, 1), target, model.num_points
        )
        icp_fit = jax.jit(
            jax.vmap(
                lambda c0, k: icp_surface_fitting(
                    model, ctx, model_ids, target_pts,
                    num_iterations=100, sigma_seq=(1e-15,),
                    projection_direction="model_and_target",
                    initial_coeffs=c0, key=k,
                )
            )
        )
        icp_coeffs = np.asarray(
            icp_fit(inits.coeffs, jax.random.split(jax.random.fold_in(tkey, 2), n_inits))
        )

        # (b)/(c) MH chains, batched over inits
        rec_e = _run_batch(model, mixture, eval_euclid, inits, n_samples,
                           jax.random.fold_in(tkey, 3))
        rec_h = _run_batch(model, mixture, eval_hausdorff, inits, n_samples,
                           jax.random.fold_in(tkey, 4))
        best_e = _best_states_per_chain(rec_e, None)
        best_h = _best_states_per_chain(rec_h, None)

        def dist_measure(mesh, dice_key):
            out = {
                "avg": float(avg_distance(mesh, target)),
                "hausdorff": float(hausdorff_distance(mesh, target)),
            }
            out["dice"] = (
                float(dice_coefficient(mesh, target, key=dice_key))
                if compute_dice
                else float("nan")
            )
            return out

        for i in range(n_inits):
            icp_state = init_state(model, coeffs=jnp.asarray(icp_coeffs[i]))
            mesh_icp = transformed_mesh(model, icp_state)
            mesh_e = transformed_mesh(model, best_e[i])
            mesh_h = transformed_mesh(model, best_h[i])
            dkey = jax.random.fold_in(tkey, 1000 + i)
            logger.append(
                index=i,
                target_path=str(tpath),
                coeff_init=np.asarray(inits.coeffs[i]),
                coeff_sampling_euclidean=np.asarray(best_e[i].coeffs),
                coeff_sampling_hausdorff=np.asarray(best_h[i].coeffs),
                coeff_icp=icp_coeffs[i],
                sampling_euclidean=dist_measure(mesh_e, dkey),
                sampling_hausdorff=dist_measure(mesh_h, dkey),
                icp=dist_measure(mesh_icp, dkey),
                num_of_evaluation_points=n_eval,
                num_of_sample_points=n_samples,
                normal_noise=normal_noise,
            )
            if verbose:
                e = logger.experiments[-1]
                print(
                    f"target={t_idx} init={i} "
                    f"icp_avg={e['icp']['avg']:.3f} "
                    f"euclid_avg={e['samplingEuclidean']['avg']:.3f} "
                    f"hausdorff_avg={e['samplingHausdorff']['avg']:.3f}"
                )
        logger.write_log()
    return logger
