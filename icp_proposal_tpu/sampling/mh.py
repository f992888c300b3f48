"""The Metropolis–Hastings engine.

Replacement for scalismo's ``MetropolisHastings`` +
``SamplingRegistration`` driver loop (reference
``api/sampling/SamplingRegistration.scala:37-94``; L2 hot loop mapped in
SURVEY §3.1): one jit-compiled step as a pure function
``(carry, key) -> (carry, record)``, ``lax.scan`` over steps, ``vmap`` over
chains, sharding over a device mesh in ``parallel/``.

Asymmetric MH correction: accept iff
    log u < [log p(θ') − log p(θ)] + [log q(θ|θ') − log q(θ'|θ)]
with the mixture transition densities of ``MixtureProgram`` (forward factors
anchored at the current state, reverse factors anchored at the candidate —
the reference needs its posterior LRU exactly for this reverse anchor,
``NonRigidIcpProposal.scala:76``; we compute it densely instead).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from icp_proposal_tpu.mesh import vertex_face_adjacency, vertex_normals_gather
from icp_proposal_tpu.sampling.evaluators import (
    EvaluatorProgram,
    IndependentPointsSpec,
)
from icp_proposal_tpu.sampling.proposals import IcpComponent, MixtureProgram
from icp_proposal_tpu.sampling.state import FitState, transformed_points

# Matmul precision of the MH step and its initial carry.  The posterior
# assembly feeds a Cholesky and the exact transition density, the decode and
# projection feed every likelihood: full float32, never TF32.
MATMUL_PRECISION = "highest"


class _FusionPlan(NamedTuple):
    """Static plan for the fused target-surface query pass.

    The largest per-step work is the closest-point queries against the
    (static) target surface: the model-direction ICP correspondence
    (2·rank queries at the candidate anchor) and the Euclidean evaluator
    (4·rank queries at the same candidate).
    When the ICP ids are a SUBSET of the evaluator ids (the fused setups
    arrange this; any seeded subset is an equally valid configuration,
    SURVEY §7 quirk (a)), ONE ``closest_auto`` pass serves both: the
    evaluator consumes d2 of all rows, the ICP factors consume (cp, fidx)
    of its rows — identical values to the separate calls
    (``index_distances`` is ``index_closest`` minus cp).
    """

    eval_ids: object  # np [P] model vertex ids, queried once per step
    spec_name: str  # evaluator spec consuming the d2
    icp_maps: dict  # component idx -> np positions into the query rows


def _fusion_plan(mixture: MixtureProgram, evaluator: EvaluatorProgram):
    """Build the fused-query plan, or None when the configuration doesn't
    allow sharing (different contexts, no m2t Euclidean spec, or ICP ids
    not a subset of the evaluator ids)."""
    if evaluator.ctx is not mixture.ctx:
        return None
    spec = next(
        (s for s in evaluator.specs
         if isinstance(s, IndependentPointsSpec)
         and s.mode in ("model_to_target", "symmetric")),
        None,
    )
    if spec is None:
        return None
    eval_ids = np.asarray(evaluator._model_ids[spec.name])
    pos = {int(v): i for i, v in enumerate(eval_ids)}
    icp_maps = {}
    for i, comp in mixture.icp_components.items():
        if isinstance(comp, IcpComponent) and comp.spec.direction == "model":
            ids = np.asarray(comp.model_ids)
            if all(int(v) in pos for v in ids):
                icp_maps[i] = np.asarray([pos[int(v)] for v in ids])
    if not icp_maps:
        return None
    return _FusionPlan(eval_ids=eval_ids, spec_name=spec.name,
                       icp_maps=icp_maps)


class MhCarry(NamedTuple):
    state: FitState
    log_post: jax.Array  # [] cached product-evaluator value
    named: jax.Array  # [k] cached named evaluator values
    # GP-posterior factors anchored at the CURRENT state, one per ICP mixture
    # component (ordered tuple).  Invariant: these always equal
    # anchor_factors(state).  On accept the candidate's factors roll in, on
    # reject the previous ones persist — so each step computes factors only
    # at the candidate (the reference pays its LRU cache for the same
    # saving, ``NonRigidIcpProposal.scala:49``).
    icp_factors: tuple = ()
    # diminishing scale adaptation (AdaptConfig; no-op when disabled)
    adapt_log_scales: Optional[jax.Array] = None  # [C]
    step_idx: Optional[jax.Array] = None  # []


class ChainRecord(NamedTuple):
    """Per-step record (stacked by scan → the chain trace).

    Mirrors the reference's JSON accept/reject record content
    (``JSONAcceptRejectLogger.scala:35,93-106``): candidate evaluator values,
    proposal identity, accept status — plus optional parameters for
    replay/posterior analysis and convergence diagnostics.

    ``coeffs``/``pose`` hold the **post-step chain state** (the Markov-chain
    trace: candidate on accept, previous state on reject).  This loses
    nothing vs the reference's log — on accepted steps the post-step state
    IS the candidate, which is what the reference logs, and on rejected
    steps the reference logs empty parameter arrays
    (``JSONAcceptRejectLogger.scala:101-106``).  Crucially it means R-hat/ESS
    computed over these traces are MCMC diagnostics of the *held* state
    series, not of the ~iid candidate noise (VERDICT r3 item 1): at low
    acceptance the candidate series decorrelates instantly and its ESS is
    meaninglessly high.
    """

    accepted: jax.Array  # [] bool
    proposal_idx: jax.Array  # [] int32
    log_product: jax.Array  # [] candidate product value
    named: jax.Array  # [k] candidate named evaluator values
    coeffs: Optional[jax.Array] = None  # [r] post-step state coeffs (if stored)
    pose: Optional[jax.Array] = None  # [9] post-step trans+rot+center (if stored)


def make_mh_step(gpmm, mixture: MixtureProgram, evaluator: EvaluatorProgram,
                 store_params: bool = False, fuse: bool = True):
    """Build the jitted MH step function for a fixed configuration.

    fuse=True shares one target-surface closest-point pass between the
    model-direction ICP correspondence and the Euclidean evaluator when the
    configuration allows it (``_fusion_plan``); numerically identical to
    the separate passes (asserted by ``test_fused_step_matches_unfused``).
    """

    # gradient-informed components differentiate the target density itself
    mixture.bind_target(evaluator)
    plan = _fusion_plan(mixture, evaluator) if fuse else None
    needs_normals = mixture.needs_normals()
    # static vertex→face adjacency: turns per-step normal accumulation into
    # gathers instead of scatter-adds
    adjacency = (
        np.asarray(vertex_face_adjacency(gpmm.cells, gpmm.num_points))
        if needs_normals
        else None
    )

    def normals_of(points):
        return vertex_normals_gather(points, gpmm.cells, adjacency)

    icp_idx = sorted(mixture.icp_components)

    def step(carry: MhCarry, key) -> tuple[MhCarry, ChainRecord]:
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return _step(carry, key)

    def _step(carry: MhCarry, key) -> tuple[MhCarry, ChainRecord]:
        state = carry.state
        k_prop, k_sel, k_acc = jax.random.split(key, 3)

        # ---- forward-anchor factors come from the carry (invariant: they
        # equal anchor_factors(state)); no current-state decode needed -------
        factors_cur = dict(zip(icp_idx, carry.icp_factors))
        scales = (
            jnp.exp(carry.adapt_log_scales) if mixture.adapt is not None else None
        )

        # ---- dense candidate generation + categorical selection ------------
        candidates = mixture.propose_all(k_prop, state, factors_cur, scales)
        idx = jax.random.categorical(k_sel, jnp.asarray(mixture.log_weights))
        cand_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *candidates)
        cand: FitState = jax.tree.map(lambda x: x[idx], cand_stack)

        # ---- reverse anchor + densities -----------------------------------
        cand_pts = transformed_points(gpmm, cand)
        cand_normals = (
            normals_of(cand_pts) if needs_normals else None
        )
        shared_icp = shared_eval = None
        if plan is not None:
            # fused query pass: one closest_auto over the evaluator ids
            # serves the ICP correspondences (subset rows) AND the
            # Euclidean likelihood (all rows) — see _FusionPlan
            from icp_proposal_tpu.ops.surface_index import closest_auto

            q = cand_pts[jnp.asarray(plan.eval_ids)]
            cp_all, d2_all, fidx_all = closest_auto(
                q, mixture.ctx.tri, mixture.ctx.index
            )
            shared_icp = {
                i: (cp_all[jnp.asarray(m)], fidx_all[jnp.asarray(m)])
                for i, m in plan.icp_maps.items()
            }
            shared_eval = {plan.spec_name: d2_all}
        factors_cand = mixture.anchor_factors(
            cand, cand_pts, cand_normals, shared_icp
        )

        log_q_fwd = mixture.log_q_mixture(state, cand, factors_cur, scales)
        log_q_rev = mixture.log_q_mixture(cand, state, factors_cand, scales)

        # ---- evaluate candidate posterior ---------------------------------
        log_post_cand, named_cand = evaluator(cand, cand_pts, shared_eval)

        log_alpha = (log_post_cand - carry.log_post) + (log_q_rev - log_q_fwd)
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha

        new_state: FitState = jax.tree.map(
            lambda c, s: jnp.where(accept, c, s), cand, state
        )
        new_factors = tuple(
            jax.tree.map(
                lambda fc, fp: jnp.where(accept, fc, fp),
                factors_cand[i],
                factors_cur[i],
            )
            for i in icp_idx
        )
        if mixture.adapt is not None:
            new_log_scales = mixture.update_scales(
                carry.adapt_log_scales, carry.step_idx, idx, log_alpha
            )
            new_step_idx = carry.step_idx + 1
        else:
            new_log_scales = carry.adapt_log_scales
            new_step_idx = carry.step_idx
        new_carry = MhCarry(
            state=new_state,
            log_post=jnp.where(accept, log_post_cand, carry.log_post),
            named=jnp.where(accept, named_cand, carry.named),
            icp_factors=new_factors,
            adapt_log_scales=new_log_scales,
            step_idx=new_step_idx,
        )
        record = ChainRecord(
            accepted=accept,
            proposal_idx=idx.astype(jnp.int32),
            log_product=log_post_cand,
            named=named_cand,
            # post-step state, NOT the candidate — see ChainRecord docstring
            coeffs=new_state.coeffs if store_params else None,
            pose=(
                jnp.concatenate(
                    [new_state.trans, new_state.rot, new_state.center]
                )
                if store_params
                else None
            ),
        )
        return new_carry, record

    return step


def init_carry(gpmm, evaluator: EvaluatorProgram, state: FitState,
               mixture: Optional[MixtureProgram] = None) -> MhCarry:
    """Build the initial carry: evaluator values + (if the mixture has ICP
    components) the GP-posterior factors anchored at the initial state."""
    with jax.default_matmul_precision(MATMUL_PRECISION):
        return _init_carry(gpmm, evaluator, state, mixture)


def _init_carry(gpmm, evaluator, state, mixture):
    pts = transformed_points(gpmm, state)
    log_post, named = evaluator(state, pts)
    factors = ()
    if mixture is not None and mixture.icp_components:
        mixture.bind_target(evaluator)
        normals = None
        if mixture.needs_normals():
            normals = vertex_normals_gather(
                pts, gpmm.cells,
                np.asarray(vertex_face_adjacency(gpmm.cells, gpmm.num_points)),
            )
        fac = mixture.anchor_factors(state, pts, normals)
        factors = tuple(fac[i] for i in sorted(fac))
    adapt_log_scales = None
    step_idx = None
    if mixture is not None and mixture.adapt is not None:
        adapt_log_scales = jnp.zeros(mixture.num_components, jnp.float32)
        step_idx = jnp.asarray(0.0, jnp.float32)
    return MhCarry(state=state, log_post=log_post, named=named,
                   icp_factors=factors, adapt_log_scales=adapt_log_scales,
                   step_idx=step_idx)


@partial(jax.jit, static_argnames=("step", "n_steps"))
def run_chain(step, carry: MhCarry, key, n_steps: int):
    """Run one chain for n_steps. → (final carry, stacked ChainRecord)."""
    keys = jax.random.split(key, n_steps)
    return jax.lax.scan(step, carry, keys)


_RUN_CHAINS_CACHE: dict = {}


def run_chains(step, carries: MhCarry, keys, n_steps: int):
    """vmap over a batch of chains (leading axis of carries/keys).

    This is the reference's only parallelism (``.par`` multi-chain loops,
    ``RunMHRandomInitComparison.scala:66-86``) mapped to a batch
    dimension.  The jitted runner is cached per (step, n_steps) so segmented
    drivers don't re-trace/re-compile every segment.
    """
    cache_key = (step, n_steps)
    runner = _RUN_CHAINS_CACHE.get(cache_key)
    if runner is None:
        runner = jax.jit(
            jax.vmap(lambda c, k: run_chain(step, c, k, n_steps))
        )
        _RUN_CHAINS_CACHE[cache_key] = runner
    return runner(carries, keys)


def stack_states(states):
    """Stack a list of FitStates into a batched FitState."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)
