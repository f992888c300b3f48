"""Cross-implementation posterior parity on a synthetic model.

VERDICT r2 item 2: the numpy ``PortSampler`` (scipy cKDTree + numpy port of
the reference hot loop — zero shared code with the JAX path) and the JAX
framework's parity-mode MH chain must sample the same posterior when
configured for the identical density.  A bug shared by the JAX
correspondence kernels, factor assembly, or transition densities would show
up here as a moment mismatch.  (The full femur study is
``tools/crossimpl_parity.py``.)
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask
from icp_proposal_tpu.models import gpmm as gp
from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
from icp_proposal_tpu.sampling import mh
from icp_proposal_tpu.sampling.context import build_target_context
from icp_proposal_tpu.sampling.evaluators import proximity_and_independent
from icp_proposal_tpu.sampling.proposals import (
    MixtureProgram,
    mixed_proposal_icp,
    mixed_random_shape_proposal,
    nest,
)
from icp_proposal_tpu.sampling.state import init_state


def test_port_sampler_matches_jax_parity_chain():
    from tools.reference_baseline_port import PortSampler

    points, cells = make_icosphere(subdivisions=1, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=4, sigma=40.0, scale=4.0)
    alpha_true = jnp.asarray([1.0, -0.5, 0.25, 0.0], jnp.float32)
    target = TriangleMesh(
        points=gp.instance_points(model, alpha_true), cells=model.cells
    )
    model_boundary = boundary_vertex_mask(np.asarray(model.cells), model.num_points)
    target_boundary = boundary_vertex_mask(
        np.asarray(target.cells), target.num_points
    )
    assert not model_boundary.any()  # closed sphere: no boundary semantics here

    ctx = build_target_context(target)
    mixture = MixtureProgram(
        nest(
            (0.9, mixed_proposal_icp(n_points=12)),
            (0.1, mixed_random_shape_proposal()),
        ),
        model, ctx, jnp.asarray(model_boundary), parity=True,
    )
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=1.0, n_points=16
    )

    # port with the FRAMEWORK's id subsets (read off the built objects)
    comps = {mixture.icp_components[i].spec.direction: mixture.icp_components[i]
             for i in sorted(mixture.icp_components)}
    port = PortSampler(
        model,
        np.asarray(target.points), np.asarray(target.cells),
        target_boundary, model_boundary,
        icp_model_ids=np.asarray(comps["model"].model_ids),
        icp_target_ids=np.asarray(comps["target"].target_ids),
        eval_ids=np.asarray(evaluator._model_ids["distance"]),
        sigma_n=5.0, sigma_t=10.0, step_len=0.1, sigma_eval=1.0,
        weights=(0.45, 0.45, 0.1), rw_sigma=0.1,
    )

    # --- port chains (independent numpy implementation) --------------------
    port_means = []
    port_vars = []
    for i, seed in enumerate((101, 202, 303)):
        trace, acc, _ = port.run(3000, seed=seed, record_from=500, record_every=5)
        assert 0.05 < acc < 0.95
        port_means.append(trace.mean(axis=0))
        port_vars.append(trace.var(axis=0, ddof=1))
    port_means = np.stack(port_means)
    port_vars = np.stack(port_vars)

    # --- JAX parity chains --------------------------------------------------
    n_chains, n_steps, burn = 16, 1500, 300
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry0 = jax.jit(lambda s: mh.init_carry(model, evaluator, s, mixture))(
        init_state(model)
    )
    carries = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), carry0
    )
    keys = jax.random.split(jax.random.PRNGKey(42), n_chains)
    final, records = mh.run_chains(step, carries, keys, n_steps)
    # ChainRecord.coeffs is the post-step chain-state trace (round 4)
    states = np.asarray(records.coeffs)
    acc = np.asarray(records.accepted)
    assert 0.05 < acc.mean() < 0.95
    jax_means = np.stack([
        states[c][burn::5].mean(axis=0) for c in range(n_chains)
    ])
    jax_vars = np.stack([
        states[c][burn::5].var(axis=0, ddof=1) for c in range(n_chains)
    ])

    # --- moments agree within MC error --------------------------------------
    m_port, m_jax = port_means.mean(0), jax_means.mean(0)
    se_port = port_means.std(0, ddof=1) / np.sqrt(len(port_means))
    se_jax = jax_means.std(0, ddof=1) / np.sqrt(len(jax_means))
    z = (m_port - m_jax) / np.sqrt(se_port**2 + se_jax**2 + 1e-30)
    assert np.max(np.abs(z)) < 4.0, (
        f"cross-impl posterior means differ: z={z}, port={m_port}, jax={m_jax}"
    )
    sd_ratio = np.sqrt(port_vars.mean(0) / np.maximum(jax_vars.mean(0), 1e-30))
    assert np.all((sd_ratio > 0.6) & (sd_ratio < 1.7)), (
        f"cross-impl posterior widths differ: sd_ratio={sd_ratio}"
    )


def test_port_geometry_code_is_independent_but_agrees():
    """VERDICT r3 item 5: the port computes its own seeded id subsets and
    boundary masks.  This cross-checks the two independent implementations
    against each other on real inputs — a bug in either one now FAILS here
    (and would desynchronize the parity densities) instead of being
    silently shared."""
    from icp_proposal_tpu.mesh import boundary_vertex_mask
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu.ops.surface_sampling import seeded_vertex_subset
    from tools.reference_baseline_port import (
        port_boundary_mask,
        port_vertex_subset,
    )

    for v, n, seed in [(1622, 100, 1024), (1622, 408, 1024), (50, 12, 1025)]:
        np.testing.assert_array_equal(
            port_vertex_subset(v, n, seed), seeded_vertex_subset(v, n, seed)
        )

    # closed surface: no boundary anywhere
    pts, cells = make_icosphere(subdivisions=2, radius=10.0)
    m_port = port_boundary_mask(np.asarray(cells), len(pts))
    m_fw = boundary_vertex_mask(np.asarray(cells), len(pts))
    np.testing.assert_array_equal(m_port, m_fw)
    assert not m_port.any()

    # open surface: cut away faces touching the first 20 vertices
    cells_np = np.asarray(cells)
    keep = ~np.any(cells_np < 20, axis=1)
    open_cells = cells_np[keep]
    m_port = port_boundary_mask(open_cells, len(pts))
    m_fw = boundary_vertex_mask(open_cells, len(pts))
    np.testing.assert_array_equal(m_port, m_fw)
    assert m_port.any()
