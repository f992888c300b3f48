"""BFM face workload: data prep, partial-target synthesis, fitting configs.

Equivalents of the reference ``apps/bfm`` package: ``AlignShapes.scala``
(scaling + rigid landmark alignment + partial-target synthesis),
``LoadTestData.scala``, ``BfmFittingComplete.scala``, ``BfmFittingPartial.scala``.

The BFM-2017 model and scan assets are license-gated downloads and absent
from the reference repo (SURVEY §7 hard part 7, reference README.md:57-72).
All pipelines here run on real assets from a directory passed to
``load_bfm_data``; otherwise a synthetic stand-in face (open-patch mesh +
FaceKernel-built GPMM) exercises the identical code path.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
from icp_proposal_tpu.models.gpmm import Gpmm


# ---------------------------------------------------------------------------
# data prep (reference AlignShapes.scala)
# ---------------------------------------------------------------------------

def synthesize_partial_target(
    points: np.ndarray,
    cells: np.ndarray,
    cut_center: np.ndarray,
    n_cut: int = 1000,
    extra_cut_ids=(),
):
    """Partial-target synthesis (reference ``bfm/AlignShapes.scala:88-94``):
    remove the n_cut vertices nearest ``cut_center`` (the nose tip) plus an
    explicit id mask (the mouth), then drop dangling faces.

    → (partial_points, partial_cells, kept_ids).
    """
    points = np.asarray(points)
    cells = np.asarray(cells)
    d2 = np.sum((points - np.asarray(cut_center)[None, :]) ** 2, axis=1)
    cut = set(np.argsort(d2)[: min(n_cut, len(points))].tolist())
    cut.update(int(i) for i in extra_cut_ids if i < len(points))
    keep_vertex = np.array([i not in cut for i in range(len(points))])
    keep_face = keep_vertex[cells].all(axis=1)
    new_cells_full = cells[keep_face]
    used = np.unique(new_cells_full)
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return points[used], remap[new_cells_full].astype(np.int32), used


def align_scan(scan_points, scan_landmarks: Dict[str, np.ndarray],
               model_landmarks: Dict[str, np.ndarray], scale: float = 1e-3):
    """Scale (reference scales BFM scans by 1/1000, ``AlignShapes.scala:66``)
    then rigidly align to the model landmarks."""
    from icp_proposal_tpu.io.landmarks import common_landmarks
    from icp_proposal_tpu.ops.rigid import rigid_landmark_alignment

    pts = np.asarray(scan_points, np.float64) * scale
    lms = {k: np.asarray(v, np.float64) * scale for k, v in scan_landmarks.items()}
    src, dst, _ = common_landmarks(lms, model_landmarks)
    t = rigid_landmark_alignment(src, dst, center=np.zeros(3))
    aligned = np.asarray(t.apply(pts.astype(np.float32)))
    aligned_lms = {k: np.asarray(t.apply(v[None, :].astype(np.float32)))[0] for k, v in lms.items()}
    return aligned, aligned_lms


def prepare_bfm_dataset(
    scans_dir: str,
    landmarks_dir: str,
    model_landmarks_path: str,
    out_dir: str,
    nose_landmark: str = "center.nose.tip",
    n_nose_cut: int = 1000,
    mouth_mask_ids=(),
    verbose: bool = True,
) -> int:
    """Full BFM data prep (reference ``bfm/AlignShapes.scala:55-101``):
    for every scan — scale by 1/1000, rigidly align to the model landmarks,
    write ``aligned/``; synthesize the partial variant by cutting the 1000
    vertices nearest the nose tip plus the mouth id mask, write ``partial/``.
    """
    from icp_proposal_tpu.io.landmarks import read_landmarks, write_landmarks
    from icp_proposal_tpu.io.ply import read_ply
    from icp_proposal_tpu.io.stl import read_stl, write_stl

    model_lms = read_landmarks(model_landmarks_path)
    for sub in ("aligned/meshes", "aligned/landmarks", "partial/meshes",
                "partial/landmarks"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    count = 0
    for fname in sorted(os.listdir(scans_dir)):
        base, ext = os.path.splitext(fname)
        if ext.lower() not in (".ply", ".stl"):
            continue
        lm_path = os.path.join(landmarks_dir, base + ".json")
        if not os.path.exists(lm_path):
            if verbose:
                print(f"skipping {fname}: no landmarks")
            continue
        reader = read_ply if ext.lower() == ".ply" else read_stl
        points, cells = reader(os.path.join(scans_dir, fname))
        lms = read_landmarks(lm_path)
        aligned, aligned_lms = align_scan(points, lms, model_lms, scale=1e-3)
        write_stl(os.path.join(out_dir, "aligned/meshes", base + ".stl"),
                  aligned, cells)
        write_landmarks(os.path.join(out_dir, "aligned/landmarks", base + ".json"),
                        aligned_lms)

        if nose_landmark in aligned_lms:
            p_pts, p_cells, _ = synthesize_partial_target(
                aligned, cells, aligned_lms[nose_landmark],
                n_cut=n_nose_cut, extra_cut_ids=mouth_mask_ids,
            )
            partial_lms = {k: v for k, v in aligned_lms.items() if k != nose_landmark}
            write_stl(os.path.join(out_dir, "partial/meshes", base + ".stl"),
                      p_pts, p_cells)
            write_landmarks(
                os.path.join(out_dir, "partial/landmarks", base + ".json"),
                partial_lms,
            )
        count += 1
        if verbose:
            print(f"prepared {fname}")
    return count


def load_bfm_data(data_dir: str, target_index: int = 0,
                  model_file: str = "faceGPmodel_200c.h5") -> "BfmData":
    """Load real BFM assets when present (reference ``bfm/LoadTestData``:
    face GPMM + aligned and partial target meshes by index).  Raises
    FileNotFoundError when the license-gated assets are absent — callers fall
    back to ``load_synthetic_face_data``."""
    from icp_proposal_tpu.io.statismo import read_statismo_gpmm
    from icp_proposal_tpu.io.stl import read_stl

    model_path = os.path.join(data_dir, model_file)
    aligned_dir = os.path.join(data_dir, "aligned", "meshes")
    partial_dir = os.path.join(data_dir, "partial", "meshes")
    if not (os.path.exists(model_path) and os.path.isdir(aligned_dir)):
        raise FileNotFoundError(
            f"BFM assets not found under {data_dir} (license-gated download; "
            "see reference README.md:57-72). Use load_synthetic_face_data()."
        )
    model = read_statismo_gpmm(model_path)
    targets = sorted(f for f in os.listdir(aligned_dir) if f.endswith(".stl"))
    tname = targets[target_index]
    t_pts, t_cells = read_stl(os.path.join(aligned_dir, tname))
    p_path = os.path.join(partial_dir, tname)
    if os.path.exists(p_path):
        p_pts, p_cells = read_stl(p_path)
    else:
        p_pts, p_cells = t_pts, t_cells
    return BfmData(
        model=model,
        target=make_mesh(t_pts, t_cells),
        target_partial=make_mesh(p_pts, p_cells),
        model_boundary_mask=boundary_vertex_mask(
            np.asarray(model.cells), model.num_points
        ),
        target_boundary_mask=boundary_vertex_mask(t_cells, len(t_pts)),
        partial_boundary_mask=boundary_vertex_mask(p_cells, len(p_pts)),
    )


# ---------------------------------------------------------------------------
# synthetic stand-in workload
# ---------------------------------------------------------------------------

@dataclass
class BfmData:
    model: Gpmm
    target: TriangleMesh  # complete target
    target_partial: TriangleMesh
    model_boundary_mask: np.ndarray
    target_boundary_mask: np.ndarray
    partial_boundary_mask: np.ndarray


def load_synthetic_face_data(rank: int = 24, subdiv: int = 3, seed: int = 0) -> BfmData:
    """Build a face-like stand-in: open-patch reference mesh, FaceKernel GPMM,
    a target drawn from the model, and a partial target with a synthesized
    occlusion (same pipeline as the real BFM prep)."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.models import gpmm as gp
    from icp_proposal_tpu.models.build_face import FaceMask, FaceKernel
    from icp_proposal_tpu.models.gpmm import make_gpmm
    from icp_proposal_tpu.models.nystrom import nystrom_lowrank
    from icp_proposal_tpu.models.synthetic import make_open_patch
    from icp_proposal_tpu.ops.surface_sampling import area_weighted_vertex_subset

    points, cells = make_open_patch(subdivisions=subdiv, radius=0.1, z_cut=0.55)
    mask = FaceMask.trivial(len(points))
    kernel = FaceKernel(mask, points)
    n_sample = min(4 * rank, len(points))
    sample_ids = area_weighted_vertex_subset(points, cells, n_sample, seed=seed + 1)
    basis, variance = nystrom_lowrank(
        kernel, np.asarray(points, np.float64)[sample_ids],
        np.asarray(points, np.float64), num_basis=rank,
    )
    model = make_gpmm(
        ref_points=points, cells=cells,
        mean_disp=np.zeros_like(points), basis=basis, variance=variance,
    )

    key = jax.random.PRNGKey(seed)
    alpha = jax.random.normal(key, (rank,)) * 0.8
    target_points = np.asarray(gp.instance_points(model, alpha))
    target = make_mesh(target_points, cells)

    # occlude around the "nose": the vertex with max z
    nose = target_points[np.argmax(target_points[:, 2])]
    p_pts, p_cells, _ = synthesize_partial_target(
        target_points, np.asarray(cells), nose, n_cut=len(points) // 6
    )
    partial = make_mesh(p_pts, p_cells)

    return BfmData(
        model=model,
        target=target,
        target_partial=partial,
        model_boundary_mask=boundary_vertex_mask(np.asarray(cells), len(points)),
        target_boundary_mask=boundary_vertex_mask(np.asarray(cells), len(points)),
        partial_boundary_mask=boundary_vertex_mask(np.asarray(p_cells), len(p_pts)),
    )


# ---------------------------------------------------------------------------
# fitting configurations (reference BfmFittingComplete/Partial)
# ---------------------------------------------------------------------------

def make_bfm_fitting_setup(data: BfmData, partial: bool, parity: bool = False):
    """Proposal/evaluator recipe shared by the two BFM fitting apps
    (reference ``BfmFittingComplete.scala:62-76`` /
    ``BfmFittingPartial.scala:65-83``):

      proposal  = 0.4·pose-mixture + 0.55·ICP(ModelSampling, tangential 6,
                  normal 3, step 0.1) + 0.05·random-shape
      evaluator = complete: Euclidean σ=3.0, ModelToTarget, 4·rank points
                  partial:  collective avg/max boundary-aware, Symmetric,
                            σ_avg=0.3, max rate 1.0, mean 0.1
    """
    import jax.numpy as jnp

    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import (
        proximity_and_collective_hausdorff_boundary_aware,
        proximity_and_independent,
    )
    from icp_proposal_tpu.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_pose_proposal,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    target = data.target_partial if partial else data.target
    tmask = data.partial_boundary_mask if partial else data.target_boundary_mask
    ctx = build_target_context(target, tmask)
    n_icp = 2 * model.rank
    n_eval = 2 * n_icp

    mixture = MixtureProgram(
        nest(
            (0.4, mixed_random_pose_proposal()),
            (0.55, mixed_proposal_icp(
                n_points=n_icp, projection_direction="model",
                tangential_noise=6.0, noise_along_normal=3.0, step_length=0.1,
            )),
            (0.05, mixed_random_shape_proposal()),
        ),
        model, ctx, np.asarray(data.model_boundary_mask), parity=parity,
    )
    if partial:
        evaluator = proximity_and_collective_hausdorff_boundary_aware(
            model, ctx, mode="symmetric", sigma_avg=0.3, rate_max=1.0,
            mean=0.1, n_points=n_eval,
        )
    else:
        evaluator = proximity_and_independent(
            model, ctx, mode="model_to_target", sigma=3.0, n_points=n_eval
        )
    return ctx, mixture, evaluator


def run_bfm_fitting(
    data: Optional[BfmData] = None,
    partial: bool = False,
    num_samples: int = 10000,
    n_chains: int = 1,
    json_path=None,
    seed: int = 1024,
    verbose: bool = True,
):
    """End-to-end BFM fitting (complete or partial), on real or synthetic
    data."""
    import jax

    from icp_proposal_tpu.registration.sampling_registration import SamplingRegistration

    if data is None:
        data = load_synthetic_face_data()
    target = data.target_partial if partial else data.target
    ctx, mixture, evaluator = make_bfm_fitting_setup(data, partial)
    reg = SamplingRegistration(
        data.model, target, mixture, evaluator, verbose=verbose
    )
    return reg.runfitting(
        num_samples, key=jax.random.PRNGKey(seed), n_chains=n_chains,
        json_path=json_path,
    ), data
