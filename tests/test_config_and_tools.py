"""Tests for the typed config system, alignment CLI tool, and pod runner."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask
from icp_proposal_tpu.models import gpmm as gp
from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def test_runconfig_roundtrip_and_build():
    from icp_proposal_tpu.utils.config import RunConfig, build_from_config

    cfg = RunConfig()
    cfg2 = RunConfig.from_json(cfg.to_json())
    assert cfg2 == cfg

    points, cells = make_icosphere(subdivisions=1, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=4)
    target = TriangleMesh(
        points=gp.instance_points(model, jnp.ones(4) * 0.3), cells=model.cells
    )
    mask = boundary_vertex_mask(np.asarray(cells), len(points))
    ctx, mixture, evaluator = build_from_config(cfg, model, target, mask, mask)
    # flagship recipe: 2 ICP components + 1 random shape
    assert len(mixture.specs) == 3
    assert abs(sum(mixture.weights) - 1.0) < 1e-9
    assert evaluator.named_keys == ["product", "prior", "distance"]

    # pose-enabled config
    cfg.pose.weight = 0.4
    _, mixture2, _ = build_from_config(cfg, model, target, mask, mask)
    assert len(mixture2.specs) == 9  # + 6 pose components


def test_align_shapes_tool(tmp_path):
    from icp_proposal_tpu.apps.align_shapes import align_shapes
    from icp_proposal_tpu.io.landmarks import read_landmarks, write_landmarks
    from icp_proposal_tpu.io.stl import read_stl, write_stl

    points, cells = make_icosphere(subdivisions=1, radius=10.0)
    lms = {"a": points[0].astype(np.float64), "b": points[10].astype(np.float64),
           "c": points[20].astype(np.float64), "d": points[30].astype(np.float64)}

    # a rotated/translated copy to align back
    theta = 0.5
    r = np.array(
        [[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0], [0, 0, 1]]
    )
    moved = points @ r.T + np.array([5.0, -2.0, 1.0], np.float32)
    moved_lms = {k: v @ r.T + np.array([5.0, -2.0, 1.0]) for k, v in lms.items()}

    mesh_dir = tmp_path / "meshes"
    lm_dir = tmp_path / "landmarks"
    os.makedirs(mesh_dir)
    os.makedirs(lm_dir)
    write_stl(mesh_dir / "scan0.stl", moved, cells)
    write_landmarks(lm_dir / "scan0.json", moved_lms)
    write_landmarks(tmp_path / "ref.json", lms)

    n = align_shapes(
        str(mesh_dir), str(lm_dir), str(tmp_path / "ref.json"),
        str(tmp_path / "aligned"), verbose=False,
    )
    assert n == 1
    aligned_pts, _ = read_stl(tmp_path / "aligned" / "meshes" / "scan0.stl")
    # welding may reorder vertices; compare sorted coordinate multisets
    np.testing.assert_allclose(
        np.sort(aligned_pts.ravel()), np.sort(points.ravel()), atol=1e-3
    )
    aligned_lms = read_landmarks(tmp_path / "aligned" / "landmarks" / "scan0.json")
    np.testing.assert_allclose(aligned_lms["a"], lms["a"], atol=1e-3)


def test_pod_chains_cli_tiny():
    """The pod runner executes end-to-end on the virtual 8-device CPU mesh."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import sys; sys.argv=['pod_chains','--chains','8','--steps','30','--components','50','--cpu'];"
         "from icp_proposal_tpu.apps.pod_chains import main; main()"],
        capture_output=True, text=True, timeout=500, env=env,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    stats = json.loads(last)
    assert stats["devices"] == 8
    assert stats["chains"] == 8
    assert 0.0 <= stats["pooled_acceptance"] <= 1.0
    assert np.isfinite(stats["rhat_max_first8"])


def test_reference_baseline_port_runs(tmp_path):
    """The measured single-core CPU baseline port executes and reports a
    plausible rate (it anchors bench.py's vs_baseline)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "tools/reference_baseline_port.py",
         "--components", "50", "--steps", "20",
         "--out", str(tmp_path / "cpu_baseline_test.json")],
        capture_output=True, text=True, timeout=500, env=env,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["value"] > 1.0  # sane single-core rate
    assert 0.0 <= res["acceptance"] <= 1.0
    assert res["threads"]["OMP_NUM_THREADS"] == "1"


def test_compilation_cache_dir(monkeypatch, tmp_path):
    """``JAX_COMPILATION_CACHE_DIR`` wins; otherwise ``.jax_cache`` at the
    checkout root, resolved from the package's location."""
    import jax

    from icp_proposal_tpu.utils.profiling import enable_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert enable_compilation_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert enable_compilation_cache() == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_pallas_imports_triton_only():
    """The package reaches Pallas only through its Triton (GPU) route: no
    module imports another Pallas backend."""
    import ast
    import pathlib

    pallas = "jax.experimental.pallas"
    offenders = []
    for path in (pathlib.Path(REPO) / "icp_proposal_tpu").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module == pallas:
                mods = [f"{pallas}.{a.name}" for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            offenders += [(str(path.relative_to(REPO)), m) for m in mods
                          if m.startswith(pallas + ".")
                          and m != pallas + ".triton"]
    assert not offenders, offenders
