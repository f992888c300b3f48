"""Test configuration: force a virtual 8-device CPU platform.

Tests never require an accelerator: the multi-chip sharding path is validated
on a virtual CPU mesh, and what runs only on the GPU is a phase of
``chip_smoke.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
# 8 virtual device threads timeshare the physical cores: raise the CPU
# collective rendezvous limits BEFORE backend init or heavy sharded tests
# (flagship dryrun) abort the whole pytest process after 40 s of skew
for _f in (
    "--xla_cpu_collective_call_warn_stuck_timeout_seconds=600",
    "--xla_cpu_collective_call_terminate_timeout_seconds=1200",
):
    if _f.split("=")[0] not in _flags:
        _flags += " " + _f
os.environ["XLA_FLAGS"] = _flags.strip()

import jax  # noqa: E402

# pin the test platform to (8 virtual) CPUs even where a GPU plugin is installed
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def femur_data():
    """The seeded femur workload at rank 50 (51 basis columns)."""
    from icp_proposal_tpu.apps.femur import load_femur_data

    return load_femur_data(model_components=50)


@pytest.fixture(scope="session")
def femur_model50(femur_data):
    return femur_data.model


@pytest.fixture(scope="session")
def femur_target_mesh(femur_data):
    return femur_data.target


@pytest.fixture
def rng():
    return np.random.RandomState(0)
