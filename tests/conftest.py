"""
Pytest configuration for slmsuite-tpu.

Mirrors the reference test strategy (reference ``tests/conftest.py``):
hardware-free by default via the simulated SLM + camera rig, with env-var
opt-in for real devices. Compute runs on a **virtual 8-device CPU mesh**
so that sharding/`shard_map` paths are exercised without a GPU. Tests
marked ``gpu`` skip there; ``python chip_smoke.py`` runs them on the
card (it sets ``SLMSUITE_TPU_TEST_PLATFORM=gpu``, which keeps the
platform JAX chose).
"""

import os

# Configure XLA before jax import: 8 virtual host devices for mesh tests.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("SLMSUITE_TPU_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

# Numeric-sanitizer mode (SURVEY section 5 analog of the reference's nan
# guards): instrument the scanned engine with checkify float checks.
if os.environ.get("SLMSUITE_TPU_CHECKIFY"):
    from slmsuite_tpu.ops import engine as _engine

    _engine.set_numeric_checks(True)

import logging  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

try:
    import matplotlib  # noqa: E402
except ImportError:  # the card's machine runs the gpu tests without it
    matplotlib = None
else:
    matplotlib.use("Agg")  # never open windows in CI


# --- Reproducibility: log and fix the session seed (ref conftest.py:58-86). ---

SESSION_SEED = int(os.environ.get("SLMSUITE_TPU_TEST_SEED", "12345"))


@pytest.fixture(scope="session", autouse=True)
def _seed_session():
    random.seed(SESSION_SEED)
    np.random.seed(SESSION_SEED)
    logging.getLogger("slmsuite_tpu.tests").info("session seed = %d", SESSION_SEED)
    yield


@pytest.fixture()
def rng():
    """Fresh numpy Generator seeded from the session seed."""
    return np.random.default_rng(SESSION_SEED)


# --- Simulated hardware rig (ref conftest.py:91-298). -----------------------


def _load_class(env_class, env_args, default_factory):
    """Instantiate hardware from env vars, or fall back to simulated."""
    import importlib
    import json

    class_path = os.environ.get(env_class)
    if not class_path:
        return default_factory()
    module_name, _, class_name = class_path.rpartition(".")
    cls = getattr(importlib.import_module(module_name), class_name)
    kwargs = json.loads(os.environ.get(env_args, "{}"))
    return cls(**kwargs)


#: Ground-truth affine placement of the test camera in the SLM's k-space.
RIG_M = np.array([[8.0e3, 200.0], [-200.0, 8.0e3]])
RIG_B = np.array([[256.0], [256.0]])


@pytest.fixture()
def slm():
    def default():
        from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

        slm = SimulatedSLM(resolution=(512, 512), pitch_um=(8, 8), wav_um=0.78)
        # Gaussian source: physical PSFs that span camera pixels.
        slm.set_source_analytic(
            "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
            wx=0.35 * 512 * slm.pitch[0], wy=0.35 * 512 * slm.pitch[1],
        )
        return slm

    return _load_class("SLMSUITE_TEST_SLM_CLASS", "SLMSUITE_TEST_SLM_ARGS", default)


@pytest.fixture()
def camera(slm):
    def default():
        from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera

        return SimulatedCamera(
            slm,
            resolution=(512, 512),
            pitch_um=(5.5, 5.5),
            M=RIG_M.copy(),
            b=RIG_B.copy(),
        )

    return _load_class("SLMSUITE_TEST_CAMERA_CLASS", "SLMSUITE_TEST_CAMERA_ARGS", default)


@pytest.fixture()
def fourierslm(slm, camera):
    from slmsuite_tpu.hardware.cameraslms import FourierSLM

    camera.set_exposure(1.0)
    return FourierSLM(camera, slm)


@pytest.fixture()
def fourierslm_calibrated(fourierslm):
    fourierslm.fourier_calibrate(array_shape=5, array_pitch=16, verbose=False)
    return fourierslm
