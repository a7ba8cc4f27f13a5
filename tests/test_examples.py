"""
Smoke-run the example scripts in simulation mode.

Mirrors the reference's notebook smoke tests (``tests/test_examples.py``);
our examples are plain scripts, executed in subprocesses so their
module-level jax/matplotlib configuration stays isolated.
"""

import os
import subprocess
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")

# All examples run in default CI, on the CPU (JAX_PLATFORMS=cpu below);
# the calibration demos take well under a minute there.
EXAMPLES = [
    "structured_light.py",
    "computational_holography.py",
    "batched_holography.py",
    "zernike_holography.py",
    "experimental_holography.py",
    "multichip_scaling.py",
    "wavefront_calibration.py",
    "multipoint_calibration.py",
    "remote_hardware.py",
]


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(EXAMPLES_DIR)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, script)],
        cwd=EXAMPLES_DIR,
        env=env,
        capture_output=True,
        text=True,
        timeout=1800,
    )
    assert result.returncode == 0, (
        f"{script} failed:\n{result.stdout[-2000:]}\n{result.stderr[-2000:]}"
    )
