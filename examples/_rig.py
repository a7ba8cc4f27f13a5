"""
Shared simulated-hardware rig for the examples.

Every example runs hardware-free: a :class:`SimulatedSLM` (Gaussian
source) imaged by a :class:`SimulatedCamera` through a known affine
placement. Swap :func:`make_rig` for your own ``FourierSLM(camera, slm)``
to run the same scripts on real hardware.

Mirrors the reference examples' "simulation mode" cells
(reference ``docs/source/examples.rst``).
"""

import os

import matplotlib

matplotlib.use("Agg")  # Headless: figures are saved, not shown.

import numpy as np


OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")


def make_slm(resolution=(512, 512)):
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

    slm = SimulatedSLM(resolution=resolution, pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * resolution[0] * slm.pitch[0],
        wy=0.35 * resolution[1] * slm.pitch[1],
    )
    return slm


def make_rig(resolution=(512, 512)):
    """Build a ``FourierSLM`` around simulated hardware."""
    from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_tpu.hardware.cameraslms import FourierSLM

    slm = make_slm(resolution)
    camera = SimulatedCamera(
        slm,
        resolution=resolution,
        pitch_um=(5.5, 5.5),
        M=np.array([[8.0e3, 200.0], [-200.0, 8.0e3]]),
        b=np.array([[resolution[0] / 2], [resolution[1] / 2]]),
    )
    camera.set_exposure(1.0)
    return FourierSLM(camera, slm)


def save_figure(name):
    """Save the current matplotlib figure into ``examples/output/``."""
    import matplotlib.pyplot as plt

    os.makedirs(OUTPUT_DIR, exist_ok=True)
    path = os.path.join(OUTPUT_DIR, name)
    plt.savefig(path, dpi=120, bbox_inches="tight")
    plt.close("all")
    print(f"  saved {path}")
    return path
