"""
Microbenchmarks over the hot host/device functions.

Mirrors the reference's pytest-benchmark table (``tests/README.md``
"Benchmarking": ``_phase2gray``, ``set_phase``, ``take``,
``image_moment``, ``image_fit``, ``blaze``, ``lens``, ``zernike_sum``,
``imprint``, GS/WGS optimize). pytest-benchmark isn't in this
environment, so these are plain timed loops that log rates; they assert
only completion, not thresholds (rates on a shared machine vary too
much to gate on).

Run with ``pytest tests/test_benchmarks.py -m slow -s`` to see rates.
"""

import logging
import time

import numpy as np
import pytest

logger = logging.getLogger(__name__)

pytestmark = pytest.mark.slow


def _rate(fn, n=10, warmup=1):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return n / (time.perf_counter() - t0)


def _report(name, rate, unit="calls/s"):
    line = f"bench {name}: {rate:,.1f} {unit}"
    logger.info(line)
    print(line)


class TestHostBenchmarks:
    def test_phase2gray(self, slm):
        phase = np.random.uniform(0, 4 * np.pi, slm.shape)
        _report("_phase2gray 512^2", _rate(lambda: slm._phase2gray(phase)))

    def test_set_phase(self, slm):
        phase = np.random.uniform(0, 4 * np.pi, slm.shape)
        _report("set_phase 512^2", _rate(lambda: slm.set_phase(phase, settle=False)))

    def test_take(self):
        from slmsuite_tpu.holography.analysis import take

        img = np.random.uniform(size=(1024, 1024))
        vectors = np.random.uniform(64, 960, size=(2, 100))
        _report(
            "take 100x25^2", _rate(lambda: take(img, vectors, 25, centered=True))
        )

    def test_image_moment(self):
        from slmsuite_tpu.holography.analysis import image_moment

        imgs = np.random.uniform(size=(100, 32, 32))
        _report("image_moment (100,32,32)", _rate(lambda: image_moment(imgs)))

    def test_image_fit(self):
        from slmsuite_tpu.holography.analysis import image_fit
        from slmsuite_tpu.holography.analysis.fitfunctions import gaussian2d

        xx, yy = np.meshgrid(np.arange(32), np.arange(32))
        imgs = np.stack([
            np.exp(-((xx - 16) ** 2 + (yy - 16) ** 2) / 30) + 0.01 * np.random.uniform(size=(32, 32))
            for _ in range(10)
        ])
        _report(
            "image_fit 10xgaussian2d",
            _rate(lambda: image_fit(imgs, function=gaussian2d), n=3),
        )

    def test_blaze_lens_zernike_imprint(self, slm):
        from slmsuite_tpu.holography import toolbox
        from slmsuite_tpu.holography.toolbox import phase

        _report("blaze 512^2", _rate(lambda: phase.blaze(slm, (0.01, 0.005))))
        _report("lens 512^2", _rate(lambda: phase.lens(slm, 2e5)))
        _report(
            "zernike_sum 10 terms 512^2",
            _rate(lambda: phase.zernike_sum(
                slm, tuple(range(3, 13)), tuple(np.linspace(-1, 1, 10))
            )),
        )
        canvas = np.zeros(slm.shape)
        _report(
            "imprint 128^2 window",
            _rate(lambda: toolbox.imprint(
                canvas, (128, 128, 128, 128), phase.blaze, grid=slm,
                vector=(0.01, 0),
            )),
        )


class TestOptimizeBenchmarks:
    @pytest.mark.parametrize("method", ["GS", "WGS-Leonardo", "WGS-Kim"])
    def test_optimize_1024(self, method):
        from slmsuite_tpu.holography.algorithms import SpotHologram

        holo = SpotHologram.make_rectangular_array(
            (1024, 1024), array_shape=(10, 10), array_pitch=(20, 20), basis="knm"
        )
        holo.optimize(method, maxiter=2, verbose=False)  # Warm the compile.

        t0 = time.perf_counter()
        holo.optimize(method, maxiter=20, verbose=False)
        dt = time.perf_counter() - t0
        _report(f"optimize {method} 1024^2 10x10", 20 / dt, "iter/s")
