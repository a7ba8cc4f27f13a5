"""
Differential parity fuzz against the ACTUAL reference implementation.

Skipped automatically when the reference checkout is not mounted at
``SLMSUITE_REFERENCE_PATH`` (default ``/root/reference``) — unlike the
committed golden traces (tests/holography/golden), these compare live
outputs for randomized inputs across the pure toolbox/analysis surface.
"""

import os
import sys

import numpy as np
import pytest

REF_PATH = os.environ.get("SLMSUITE_REFERENCE_PATH", "/root/reference")


@pytest.fixture(scope="module")
def ref():
    if not os.path.isdir(REF_PATH):
        pytest.skip("reference checkout not mounted")
    if REF_PATH not in sys.path:
        sys.path.insert(0, REF_PATH)
    try:
        import slmsuite  # noqa: F401
    except Exception as err:  # pragma: no cover
        pytest.skip(f"reference not importable: {err}")
    import types

    from slmsuite.holography import analysis as ref_analysis
    from slmsuite.holography import toolbox as ref_toolbox
    from slmsuite.holography.toolbox import phase as ref_phase

    return types.SimpleNamespace(
        analysis=ref_analysis, toolbox=ref_toolbox, phase=ref_phase
    )


@pytest.fixture()
def grid():
    x = np.linspace(-0.4, 0.4, 96)
    y = np.linspace(-0.3, 0.3, 64)
    return np.meshgrid(x, y)


class TestPhaseDifferential:
    def test_blaze(self, ref, grid, rng):
        from slmsuite_tpu.holography.toolbox import phase

        for _ in range(5):
            vec = rng.uniform(-0.2, 0.2, 2)
            np.testing.assert_allclose(
                np.asarray(phase.blaze(grid, vec)),
                ref.phase.blaze(grid, vec),
                atol=1e-5, rtol=1e-5,
            )

    def test_lens(self, ref, grid, rng):
        from slmsuite_tpu.holography.toolbox import phase

        for _ in range(5):
            f = rng.uniform(0.5, 20.0, 2)
            np.testing.assert_allclose(
                np.asarray(phase.lens(grid, tuple(f))),
                ref.phase.lens(grid, tuple(f)),
                atol=1e-4, rtol=1e-5,
            )

    def test_axicon(self, ref, grid, rng):
        from slmsuite_tpu.holography.toolbox import phase

        for _ in range(3):
            w = float(rng.uniform(0.05, 0.3))
            np.testing.assert_allclose(
                np.asarray(phase.axicon(grid, f=2.0, w=w)),
                ref.phase.axicon(grid, f=2.0, w=w),
                atol=1e-4, rtol=1e-4,
            )

    def test_zernike_sum(self, ref, grid, rng):
        from slmsuite_tpu.holography.toolbox import phase

        for _ in range(5):
            indices = rng.choice(np.arange(1, 15), size=4, replace=False)
            weights = rng.normal(size=4)
            ours = np.asarray(
                phase.zernike_sum(grid, indices, weights, aperture="cropped")
            )
            theirs = ref.phase.zernike_sum(
                grid, indices, weights, aperture="cropped"
            )
            np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)

    def test_polynomial(self, ref, grid, rng):
        from slmsuite_tpu.holography.toolbox import phase

        # Explicit terms: the reference's default-terms path crashes for
        # some D (its own _inverse_cantor_pairing edge), so compare on
        # the explicit-(a, b) common ground.
        terms = np.array([[0, 0], [1, 0], [0, 1], [2, 0], [1, 1], [0, 2]])
        for _ in range(5):
            weights = rng.normal(size=terms.shape[0])
            np.testing.assert_allclose(
                np.asarray(phase.polynomial(grid, weights, terms=terms)),
                np.asarray(ref.phase.polynomial(grid, weights, terms=terms)),
                atol=1e-4, rtol=1e-4,
            )

    def test_laguerre_and_hermite(self, ref, grid):
        from slmsuite_tpu.holography.toolbox import phase

        for l, p in ((1, 0), (-2, 1), (3, 2)):
            np.testing.assert_allclose(
                np.asarray(phase.laguerre_gaussian(grid, l, p)),
                ref.phase.laguerre_gaussian(grid, l, p),
                atol=1e-5,
            )
        for n, m in ((1, 0), (2, 2)):
            np.testing.assert_allclose(
                np.asarray(phase.hermite_gaussian(grid, n, m)),
                ref.phase.hermite_gaussian(grid, n, m),
                atol=1e-5,
            )

    def test_zernike_index_conversions(self, ref, rng):
        from slmsuite_tpu.holography.toolbox import phase

        idx = np.arange(36)
        for to in ("noll", "radial"):
            ours = np.asarray(
                phase.zernike_convert_index(idx, from_index="ansi", to_index=to)
            )
            theirs = np.asarray(
                ref.phase.zernike_convert_index(
                    idx, from_index="ansi", to_index=to
                )
            )
            np.testing.assert_array_equal(
                np.squeeze(ours), np.squeeze(theirs)
            )


class TestAnalysisDifferential:
    def test_moments_and_variances(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        imgs = rng.random((3, 48, 56)).astype(np.float32)
        for moment in ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1)):
            np.testing.assert_allclose(
                analysis.image_moment(imgs, moment),
                ref.analysis.image_moment(imgs, moment),
                atol=1e-4, rtol=1e-4,
            )
        np.testing.assert_allclose(
            analysis.image_variances(imgs),
            ref.analysis.image_variances(imgs),
            atol=1e-3, rtol=1e-3,
        )

    def test_take(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        img = rng.random((64, 64)).astype(np.float32)
        vectors = np.array([[10.0, 30, 50], [12.0, 32, 52]])
        ours = np.asarray(analysis.take(img, vectors, size=9, centered=True))
        theirs = np.asarray(
            ref.analysis.take(img, vectors, size=9, centered=True)
        )
        np.testing.assert_allclose(ours, theirs, atol=1e-6)

    def test_fit_affine(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        M = np.array([[1.2, 0.1], [-0.2, 0.9]])
        b = np.array([[3.0], [-2.0]])
        x = rng.random((2, 30))
        y = M @ x + b + rng.normal(scale=1e-9, size=(2, 30))
        ours = analysis.fit_affine(x, y)
        theirs = ref.analysis.fit_affine(x, y)
        np.testing.assert_allclose(ours["M"], theirs["M"], atol=1e-6)
        np.testing.assert_allclose(ours["b"], theirs["b"], atol=1e-6)


class TestToolboxDifferential:
    def test_pad_unpad(self, ref, rng):
        from slmsuite_tpu.holography import toolbox

        m = rng.random((30, 46)).astype(np.float32)
        ours = toolbox.pad(m, (64, 64))
        theirs = ref.toolbox.pad(m, (64, 64))
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(
            toolbox.unpad(ours, (30, 46)), ref.toolbox.unpad(theirs, (30, 46))
        )

    def test_convert_vector_pure_units(self, ref, rng):
        from slmsuite_tpu.holography import toolbox

        v = rng.uniform(-0.2, 0.2, (2, 5))
        for a, b in (("norm", "mrad"), ("mrad", "deg"), ("deg", "kxy")):
            np.testing.assert_allclose(
                np.asarray(toolbox.convert_vector(v, a, b)),
                np.asarray(ref.toolbox.convert_vector(v, from_units=a, to_units=b)),
                atol=1e-9,
            )

    def test_smallest_distance(self, ref, rng):
        from slmsuite_tpu.holography import toolbox

        v = rng.random((2, 40)) * 100
        for metric in ("chebyshev", "euclidean"):
            assert toolbox.smallest_distance(v, metric) == pytest.approx(
                float(ref.toolbox.smallest_distance(v, metric)), rel=1e-6
            )


class TestFitfunctionsDifferential:
    def test_scalar_functions(self, ref, rng):
        from slmsuite.holography.analysis import fitfunctions as rff

        from slmsuite_tpu.holography.analysis import fitfunctions as ff

        x = np.linspace(-3, 3, 101)
        cases = [
            ("linear", (x, 1.2, -0.3)),
            ("parabola", (x, 0.7, 0.2, -1.0)),
            ("hyperbola", (x, 1.0, 0.1, 2.0)),
            ("cos", (x, 0.1, 2.0, 0.3)),
            ("lorentzian", (x, 0.2, 3.0, 0.5, 1.1)),
            ("gaussian", (x, -0.4, 2.0, 0.1, 0.8)),
        ]
        for name, args in cases:
            np.testing.assert_allclose(
                getattr(ff, name)(*args), getattr(rff, name)(*args),
                atol=1e-6, rtol=1e-6, err_msg=name,
            )

    def test_2d_functions(self, ref, rng):
        from slmsuite.holography.analysis import fitfunctions as rff

        from slmsuite_tpu.holography.analysis import fitfunctions as ff

        g = np.meshgrid(np.linspace(-2, 2, 40), np.linspace(-1, 1, 30))
        xy = (g[0].ravel(), g[1].ravel())
        np.testing.assert_allclose(
            ff.gaussian2d(xy, 0.2, -0.1, 2.0, 0.1, 0.6, 0.9, 0.05),
            rff.gaussian2d(xy, 0.2, -0.1, 2.0, 0.1, 0.6, 0.9, 0.05),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            ff.tophat2d(xy, 0.1, 0.0, 0.7, 1.5, 0.2),
            rff.tophat2d(xy, 0.1, 0.0, 0.7, 1.5, 0.2),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            ff.sinc2d(xy, 0.0, 0.1, 0.8, 1.0, 0.2, 0.05, 0.01, 0.3, -0.2),
            rff.sinc2d(xy, 0.0, 0.1, 0.8, 1.0, 0.2, 0.05, 0.01, 0.3, -0.2),
            atol=1e-5,
        )


class TestTransformGridDifferential:
    def test_rev_matches_reference(self, ref, rng):
        from slmsuite_tpu.holography import toolbox

        x = np.linspace(-1, 1, 16)
        grid = np.meshgrid(x, x)
        M = np.array([[0.9, 0.2], [-0.1, 1.1]])
        b = (0.3, -0.2)
        ours = toolbox.transform_grid(grid, M, b, direction="rev")
        theirs = ref.toolbox.transform_grid(grid, M, b, direction="rev")
        np.testing.assert_allclose(np.asarray(ours[0]), theirs[0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(ours[1]), theirs[1], atol=1e-12)

    def test_fwd_is_the_documented_divergence(self, ref):
        """Our fwd mode implements the true affine M x + b (so fwd then
        rev is the identity); the reference's fwd applies the shift
        differently (a documented upstream bug) — pin both facts so the
        intentional divergence is visible if either side changes."""
        from slmsuite_tpu.holography import toolbox

        x = np.linspace(-1, 1, 16)
        grid = np.meshgrid(x, x)
        M = np.array([[0.9, 0.2], [-0.1, 1.1]])
        b = (0.3, -0.2)

        # Ours: fwd then rev round-trips to the identity.
        f = toolbox.transform_grid(grid, M, b, direction="fwd")
        back = toolbox.transform_grid(f, M, b, direction="rev")
        np.testing.assert_allclose(np.asarray(back[0]), grid[0], atol=1e-9)
        np.testing.assert_allclose(np.asarray(back[1]), grid[1], atol=1e-9)

        # The reference's fwd output differs from the true affine.
        theirs = ref.toolbox.transform_grid(grid, M, b, direction="fwd")
        true_x = M[0, 0] * grid[0] + M[0, 1] * grid[1] + b[0]
        assert np.abs(np.asarray(theirs[0]) - true_x).max() > 1e-6
        np.testing.assert_allclose(np.asarray(f[0]), true_x, atol=1e-12)


class TestWindowsAndFieldDifferential:
    def test_window_slice(self, ref):
        from slmsuite_tpu.holography import toolbox

        for window in ((10, 20, 12, 24), (0, 5, 60, 10)):
            assert toolbox.window_slice(window, shape=(64, 64)) == (
                ref.toolbox.window_slice(window, shape=(64, 64))
            )

    def test_window_slice_circular(self, ref):
        from slmsuite_tpu.holography import toolbox

        ours = toolbox.window_slice(
            (32, 20, 32, 20), shape=(64, 64), centered=True, circular=True
        )
        theirs = ref.toolbox.window_slice(
            (32, 20, 32, 20), shape=(64, 64), centered=True, circular=True
        )
        np.testing.assert_array_equal(np.asarray(ours[0]), theirs[0])
        np.testing.assert_array_equal(np.asarray(ours[1]), theirs[1])

    def test_image_remove_field(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        img = rng.random((2, 48, 48)).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(analysis.image_remove_field(img.copy(), deviations=1)),
            ref.analysis.image_remove_field(img.copy(), deviations=1),
            atol=1e-7,
        )

    def test_relative_strehl(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        img = rng.random((48, 48)).astype(np.float32)
        img[20:24, 20:24] += 5
        assert analysis.image_relative_strehl(img) == pytest.approx(
            float(ref.analysis.image_relative_strehl(img)), rel=1e-6
        )

    def test_image_reduce_wraps(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        phase = np.cumsum(rng.normal(scale=0.8, size=(32, 32)), axis=1)
        wrapped = np.mod(phase + np.pi, 2 * np.pi) - np.pi
        np.testing.assert_allclose(
            np.asarray(analysis.image_reduce_wraps(wrapped.copy())),
            ref.analysis.image_reduce_wraps(wrapped.copy()),
            atol=1e-7,
        )


class TestBlobDetectDifferential:
    def test_blob_array_detect_bit_identical(self, ref, rng):
        """The lattice fit returns BIT-identical M/b to the reference on
        a synthetic spot array (the one SURVEY-licensed near-port)."""
        import warnings as _w

        from slmsuite_tpu.holography import analysis

        img = np.zeros((128, 128), np.float32)
        M = np.array([[14.0, 1.0], [-1.0, 14.0]])
        b = np.array([[20.0], [24.0]])
        for i in range(7):
            for j in range(7):
                p = M @ [[i], [j]] + b
                x, y = int(round(p[0, 0])), int(round(p[1, 0]))
                if 1 <= x < 127 and 1 <= y < 127:
                    img[y - 1:y + 2, x - 1:x + 2] += 40
        img += rng.normal(scale=1.0, size=img.shape).astype(np.float32)
        img = np.clip(img, 0, 255)

        with _w.catch_warnings():
            _w.simplefilter("ignore")  # Both warn about grid coverage.
            ours = analysis.blob_array_detect(img, size=(7, 7), plot=False)
            theirs = ref.analysis.blob_array_detect(img, size=(7, 7), plot=False)
        np.testing.assert_array_equal(np.asarray(ours["M"]), theirs["M"])
        np.testing.assert_array_equal(np.asarray(ours["b"]), theirs["b"])


class TestCompressedDifferential:
    def test_compressed_spot_loop_matches_reference(self, ref, rng):
        """The grid-free (compressed Zernike) WGS-Kim loop reproduces
        the ACTUAL reference's numpy path end-to-end: same simulated
        rig, same 3x3 spot array with depth, same seed phase -> weights,
        spot amplitudes, and the final SLM phase agree to float32
        round-off. Pins basis conventions (kxy scaling, focus term),
        the transform pair, and the WGS-Kim update jointly."""
        del ref  # Module fixture only guards reference availability.

        def build(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import SimulatedCamera
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.algorithms import (
                    CompressedSpotHologram,
                )
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.algorithms import (
                    CompressedSpotHologram,
                )

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(slm, (64, 64), pitch_um=(4, 4))
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
                "b": np.array([[32.0], [32.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            side = 3
            kx, ky = np.meshgrid(
                np.linspace(-4e-3, 4e-3, side), np.linspace(-4e-3, 4e-3, side)
            )
            spots = np.vstack([
                kx.ravel(), ky.ravel(),
                np.linspace(-2e-7, 2e-7, side * side),
            ])
            import warnings as _w

            with _w.catch_warnings():
                _w.simplefilter("ignore")  # Sim-camera exposure chatter.
                holo = CompressedSpotHologram(
                    spots, basis="kxy", cameraslm=cs
                )
                phase0 = np.random.default_rng(5).uniform(
                    -np.pi, np.pi, (128, 128)
                ).astype(np.float32)
                holo.reset_phase(phase0)
                holo.optimize("WGS-Kim", maxiter=3, verbose=False)
            amp_ff = getattr(holo, "farfield", None)
            if amp_ff is None or which != "ref":
                amp_ff = holo.amp_ff
            return (
                np.asarray(holo.weights).ravel(),
                np.abs(np.asarray(amp_ff)).ravel(),
                np.asarray(holo.phase),
            )

        w_t, a_t, p_t = build("ours")
        w_r, a_r, p_r = build("ref")
        np.testing.assert_allclose(
            w_t / w_t.sum(), w_r / w_r.sum(), atol=1e-6, rtol=0
        )
        np.testing.assert_allclose(
            a_t / np.linalg.norm(a_t), a_r / np.linalg.norm(a_r),
            atol=1e-6, rtol=0,
        )
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.percentile(np.abs(wrapped), 99) < 1e-4


class TestClosedLoopDifferential:
    def test_experimental_feedback_matches_reference(self, ref):
        """The FULL camera-in-the-loop path reproduces the ACTUAL
        reference end-to-end: simulated rig (quantized display ->
        far-field -> camera sampling), experimental_spot WGS-Kim
        feedback, 4 iterations from a fixed seed. Weights, per-iteration
        experimental uniformity, and the final SLM phase agree to
        float32 round-off — pinning set_phase quantization, the
        simulated camera model, spot integration (take), and the
        experimental weight rule jointly."""
        import warnings as _w

        del ref  # Module fixture only guards reference availability.

        def build(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.algorithms import SpotHologram
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.algorithms import SpotHologram

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(
                slm, (128, 128), pitch_um=(4, 4),
                M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
                b=np.array([[64.0], [64.0]]),
            )
            cam.set_exposure(1.0)
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[2e3, 0.0], [0.0, 2e3]]),
                "b": np.array([[64.0], [64.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            spot_ij = np.array([[40.0, 88, 64], [64.0, 64, 88]])
            with _w.catch_warnings():
                _w.simplefilter("ignore")  # Exposure/capture chatter.
                holo = SpotHologram(
                    (256, 256), spot_ij, basis="ij", cameraslm=cs
                )
                phase0 = np.random.default_rng(7).uniform(
                    -np.pi, np.pi, (128, 128)
                ).astype(np.float32)
                holo.reset_phase(phase0)
                holo.optimize(
                    "WGS-Kim", maxiter=4, verbose=False,
                    feedback="experimental_spot",
                    stat_groups=["experimental_spot"],
                )
            return (
                np.asarray(holo.weights, dtype=np.float64),
                np.asarray(holo.phase),
                np.asarray(
                    holo.stats["stats"]["experimental_spot"]["uniformity"]
                ),
            )

        w_t, p_t, u_t = build("ours")
        w_r, p_r, u_r = build("ref")
        wt, wr = w_t[w_t != 0], w_r[w_r != 0]
        assert wt.size == wr.size == 3
        np.testing.assert_allclose(
            wt / wt.sum(), wr / wr.sum(), atol=1e-6, rtol=0
        )
        np.testing.assert_allclose(u_t, u_r, atol=1e-5, rtol=0)
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.percentile(np.abs(wrapped), 99) < 1e-4


class TestMultiplaneDifferential:
    def test_multiplane_meta_loop_matches_reference(self, ref):
        """Three-plane MultiplaneHologram (distinct propagation kernels
        per child) reproduces the ACTUAL reference's meta loop: final
        shared phase and per-child efficiency traces agree to float32
        round-off. Pins the weighted nearfield sum, per-child kernel
        removal, and plane-weight normalization conventions."""
        import warnings as _w

        del ref  # Module fixture only guards reference availability.

        def build(which):
            if which == "ref":
                from slmsuite.holography.algorithms import (
                    Hologram,
                    MultiplaneHologram,
                )
            else:
                from slmsuite_tpu.holography.algorithms import (
                    Hologram,
                    MultiplaneHologram,
                )

            N = 64
            rng = np.random.default_rng(6)
            amp = np.ones((N, N), np.float32)
            amp /= np.sqrt((amp**2).sum())
            kids = []
            for b in range(3):
                target = np.zeros((N, N), np.float32)
                target[16 + 8 * b, 20 + 6 * b] = 1.0
                h = Hologram(target, amp=amp.copy())
                h.propagation_kernel = np.full((N, N), 0.03 * b, np.float32)
                kids.append(h)
            phi0 = rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                holo = MultiplaneHologram(kids)
                holo.reset_phase(custom_phase=phi0)
                holo.optimize(
                    "WGS-Leonardo", maxiter=5, verbose=False,
                    stat_groups=["computational"],
                )
            effs = [
                np.asarray(h.stats["stats"]["computational"]["efficiency"])
                for h in holo.holograms
            ]
            return np.asarray(holo.phase), np.stack(effs)

        p_t, e_t = build("ours")
        p_r, e_r = build("ref")
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.percentile(np.abs(wrapped), 99) < 1e-4
        np.testing.assert_allclose(e_t, e_r, atol=1e-5, rtol=0)


class TestCGDifferential:
    def test_cg_trajectory_matches_reference(self, ref):
        """Conjugate-gradient mode (jax.grad + optax Adam here; torch
        autograd + torch.optim.Adam in the reference) follows the SAME
        trajectory: 8 Adam steps at lr=0.1 from a fixed seed land on the
        same phase to float32 round-off. Pins the default ComplexMSELoss
        semantics, the gradient through the ortho FFT, and Adam's
        bias-correction/eps conventions across frameworks."""
        import warnings as _w

        del ref  # Module fixture only guards reference availability.

        def build(which):
            if which == "ref":
                from slmsuite.holography.algorithms import Hologram
            else:
                from slmsuite_tpu.holography.algorithms import Hologram

            target = np.zeros((64, 64), np.float32)
            target[20, 30] = target[40, 24] = 1.0
            target /= np.sqrt((target**2).sum())
            amp = np.ones((64, 64), np.float32)
            amp /= np.sqrt((amp**2).sum())
            holo = Hologram(target, amp=amp.copy())
            phase0 = np.random.default_rng(3).uniform(
                -np.pi, np.pi, (64, 64)
            ).astype(np.float32)
            holo.reset_phase(phase0)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                holo.optimize("CG", maxiter=8, verbose=False)
            return np.asarray(holo.phase)

        p_t = build("ours")
        p_r = build("ref")
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.abs(wrapped).max() < 1e-4


class TestRefineOffsetDifferential:
    def test_refine_offset_bit_identical(self, ref):
        """``refine_offset`` on the simulated rig (take regions ->
        remove field -> centroid -> spot_kxy correction) returns
        BIT-identical offsets and corrected spot vectors vs the actual
        reference — the centroid/affine math is pure host numpy in
        both."""
        import warnings as _w

        del ref  # Module fixture only guards reference availability.

        def build(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.algorithms import SpotHologram
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.algorithms import SpotHologram

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(
                slm, (128, 128), pitch_um=(4, 4),
                M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
                b=np.array([[64.0], [64.0]]),
            )
            cam.set_exposure(1.0)
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[2e3, 0.0], [0.0, 2e3]]),
                "b": np.array([[64.0], [64.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            spot_ij = np.array([[40.0, 88, 64], [64.0, 64, 88]])
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                holo = SpotHologram(
                    (256, 256), spot_ij, basis="ij", cameraslm=cs
                )
                phase0 = np.random.default_rng(7).uniform(
                    -np.pi, np.pi, (128, 128)
                ).astype(np.float32)
                holo.reset_phase(phase0)
                holo.optimize("WGS-Kim", maxiter=10, verbose=False)
                offs = holo.refine_offset(basis="kxy", plot=False)
            return (
                np.asarray(offs, dtype=np.float64),
                np.asarray(holo.spot_kxy, dtype=np.float64),
            )

        o_t, k_t = build("ours")
        o_r, k_r = build("ref")
        np.testing.assert_array_equal(o_t, o_r)
        np.testing.assert_array_equal(k_t, k_r)


class TestAnalysisDifferentialExtended:
    def test_convert_radius_and_assign_vectors(self, ref, rng):
        from slmsuite_tpu.holography import toolbox

        assert float(
            np.asarray(
                toolbox.convert_radius(
                    0.01, from_units="kxy", to_units="rad", hardware=None
                )
            )
        ) == ref.toolbox.convert_radius(
            0.01, from_units="kxy", to_units="rad", hardware=None
        )
        v = rng.normal(size=(2, 30))
        a = rng.normal(size=(2, 4))
        np.testing.assert_array_equal(
            np.asarray(toolbox.assign_vectors(v, a)),
            ref.toolbox.assign_vectors(v, a),
        )

    def test_window_extent(self, ref):
        from slmsuite_tpu.holography import toolbox

        w = np.zeros((40, 40))
        w[10:25, 12:30] = 1
        np.testing.assert_array_equal(
            np.asarray(toolbox.window_extent(w)),
            np.asarray(ref.toolbox.window_extent(w)),
        )

    def test_image_vortices(self, ref):
        from slmsuite_tpu.holography import analysis

        x, y = np.meshgrid(np.arange(48.0) - 24, np.arange(48.0) - 20)
        ph = np.arctan2(y, x) + 0.3 * x
        wrapped = np.mod(ph + np.pi, 2 * np.pi) - np.pi
        np.testing.assert_array_equal(
            np.asarray(analysis.image_vortices(wrapped)),
            ref.analysis.image_vortices(wrapped),
        )

    def test_image_fit_ellipticity_areas(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        xx, yy = np.meshgrid(np.arange(30.0), np.arange(30.0))
        img = 5 * np.exp(-((xx - 14) ** 2 / 18 + (yy - 16) ** 2 / 12))
        img = img + rng.normal(scale=0.05, size=(30, 30))
        np.testing.assert_allclose(
            np.asarray(analysis.image_fit(img[np.newaxis], plot=False)),
            ref.analysis.image_fit(img[np.newaxis], plot=False),
            atol=1e-12,
        )
        v_t = analysis.image_variances(img[np.newaxis])
        v_r = ref.analysis.image_variances(img[np.newaxis])
        np.testing.assert_allclose(
            np.asarray(analysis.image_ellipticity(v_t)),
            ref.analysis.image_ellipticity(v_r), atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(analysis.image_areas(v_t)),
            ref.analysis.image_areas(v_r), atol=1e-12,
        )

    def test_voronoi_windows_interiors_match(self, ref, rng):
        """Documented deviation: our cells own boundary pixels uniquely
        (exact partition); the reference's cv2 polygon fill assigns cell
        EDGES to multiple/neither cell. Interiors must agree: every
        disagreeing pixel lies on a cell boundary (a neighbor belongs to
        a different cell), and cell overlap stays high."""
        import warnings as _w

        from slmsuite_tpu.holography import toolbox

        g = (40, 40)
        pts = rng.uniform(5, 35, (2, 6))
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            ours = [np.asarray(w) for w in
                    toolbox.voronoi_windows(g, pts.copy(), plot=False)]
            ref_w = ref.toolbox.voronoi_windows(g, pts.copy(), plot=False)
        # Ours is an exact partition (no overlaps).
        assert (np.sum(ours, axis=0) <= 1).all()
        label = np.full(g, -1)
        for i, w in enumerate(ours):
            label[w] = i
        pad = np.pad(label, 1, constant_values=-1)
        boundary = np.zeros(g, bool)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1),
                       (1, -1), (-1, 1)):
            shifted = pad[1 + dy:41 + dy, 1 + dx:41 + dx]
            boundary |= shifted != label
        # cv2's integer-rounded polygon edges shift ownership by up to a
        # pixel, so allow disagreement within one pixel of a boundary.
        from scipy.ndimage import binary_dilation

        boundary = binary_dilation(boundary, np.ones((3, 3), bool))
        for mine, theirs in zip(ours, ref_w):
            disagree = mine != theirs
            assert not (disagree & ~boundary).any()
            inter = (mine & theirs).sum()
            union = (mine | theirs).sum()
            assert inter / union > 0.7


class TestPhaseImageDifferential:
    def test_image_zernike_fit_bit_identical(self, ref):
        from slmsuite_tpu.holography import analysis

        x, y = np.meshgrid(np.linspace(-1, 1, 48), np.linspace(-1, 1, 48))
        ph = 0.8 * (2 * x * y) + 0.5 * (x**2 - y**2) + 0.2 * x
        np.testing.assert_array_equal(
            np.asarray(
                analysis.image_zernike_fit(
                    ph[np.newaxis], (x, y), order=2, unwrap=False
                )
            ),
            np.asarray(
                ref.analysis.image_zernike_fit(
                    ph[np.newaxis], (x, y), order=2, unwrap=False
                )
            ),
        )

    def test_image_remove_vortices_bit_identical(self, ref):
        from slmsuite_tpu.holography import analysis

        xx, yy = np.meshgrid(np.arange(48.0) - 22, np.arange(48.0) - 26)
        wrapped = np.mod(np.arctan2(yy, xx) + np.pi, 2 * np.pi) - np.pi
        np.testing.assert_array_equal(
            np.asarray(analysis.image_remove_vortices(wrapped.copy())),
            ref.analysis.image_remove_vortices(wrapped.copy()),
        )

    def test_blob_detect_same_keypoints(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        img = np.zeros((96, 96), np.float32)
        for (cy, cx) in ((30, 40), (60, 20), (70, 70)):
            img[cy - 2:cy + 3, cx - 2:cx + 3] = 200
        img += rng.normal(scale=2, size=img.shape).astype(np.float32)
        img = np.clip(img, 0, 255)
        ours = analysis.blob_detect(img, plot=False)
        theirs = ref.analysis.blob_detect(img, plot=False)
        kp_o = ours[0] if isinstance(ours, tuple) else ours
        kp_r = theirs[0] if isinstance(theirs, tuple) else theirs
        po = sorted(k.pt for k in kp_o)
        pr = sorted(k.pt for k in kp_r)
        assert len(po) == len(pr) == 3
        np.testing.assert_allclose(po, pr, atol=1e-6)


class TestCameraRoutinesDifferential:
    @staticmethod
    def _rig(which):
        if which == "ref":
            from slmsuite.hardware.cameras.simulated import SimulatedCamera
            from slmsuite.hardware.slms.simulated import SimulatedSLM
        else:
            from slmsuite_tpu.hardware.cameras.simulated import (
                SimulatedCamera,
            )
            from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

        slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = SimulatedCamera(
            slm, (128, 128), pitch_um=(4, 4),
            M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
            b=np.array([[64.0], [64.0]]),
        )
        return slm, cam

    def test_autoexposure_bit_identical(self, ref):
        """The proportional autoexposure loop converges to the SAME
        exposure on the simulated rig (same images -> same clipped
        steps)."""
        import warnings as _w

        del ref

        def run(which):
            slm, cam = self._rig(which)
            cam.set_exposure(0.37)
            slm.set_phase(None)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                cam.autoexposure(set_fraction=0.4, tol=0.03, verbose=False)
            return cam.get_exposure()

        assert run("ours") == run("ref")

    def test_autofocus_recovers_same_optimum(self, ref):
        """SLM-actuated autofocus (Zernike-defocus sweep -> Fourier
        contrast metric -> Lorentzian fit) recovers the same optimal z
        against an INJECTED 0.4-rad defocus aberration in the simulated
        source."""
        import warnings as _w

        del ref

        def run(which):
            if which == "ref":
                from slmsuite.holography.toolbox.phase import zernike
            else:
                from slmsuite_tpu.holography.toolbox.phase import zernike
            slm, cam = self._rig(which)
            aberration = 0.4 * np.asarray(
                zernike(slm, index=4, weight=1.0, use_mask=False)
            )
            slm.source["phase_sim"] = aberration.astype(np.float32)
            cam.set_exposure(1.0)
            slm.set_phase(None)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                return cam.autofocus(slm, get_z=0, range_z=2, plot=False)

        z_t, z_r = run("ours"), run("ref")
        assert abs(z_t - z_r) < 1e-4
        assert abs(z_t + 0.434) < 0.01  # Compensates the injection.


class TestSuperpixelDifferential:
    def test_superpixel_raw_measurement_matches(self, ref):
        """The superpixel wavefront calibration's MEASUREMENT machinery
        reproduces the actual reference on the simulated rig: the
        conflict-free schedule geometry and per-superpixel fringe
        gradients (kx, ky), power, and normalization are BIT-identical;
        the fitted fringe phase agrees within 0.02 rad wherever both
        sides report a confident fit (r^2 > 0.9). (The downstream
        *processing* is a documented re-derivation — BFS affine-phase
        propagation — and is pinned by synthetic exact-recovery tests
        instead.)"""
        import warnings as _w

        del ref

        def run(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(
                slm, (256, 256), pitch_um=(4, 4),
                M=np.array([[4.0e3, 0.0], [0.0, 4.0e3]]),
                b=np.array([[128.0], [128.0]]),
            )
            cam.set_exposure(1.0)
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
                "b": np.array([[128.0], [128.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                np.random.seed(0)
                cs.wavefront_calibrate_superpixel(
                    superpixel_size=32, phase_steps=1, plot=False,
                )
            return cs.calibrations.get(
                "wavefront_superpixel", cs.calibrations.get("wavefront", {})
            )

        d_t, d_r = run("ours"), run("ref")
        for key in ("kx", "ky", "power", "normalization",
                    "interference_size"):
            np.testing.assert_array_equal(
                np.asarray(d_t[key]), np.asarray(d_r[key]), err_msg=key
            )
        r2 = np.minimum(d_t["r2_fit"], d_r["r2_fit"])
        good = r2 > 0.9
        assert good.sum() > 30  # The rig yields plenty of confident fits.
        dphi = np.abs(np.angle(np.exp(1j * (d_t["phase"] - d_r["phase"]))))
        assert np.nanmax(np.where(good, dphi, 0)) < 0.02


class TestZernikeCalibrationDifferential:
    def test_zernike_calibration_recovers_same_focus(self, ref):
        """The full Zernike wavefront calibration loop (compressed
        calibration hologram, per-term perturbation sweep, parabola
        fit, correction subtraction) recovers the SAME focus correction
        as the actual reference against an injected 0.6-rad defocus in
        the simulated source. Per-spot sweeps ride different random WGS
        speckle, so the pin is physical: per-spot corrections within
        0.05 rad of each other, means within 0.02, and both strongly
        responding to the injection."""
        import warnings as _w

        del ref

        def run(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.toolbox.phase import zernike
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.toolbox.phase import zernike

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            aberr = 0.6 * np.asarray(
                zernike(slm, index=4, weight=1.0, use_mask=False)
            )
            slm.source["phase_sim"] = aberr.astype(np.float32)
            cam = SimulatedCamera(
                slm, (256, 256), pitch_um=(4, 4),
                M=np.array([[4.0e3, 0.0], [0.0, 4.0e3]]),
                b=np.array([[128.0], [128.0]]),
            )
            cam.set_exposure(1.0)
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
                "b": np.array([[128.0], [128.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                np.random.seed(0)
                cs.wavefront_calibrate_zernike(
                    calibration_points=16, zernike_indices=6,
                    optimize_focus=True, optimize_position=False,
                    optimize_weights=False, plot=False,
                )
            d = cs.calibrations["wavefront_zernike"]
            corr = np.asarray(d["corrected_spots"]) - np.asarray(
                d["initial_points"]
            )
            return corr[2]  # Basis order [2,1,4,3,5,6]: row 2 = focus.

        c_t, c_r = run("ours"), run("ref")
        assert np.abs(c_t - c_r).max() < 0.05
        assert abs(c_t.mean() - c_r.mean()) < 0.02
        assert c_t.mean() < -0.2 and c_r.mean() < -0.2  # Injection felt.


class TestHDRDifferential:
    def test_hdr_capture_bit_identical(self, ref):
        """HDR capture/reconstruction (exposure-swept stack merge) on a
        deliberately saturating simulated image is bit-identical to the
        reference, and actually differs from the plain capture (the
        reconstruction engages)."""
        import warnings as _w

        del ref

        def run(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.slms.simulated import SimulatedSLM
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(
                slm, (128, 128), pitch_um=(4, 4),
                M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
                b=np.array([[64.0], [64.0]]),
            )
            cam.set_exposure(20.0)
            slm.set_phase(None)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                plain = np.asarray(cam.get_image(), dtype=np.float64)
                hdr = np.asarray(cam.get_image(hdr=4), dtype=np.float64)
            return plain, hdr

        p_t, h_t = run("ours")
        p_r, h_r = run("ref")
        np.testing.assert_array_equal(h_t, h_r)
        assert not np.array_equal(p_t, h_t)  # Reconstruction engaged.


class TestSettlePixelDifferential:
    @staticmethod
    def _calibrated_rig(which):
        if which == "ref":
            from slmsuite.hardware.cameras.simulated import SimulatedCamera
            from slmsuite.hardware.cameraslms import FourierSLM
            from slmsuite.hardware.slms.simulated import SimulatedSLM
        else:
            from slmsuite_tpu.hardware.cameras.simulated import (
                SimulatedCamera,
            )
            from slmsuite_tpu.hardware.cameraslms import FourierSLM
            from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

        slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = SimulatedCamera(
            slm, (256, 256), pitch_um=(4, 4),
            M=np.array([[4.0e3, 0.0], [0.0, 4.0e3]]),
            b=np.array([[128.0], [128.0]]),
        )
        cam.set_exposure(1.0)
        cs = FourierSLM(cam, slm)
        cs.calibrations["fourier"] = {
            "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
            "b": np.array([[128.0], [128.0]]),
            "a": np.array([[0.0], [0.0]]),
        }
        return cs

    def test_settle_calibration_bit_identical(self, ref):
        """settle_calibrate raw data AND the processed fit
        (communication/relax/settle times) are bit-identical on the
        instantaneous simulated SLM."""
        import warnings as _w

        del ref

        def run(which):
            cs = self._calibrated_rig(which)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                cs.settle_calibrate(
                    vector=(0.005, 0.005),
                    times=np.linspace(0.001, 0.02, 6),
                    settle_time_s=0.01,
                )
                cs.settle_calibration_process(plot=False)
            return cs.calibrations["settle"]

        d_t, d_r = run("ours"), run("ref")
        for key in ("data", "times", "communication_time", "relax_time",
                    "settle_time"):
            np.testing.assert_array_equal(
                np.asarray(d_t[key]), np.asarray(d_r[key]), err_msg=key
            )

    def test_pixel_calibration_sweep_bit_identical(self, ref):
        """pixel_calibrate's 4-level nested sweep (direction, period,
        level a, level b -> integrated diffraction orders) produces the
        bit-identical raw data array (the reference leaves processing
        TODO; ours adds the fit beyond it)."""
        import warnings as _w

        del ref

        def run(which):
            cs = self._calibrated_rig(which)
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                cs.pixel_calibrate(levels=4, periods=[16, 32], orders=1)
            return cs.calibrations["pixel"]

        d_t, d_r = run("ours"), run("ref")
        for key in ("data", "levels", "orders", "periods"):
            np.testing.assert_array_equal(
                np.asarray(d_t[key]), np.asarray(d_r[key]), err_msg=key
            )


class TestRemoteInteropDifferential:
    """WIRE-LEVEL interop with the reference's TCP remote-hardware
    protocol: either side's Server can serve the other side's clients
    unchanged — a lab already running the reference's server can be
    driven by this package (and vice versa)."""

    @staticmethod
    def _free_port():
        import socket as _socket

        s = _socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def _serve_and_drive(self, server_side, client_side):
        import threading
        import time as _time
        import warnings as _w

        if server_side == "ref":
            from slmsuite.hardware.cameras.simulated import (
                SimulatedCamera,
            )
            from slmsuite.hardware.remote import Server
            from slmsuite.hardware.slms.simulated import SimulatedSLM
        else:
            from slmsuite_tpu.hardware.cameras.simulated import (
                SimulatedCamera,
            )
            from slmsuite_tpu.hardware.remote import Server
            from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
        if client_side == "ref":
            from slmsuite.hardware.cameras.remote import RemoteCamera
            from slmsuite.hardware.slms.remote import RemoteSLM
        else:
            from slmsuite_tpu.hardware.cameras.remote import RemoteCamera
            from slmsuite_tpu.hardware.slms.remote import RemoteSLM

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            slm = SimulatedSLM((64, 64), pitch_um=(8, 8), wav_um=0.78)
            slm.name = "slm"
            cam = SimulatedCamera(slm, (64, 64), pitch_um=(4, 4))
            cam.name = "cam"
            port = self._free_port()
            server = Server([slm, cam], port=port)
            thread = threading.Thread(
                target=server.listen, kwargs={"verbose": False}, daemon=True
            )
            thread.start()
            _time.sleep(0.5)

            rslm = RemoteSLM("slm", host="localhost", port=port)
            assert tuple(rslm.shape) == (64, 64)
            x = np.arange(64, dtype=np.float32)
            ramp = np.broadcast_to(0.3 * x, (64, 64)).copy()
            rslm.set_phase(ramp)
            if server_side == "ours":
                # Our SimulatedSLM stores remote writes, so the display
                # must show the actual quantized ramp, not a stale
                # frame (regression: a no-op _set_phase_hw passed a
                # max()>0 check with the initial constant display).
                assert np.unique(np.asarray(slm.display)).size > 4
            rcam = RemoteCamera("cam", host="localhost", port=port)
            img = np.asarray(rcam.get_image())
            assert img.shape == (64, 64)
            assert float(img.max()) > 0

    def test_our_clients_drive_reference_server(self, ref):
        del ref
        self._serve_and_drive(server_side="ref", client_side="ours")

    def test_reference_clients_drive_our_server(self, ref):
        del ref
        self._serve_and_drive(server_side="ours", client_side="ref")


class TestFileFormatInterop:
    """HDF5 file-format interop: data saved by one implementation loads
    in the other, so a lab can migrate its archives either way."""

    def test_calibration_h5_both_directions(self, ref, tmp_path):
        import warnings as _w

        del ref

        def make(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

            slm = SimulatedSLM((64, 64), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(slm, (64, 64), pitch_um=(4, 4))
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[2e3, 0.0], [0.0, 2e3]]),
                "b": np.array([[32.0], [32.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            return cs

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            for writer, reader in (("ours", "ref"), ("ref", "ours")):
                cs_w = make(writer)
                path = cs_w.save_calibration(
                    "fourier", path=str(tmp_path), name=f"interop_{writer}"
                )
                cs_r = make(reader)
                del cs_r.calibrations["fourier"]
                cs_r.load_calibration("fourier", file_path=path)
                np.testing.assert_array_equal(
                    np.asarray(cs_r.calibrations["fourier"]["M"]),
                    np.asarray(cs_w.calibrations["fourier"]["M"]),
                )

    def test_stats_h5_loads_in_reference(self, ref, tmp_path):
        """Our full-state stats file loads in the reference. (The
        converse is untestable: the reference's own save_stats is broken
        upstream — include_state=True reads a never-set self.method,
        include_state=False trips on object-dtype flags — so there are
        no reference-written files to migrate.)"""
        import warnings as _w

        del ref
        from slmsuite.holography.algorithms import Hologram as RefHologram

        from slmsuite_tpu.holography.algorithms import Hologram

        t = np.zeros((64, 64), np.float32)
        t[20, 30] = t[40, 24] = 1.0
        t /= np.sqrt((t**2).sum())
        amp = np.ones((64, 64), np.float32)
        amp /= np.sqrt((amp**2).sum())
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            h = Hologram(t.copy())
            h.optimize(
                "WGS-Kim", maxiter=6, verbose=False,
                stat_groups=["computational"],
            )
            path = str(tmp_path / "stats.h5")
            h.save_stats(path)
            hr = RefHologram(t.copy(), amp=amp)
            hr.load_stats(path)
        ours = np.asarray(h.stats["stats"]["computational"]["efficiency"])
        theirs = np.asarray(
            hr.stats["stats"]["computational"]["efficiency"]
        )
        np.testing.assert_allclose(theirs, ours, atol=0)

    def test_phase_h5_both_directions(self, ref, tmp_path):
        import warnings as _w

        del ref
        from slmsuite.hardware.slms.simulated import SimulatedSLM as RefSLM

        from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            s = SimulatedSLM((64, 64), pitch_um=(8, 8), wav_um=0.78)
            s.set_phase(np.ones((64, 64), np.float32))
            p1 = s.save_phase(path=str(tmp_path), name="ph")
            sr = RefSLM((64, 64), pitch_um=(8, 8), wav_um=0.78)
            sr.load_phase(p1)
            np.testing.assert_array_equal(
                np.asarray(sr.display), np.asarray(s.display)
            )
            sr.set_phase(np.full((64, 64), 2.0, np.float32))
            p2 = sr.save_phase(path=str(tmp_path), name="ph2")
            s.load_phase(p2)
            np.testing.assert_array_equal(
                np.asarray(s.display), np.asarray(sr.display)
            )


class TestTransformsDifferential:
    def test_kxy_ij_transforms_and_derived_optics(self, ref, rng):
        """kxyslm_to_ijcam / ijcam_to_kxyslm (2D and 3D with focal
        depth), effective focal length, farfield spot size, and
        calibrated-unit convert_vector across the device-unit matrix —
        all bit-identical (3D within double round-off) on a
        shear+offset Fourier calibration."""
        import warnings as _w

        del ref

        def rig(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(slm, (256, 256), pitch_um=(4, 4))
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[4e3, 150.0], [-150.0, 4e3]]),
                "b": np.array([[128.0], [120.0]]),
                "a": np.array([[0.001], [-0.002]]),
            }
            return cs

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            cs_t, cs_r = rig("ours"), rig("ref")
            v2 = rng.uniform(-8e-3, 8e-3, (2, 7))
            v3 = np.vstack([v2, rng.uniform(-2e-7, 2e-7, 7)])
            for v in (v2, v3):
                a = np.asarray(cs_t.kxyslm_to_ijcam(v))
                b = np.asarray(cs_r.kxyslm_to_ijcam(v))
                np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
                np.testing.assert_allclose(
                    np.asarray(cs_t.ijcam_to_kxyslm(a)),
                    np.asarray(cs_r.ijcam_to_kxyslm(b)),
                    atol=1e-12, rtol=0,
                )
            np.testing.assert_allclose(
                np.asarray(cs_t.get_effective_focal_length("norm")),
                np.asarray(cs_r.get_effective_focal_length("norm")),
                rtol=1e-14,
            )
            np.testing.assert_allclose(
                np.asarray(cs_t.get_farfield_spot_size()),
                np.asarray(cs_r.get_farfield_spot_size()),
                rtol=1e-14,
            )
            from slmsuite.holography import toolbox as rt

            from slmsuite_tpu.holography import toolbox as ot

            v = rng.uniform(-5e-3, 5e-3, (2, 5))
            for a_u in ("kxy", "ij", "norm", "knm", "freq", "lpmm",
                        "mrad", "um"):
                for b_u in ("kxy", "ij", "norm", "freq", "mrad", "um"):
                    x = np.asarray(ot.convert_vector(
                        v, a_u, b_u, hardware=cs_t, shape=(256, 256)
                    ))
                    y = np.asarray(rt.convert_vector(
                        v, from_units=a_u, to_units=b_u, hardware=cs_r,
                        shape=(256, 256),
                    ))
                    np.testing.assert_array_equal(
                        x, y, err_msg=f"{a_u}->{b_u}"
                    )


class TestCompressedMRAFDifferential:
    def test_compressed_noise_spots_match_reference(self, ref):
        """Per-spot MRAF in the grid-free loop (nan ``spot_amp`` =
        noise spots with amplitude freedom) reproduces the reference to
        float32 round-off — the noise spot retains its natural
        unit-norm-transform amplitude instead of being driven to zero.
        Regression: the constraint previously treated nan spots as
        zero targets (suppressed), and in carry mode an unnormalized
        noise-keep made the mix run away."""
        import warnings as _w

        del ref

        def build(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.algorithms import (
                    CompressedSpotHologram,
                )
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.algorithms import (
                    CompressedSpotHologram,
                )

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(slm, (64, 64), pitch_um=(4, 4))
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
                "b": np.array([[32.0], [32.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            side = 3
            kx, ky = np.meshgrid(
                np.linspace(-4e-3, 4e-3, side), np.linspace(-4e-3, 4e-3, side)
            )
            spots = np.vstack([
                kx.ravel(), ky.ravel(),
                np.linspace(-2e-7, 2e-7, side * side),
            ])
            amp = np.ones(9)
            amp[4] = np.nan  # Center spot: amplitude freedom.
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                holo = CompressedSpotHologram(
                    spots, basis="kxy", spot_amp=amp, cameraslm=cs
                )
                phase0 = np.random.default_rng(5).uniform(
                    -np.pi, np.pi, (128, 128)
                ).astype(np.float32)
                holo.reset_phase(phase0)
                holo.optimize("WGS-Kim", maxiter=4, verbose=False)
            ff = holo.amp_ff if which != "ref" else np.abs(holo.farfield)
            return (
                np.asarray(ff).ravel(),
                np.asarray(holo.weights).ravel(),
                np.asarray(holo.phase),
            )

        a_t, w_t, p_t = build("ours")
        a_r, w_r, p_r = build("ref")
        np.testing.assert_allclose(a_t, a_r, atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            w_t / max(w_t.max(), 1e-12), w_r / max(w_r.max(), 1e-12),
            atol=1e-5, rtol=0,
        )
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.percentile(np.abs(wrapped), 99) < 1e-4
        assert a_t[4] > 0.1  # The noise spot kept its amplitude.


class TestDefocusBlurDifferential:
    def test_multiplane_defocus_blur_bit_identical(self, ref):
        """``MultiplaneHologram.get_multiplane_defocus_blur`` (per-depth
        defocus PSF blur of multiplane targets) is bit-identical to the
        reference on the calibrated sim rig."""
        import warnings as _w

        del ref

        def run(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.algorithms import (
                    MultiplaneHologram,
                )
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.algorithms import (
                    MultiplaneHologram,
                )

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(slm, (128, 128), pitch_um=(4, 4))
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[2e3, 0.0], [0.0, 2e3]]),
                "b": np.array([[64.0], [64.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            targets = np.zeros((2, 128, 128), np.float32)
            targets[0, 50:60, 50:60] = 1.0
            targets[1, 70:90, 70:90] = 1.0
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                return np.asarray(
                    MultiplaneHologram.get_multiplane_defocus_blur(
                        cs, targets, target_depths=np.array([-1e-6, 1e-6])
                    )
                )

        np.testing.assert_array_equal(run("ours"), run("ref"))


class TestCompressedMRAFVariantsDifferential:
    @staticmethod
    def _run(which, **kwargs):
        import warnings as _w

        if which == "ref":
            from slmsuite.hardware.cameras.simulated import SimulatedCamera
            from slmsuite.hardware.cameraslms import FourierSLM
            from slmsuite.hardware.slms.simulated import SimulatedSLM
            from slmsuite.holography.algorithms import CompressedSpotHologram
        else:
            from slmsuite_tpu.hardware.cameras.simulated import (
                SimulatedCamera,
            )
            from slmsuite_tpu.hardware.cameraslms import FourierSLM
            from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
            from slmsuite_tpu.holography.algorithms import (
                CompressedSpotHologram,
            )

        slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = SimulatedCamera(slm, (64, 64), pitch_um=(4, 4))
        cs = FourierSLM(cam, slm)
        cs.calibrations["fourier"] = {
            "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
            "b": np.array([[32.0], [32.0]]),
            "a": np.array([[0.0], [0.0]]),
        }
        side = 3
        kx, ky = np.meshgrid(
            np.linspace(-4e-3, 4e-3, side), np.linspace(-4e-3, 4e-3, side)
        )
        spots = np.vstack([
            kx.ravel(), ky.ravel(), np.linspace(-2e-7, 2e-7, side * side)
        ])
        amp = np.ones(9)
        amp[4] = np.nan   # Noise spot.
        amp[2] = 0.0      # Null spot.
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            holo = CompressedSpotHologram(
                spots, basis="kxy", spot_amp=amp, cameraslm=cs
            )
            phase0 = np.random.default_rng(5).uniform(
                -np.pi, np.pi, (128, 128)
            ).astype(np.float32)
            holo.reset_phase(phase0)
            holo.optimize("WGS-Kim", maxiter=4, verbose=False, **kwargs)
        ff = holo.amp_ff if which != "ref" else np.abs(holo.farfield)
        return np.asarray(ff).ravel(), np.asarray(holo.phase)

    def test_zero_factor_evolution_matches_reference(self, ref):
        """Evolving zero-region weights on null spots (``zero_factor``)
        follow the reference's host-attribute evolution — routed here to
        the host loop, which carries ``_zero_weights_c`` like upstream's
        ``zero_weights``."""
        del ref
        a_t, p_t = self._run("ours", zero_factor=0.5)
        a_r, p_r = self._run("ref", zero_factor=0.5)
        np.testing.assert_allclose(a_t, a_r, atol=1e-5, rtol=0)
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.percentile(np.abs(wrapped), 99) < 1e-4

    def test_host_loop_mraf_matches_reference(self, ref):
        """The host-paced loop (forced by a callback — the camera
        feedback path) applies the SAME per-spot MRAF mix as the
        scanned engine. Regression: the stepwise backward transform
        used to drop the mix and suppress noise spots."""
        del ref
        a_t, p_t = self._run("ours", callback=lambda h: False)
        a_r, p_r = self._run("ref", callback=lambda h: False)
        np.testing.assert_allclose(a_t, a_r, atol=1e-5, rtol=0)
        assert a_t[4] > 0.1  # Noise spot kept amplitude on the host loop.

    def test_kim_trigger_without_stat_groups_runs(self, ref):
        """fix_phase_efficiency without a tracked stat group must not
        crash (the trigger computes the efficiency inline). Regression:
        IndexError at trace time."""
        del ref
        a_t, _ = self._run("ours", fix_phase_efficiency=0.9)
        assert np.isfinite(a_t).all()


class TestSpotNullRegionDifferential:
    def test_spot_hologram_null_region_matches_reference(self, ref):
        """Grid SpotHologram MRAF (nan background + imprinted null
        region around the 0th order) reproduces the reference loop to
        float32 round-off on the calibrated rig."""
        import warnings as _w

        del ref

        def build(which):
            if which == "ref":
                from slmsuite.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite.hardware.cameraslms import FourierSLM
                from slmsuite.hardware.slms.simulated import SimulatedSLM
                from slmsuite.holography.algorithms import SpotHologram
            else:
                from slmsuite_tpu.hardware.cameras.simulated import (
                    SimulatedCamera,
                )
                from slmsuite_tpu.hardware.cameraslms import FourierSLM
                from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
                from slmsuite_tpu.holography.algorithms import SpotHologram

            slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
            cam = SimulatedCamera(slm, (128, 128), pitch_um=(4, 4))
            cs = FourierSLM(cam, slm)
            cs.calibrations["fourier"] = {
                "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
                "b": np.array([[64.0], [64.0]]),
                "a": np.array([[0.0], [0.0]]),
            }
            spot_kxy = np.array(
                [[0.004, -0.004, 0.0], [0.004, 0.004, -0.006]]
            )
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                holo = SpotHologram(
                    (128, 128), spot_kxy, basis="kxy",
                    null_vectors=np.array([[0.0], [0.0]]),
                    null_region_radius_frac=0.05,
                    cameraslm=cs,
                )
                phase0 = np.random.default_rng(7).uniform(
                    -np.pi, np.pi, (128, 128)
                ).astype(np.float32)
                holo.reset_phase(phase0)
                holo.optimize("WGS-Leonardo", maxiter=6, verbose=False)
            ff = holo.amp_ff if which != "ref" else np.abs(holo.farfield)
            return np.asarray(holo.phase), np.asarray(np.abs(np.asarray(ff)))

        p_t, a_t = build("ours")
        p_r, a_r = build("ref")
        wrapped = np.angle(np.exp(1j * (p_t - p_r)))
        assert np.percentile(np.abs(wrapped), 99) < 1e-4
        np.testing.assert_allclose(a_t, a_r, atol=1e-5, rtol=0)


class TestTakeTileDifferential:
    def test_take_tile_bit_identical(self, ref, rng):
        from slmsuite_tpu.holography import analysis

        img = rng.random((64, 64)).astype(np.float32)
        vectors = np.array([[10.0, 30, 50], [12.0, 32, 52]])
        stack = np.asarray(analysis.take(img, vectors, size=9, centered=True))
        np.testing.assert_array_equal(
            np.asarray(analysis.take_tile(stack)),
            np.asarray(ref.analysis.take_tile(stack)),
        )


class TestPlotFarfieldDifferential:
    """plot_farfield unit rebasing pinned against the live reference:
    the image extents (after rebasing knm pixel edges through
    convert_vector into each blaze unit), the autocomputed zoom limits,
    and the axis labels must agree for every testable unit."""

    @staticmethod
    def _build(which):
        import warnings as _w

        if which == "ref":
            from slmsuite.hardware.cameras.simulated import SimulatedCamera
            from slmsuite.hardware.cameraslms import FourierSLM
            from slmsuite.hardware.slms.simulated import SimulatedSLM
            from slmsuite.holography.algorithms import SpotHologram
        else:
            from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera
            from slmsuite_tpu.hardware.cameraslms import FourierSLM
            from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
            from slmsuite_tpu.holography.algorithms import SpotHologram

        slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = SimulatedCamera(
            slm, (128, 128), pitch_um=(4, 4),
            M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
            b=np.array([[64.0], [64.0]]),
        )
        cs = FourierSLM(cam, slm)
        cs.calibrations["fourier"] = {
            "M": np.array([[2e3, 0.0], [0.0, 2e3]]),
            "b": np.array([[64.0], [64.0]]),
            "a": np.array([[0.0], [0.0]]),
        }
        spot_ij = np.array([[40.0, 88, 64], [64.0, 64, 88]])
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            holo = SpotHologram((256, 256), spot_ij, basis="ij", cameraslm=cs)
            phase0 = np.random.default_rng(7).uniform(
                -np.pi, np.pi, (128, 128)
            ).astype(np.float32)
            holo.reset_phase(phase0)
            holo.optimize("WGS-Kim", maxiter=3, verbose=False)
        return holo

    @staticmethod
    def _render(holo, units):
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(1, 2)
        try:
            limits = holo.plot_farfield(units=units, axs=axs)
            out = {
                "limits": np.asarray(limits, dtype=float),
                "full_extent": np.asarray(axs[0].images[0].get_extent(), float),
                "zoom_extent": np.asarray(axs[1].images[0].get_extent(), float),
                "xlabel": axs[0].get_xlabel(),
                "ylabel": axs[0].get_ylabel(),
                "n_lines": len(axs[0].lines),
            }
        finally:
            plt.close(fig)
        return out

    @pytest.mark.parametrize("units", ["knm", "kxy", "mrad", "deg", "freq", "lpmm"])
    def test_extents_match_reference(self, ref, units):
        del ref
        holo_t = self._build("ours")
        holo_r = self._build("ref")
        out_t = self._render(holo_t, units)
        out_r = self._render(holo_r, units)

        np.testing.assert_array_equal(out_t["limits"], out_r["limits"])
        np.testing.assert_allclose(
            out_t["full_extent"], out_r["full_extent"], rtol=1e-6, atol=1e-12
        )
        np.testing.assert_allclose(
            out_t["zoom_extent"], out_r["zoom_extent"], rtol=1e-6, atol=1e-12
        )
        assert out_t["xlabel"] == out_r["xlabel"]
        assert out_t["ylabel"] == out_r["ylabel"]
        if units != "knm":
            # The units kwarg must actually rebase (regression: a dead
            # kwarg rendered knm extents whatever the caller asked).
            knm = self._render(holo_t, "knm")
            assert not np.allclose(out_t["full_extent"], knm["full_extent"])

    def test_camera_fov_overlay(self, ref):
        """The camera field-of-view polyline renders on the full view
        (count the overlay lines; the reference draws the same one)."""
        del ref
        holo_t = self._build("ours")
        holo_r = self._build("ref")
        out_t = self._render(holo_t, "knm")
        out_r = self._render(holo_r, "knm")
        assert holo_t._cam_points is not None
        assert out_t["n_lines"] == out_r["n_lines"] >= 1

    def test_camera_units_rejected(self, ref):
        del ref
        holo = self._build("ours")
        with pytest.raises(ValueError):
            self._render(holo, "ij")


class TestSuperpixelProcessDifferential:
    """The superpixel-calibration PROCESSING stage pinned against the
    live reference on the SAME raw measurement dict: recovered source
    amplitude is bit-identical, recovered phase agrees after removing
    the global piston (a documented freedom: image_reduce_wraps picks
    its wrap-minimizing shift from slightly different border data).
    Documented deviations (docs/source/deviations.rst): (1) we fill the
    final SLM row/column that the reference's imprint drops (upstream
    window_slice clips window ends to shape-1); (2) untrusted
    superpixels are filled by BFS affine propagation rather than the
    reference's sweep-order majority vote — on physically consistent
    raw data both fills land on the same field."""

    @staticmethod
    def _build(which):
        if which == "ref":
            from slmsuite.hardware.cameras.simulated import SimulatedCamera
            from slmsuite.hardware.cameraslms import FourierSLM
            from slmsuite.hardware.slms.simulated import SimulatedSLM
        else:
            from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera
            from slmsuite_tpu.hardware.cameraslms import FourierSLM
            from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

        slm = SimulatedSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = SimulatedCamera(
            slm, (128, 128), pitch_um=(4, 4),
            M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
            b=np.array([[64.0], [64.0]]),
        )
        return FourierSLM(cam, slm)

    @staticmethod
    def _raw_measurement(slm, holey, seed=3):
        """r001-format raw dict sampled from one smooth truth wavefront
        (per-superpixel fringe gradients + anchored offsets), so the
        fill strategies under test face physically consistent data."""
        rng = np.random.default_rng(seed)
        NY = NX = 8
        sp = 16
        xg, yg = np.asarray(slm.grid[0]), np.asarray(slm.grid[1])
        truth = (
            40.0 * (xg**2 + yg**2) * 1e4 / 6.5
            + 3.0 * np.sin(xg * 3e2)
            + 2.0 * (xg * yg) * 1e4
        )
        gy, gx = np.gradient(truth)
        dx, dy = xg[0, 1] - xg[0, 0], yg[1, 0] - yg[0, 0]
        kx = np.zeros((NY, NX))
        ky = np.zeros((NY, NX))
        offset = np.zeros((NY, NX))
        for ny in range(NY):
            for nx in range(NX):
                sl = np.s_[ny * sp:(ny + 1) * sp, nx * sp:(nx + 1) * sp]
                kxv = gx[sl].mean() / dx / (2 * np.pi)
                kyv = gy[sl].mean() / dy / (2 * np.pi)
                kx[ny, nx], ky[ny, nx] = kxv, kyv
                offset[ny, nx] = np.mod(
                    truth[sl].mean()
                    - 2 * np.pi * (kxv * xg[sl].mean() + kyv * yg[sl].mean()),
                    2 * np.pi,
                )
        power = (1e3 * np.exp(-(xg**2 + yg**2) * 1e4 / 40) + 30).reshape(
            8, 16, 8, 16
        ).mean(axis=(1, 3))
        r2 = np.full((NY, NX), 0.98)
        if holey:
            holes = rng.random((NY, NX)) < 0.2
            holes[2:4, 5:7] = True     # A blob of failed fits.
            holes[4, 4] = False        # Keep the reference trusted.
            r2[holes] = 0.2
            kx[holes] = ky[holes] = offset[holes] = np.nan
        return {
            "NX": NX, "NY": NY, "nxref": 4, "nyref": 4,
            "superpixel_size": sp,
            "interference_point": np.array([64.0, 64.0]),
            "interference_size": np.array([8.0, 8.0]),
            "power": power,
            "normalization": np.full((NY, NX), 1.1e3),
            "background": np.zeros((NY, NX)),
            "phase": offset, "kx": kx, "ky": ky,
            "amp_fit": np.ones((NY, NX)),
            "contrast_fit": np.ones((NY, NX)),
            "r2_fit": r2,
        }

    @pytest.mark.parametrize("holey", [False, True])
    def test_process_matches_reference(self, ref, holey):
        import warnings as _w

        import cv2

        del ref
        out = {}
        for which in ("ours", "ref"):
            cs = self._build(which)
            data = self._raw_measurement(cs.slm, holey)
            cs.calibrations["wavefront"] = data
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                # remove_blaze=False: the power-weighted global-blaze fit
                # ingests the border band the reference never imprints,
                # so with it on the two sides differ by a global TILT
                # (documented alongside the piston freedom); the core
                # pipeline is pinned without it.
                out[which] = cs.wavefront_calibration_superpixel_process(
                    apply=False, plot=False, remove_blaze=False
                )

        np.testing.assert_array_equal(
            out["ours"]["amplitude"], out["ref"]["amplitude"]
        )
        np.testing.assert_array_equal(out["ours"]["r2"], out["ref"]["r2"])

        # Compare phase away from (a) the SLM border band the reference's
        # imprint never writes (+ smoothing diffusion), and (b) untrusted
        # superpixels (+ 1-superpixel erosion: the fill algorithms are a
        # documented deviation; their smoothing halo is excluded too).
        r2 = self._raw_measurement(self._build("ours").slm, holey)["r2_fit"]
        trusted = (r2 >= 0.9).astype(np.uint8)
        eroded = cv2.erode(
            trusted, np.ones((3, 3), np.uint8),
            borderType=cv2.BORDER_CONSTANT, borderValue=0,
        )
        mask = cv2.resize(
            eroded, (128, 128), interpolation=cv2.INTER_NEAREST
        ).astype(bool)
        mask[-24:, :] = mask[:, -24:] = False
        assert mask.sum() > (1200 if holey else 3000)

        diff = np.angle(
            np.exp(1j * (out["ours"]["phase"] - out["ref"]["phase"]))
        )
        # Remove the global piston (circular mean over the mask).
        piston = np.angle(np.exp(1j * diff[mask]).mean())
        residual = np.abs(np.angle(np.exp(1j * (diff - piston))))
        assert np.percentile(residual[mask], 99) < 0.05
        assert residual[mask].max() < 1.0  # Wrap-seam pixels only.
