"""Tests for CompressedSpotHologram and MultiplaneHologram."""

import numpy as np
import pytest

from slmsuite_tpu.holography.algorithms import (
    CompressedSpotHologram,
    Hologram,
    MultiplaneHologram,
    SpotHologram,
)


class TestSpotHologramFeedback:
    def test_computational_spot_converges(self, rng):
        shape = (128, 128)
        holo = SpotHologram.make_rectangular_array(shape, (4, 4), (16, 16), basis="knm")
        holo.reset_phase(rng.uniform(-np.pi, np.pi, shape).astype(np.float32))
        holo.optimize(
            "WGS-Kim",
            maxiter=20,
            verbose=False,
            feedback="computational_spot",
            stat_groups=["computational_spot"],
        )
        stats = holo.stats["stats"]["computational_spot"]
        assert stats["uniformity"][-1] > 0.9
        assert stats["efficiency"][-1] > 0.5

    def test_external_spot_feedback(self, rng):
        shape = (64, 64)
        holo = SpotHologram.make_rectangular_array(shape, (3, 3), (12, 12), basis="knm")
        # Pretend the measurement shows one dim spot: weights should boost it.
        external = np.full(9, 1.0)
        external[4] = 0.2
        holo.external_spot_amp = external
        holo.optimize(
            "WGS-Leonardo", maxiter=3, verbose=False, feedback="external_spot"
        )
        weights = holo.weights[
            holo.spot_knm_rounded[1, :], holo.spot_knm_rounded[0, :]
        ]
        assert weights[4] == np.max(weights)

    def test_spot_feedback_after_scanned_run(self):
        """Regression: a scanned (computational) run leaves the weights
        device-resident, so the host view is a read-only materialization;
        the subsequent spot-feedback scatter in ``_update_weights`` must
        copy-then-reassign instead of writing in place."""
        shape = (64, 64)
        holo = SpotHologram.make_rectangular_array(shape, (3, 3), (12, 12), basis="knm")
        holo.optimize("WGS-Leonardo", maxiter=3, verbose=False)
        assert holo._weights_dev is not None
        assert holo._weights_host is None
        external = np.full(9, 1.0)
        external[4] = 0.2
        holo.external_spot_amp = external
        holo.optimize(
            "WGS-Leonardo", maxiter=2, verbose=False, feedback="external_spot"
        )
        weights = holo.weights[
            holo.spot_knm_rounded[1, :], holo.spot_knm_rounded[0, :]
        ]
        assert weights[4] == np.max(weights)

    def test_sim_fast_path_matches_host_measure(self, fourierslm_calibrated, rng):
        """The device-resident simulated-measure composite produces the
        same spot powers and total as the host set_phase/get_image/take
        path, at the same hologram state."""
        fs = fourierslm_calibrated
        holo = SpotHologram(
            SpotHologram.get_padded_shape(fs),
            np.array([[300.0, 220.0], [220.0, 300.0]]),
            basis="ij",
            cameraslm=fs,
        )
        holo.optimize("WGS-Leonardo", maxiter=5, verbose=False)

        fast = holo._sim_spot_powers()
        assert fast is not None, "the simulated rig must qualify"
        pwr_fast, total_fast = fast

        from slmsuite_tpu.holography import analysis

        holo.img_ij = None
        holo.measure(basis="ij")
        pwr_img = np.square(np.asarray(holo.img_ij, np.float32))
        pwr_host = analysis.take(
            pwr_img, holo.spot_ij, holo.spot_integration_width_ij,
            centered=True, integrate=True,
        )
        np.testing.assert_allclose(pwr_fast, pwr_host, rtol=1e-4)
        np.testing.assert_allclose(total_fast, np.sum(pwr_img), rtol=1e-4)

        # Disqualifying rigs (noise model) keep the host path.
        fs.cam.noise = {"dark": lambda x: 0 * x}
        holo._sim_composite_cache = None
        holo._sim_powers_value = None
        assert holo._sim_spot_powers() is None
        fs.cam.noise = None

    def test_experimental_loop_fast_path_converges(self, fourierslm_calibrated, rng):
        """The closed experimental-feedback loop through the fast path
        improves measured uniformity like the reference loop."""
        fs = fourierslm_calibrated
        holo = SpotHologram(
            SpotHologram.get_padded_shape(fs),
            np.array([[300.0, 220.0, 260.0], [220.0, 300.0, 260.0]]),
            basis="ij",
            cameraslm=fs,
        )
        holo.optimize("WGS-Kim", maxiter=8, verbose=False)
        holo.optimize(
            "WGS-Kim", maxiter=6, verbose=False,
            feedback="experimental_spot", stat_groups=["experimental_spot"],
        )
        unif = holo.stats["stats"]["experimental_spot"]["uniformity"]
        assert unif[-1] > 0.9
        assert holo._sim_powers_value is not None or holo._sim_composite() is not None

    def test_experimental_sim_loop_runs_in_engine(self, fourierslm_calibrated, rng):
        """On a qualifying simulated rig the experimental-feedback loop
        runs device-resident inside the scanned engine (feedback mode
        'experimental_spot_sim'), and its trajectory is identical to the
        host-paced stepwise loop (forced via a callback)."""
        fs = fourierslm_calibrated
        spot_ij = np.array([[300.0, 220.0, 260.0], [220.0, 300.0, 260.0]])

        def make_holo():
            holo = SpotHologram(
                SpotHologram.get_padded_shape(fs), spot_ij.copy(),
                basis="ij", cameraslm=fs,
            )
            holo.reset_phase(
                custom_phase=np.random.default_rng(7)
                .uniform(-np.pi, np.pi, holo.slm_shape)
                .astype(np.float32)
            )
            return holo

        a = make_holo()
        assert a.flags.setdefault("feedback", "experimental_spot") or True
        assert a._engine_feedback() == "experimental_spot_sim"

        b = make_holo()
        a.optimize(
            "WGS-Kim", maxiter=6, verbose=False,
            feedback="experimental_spot", stat_groups=["experimental_spot"],
        )
        b.optimize(
            "WGS-Kim", maxiter=6, verbose=False,
            feedback="experimental_spot", stat_groups=["experimental_spot"],
            callback=lambda h: False,  # Forces the host stepwise loop.
        )

        sa = a.stats["stats"]["experimental_spot"]
        sb = b.stats["stats"]["experimental_spot"]
        np.testing.assert_allclose(
            sa["efficiency"][1:], sb["efficiency"][1:], rtol=1e-5
        )
        np.testing.assert_allclose(
            sa["uniformity"][1:], sb["uniformity"][1:], rtol=1e-5, atol=1e-6
        )
        dphi = np.angle(np.exp(1j * (np.asarray(a.phase) - np.asarray(b.phase))))
        assert np.max(np.abs(dphi)) < 1e-4
        wa = np.asarray(a.weights); wb = np.asarray(b.weights)
        np.testing.assert_allclose(
            wa / np.linalg.norm(wa), wb / np.linalg.norm(wb),
            rtol=1e-5, atol=1e-7,
        )

    def test_experimental_sim_loop_scrambled_engine(self, fourierslm_calibrated, rng):
        """Same device-resident closed loop under the scrambled (four-step
        layout) promotion: the spot scatter indices are remapped but psi
        stays natural for the in-scan camera model."""
        from slmsuite_tpu.ops import engine as E
        from slmsuite_tpu.ops import fft as F

        fs = fourierslm_calibrated
        spot_ij = np.array([[300.0, 220.0], [220.0, 300.0]])

        def make_holo():
            holo = SpotHologram(
                SpotHologram.get_padded_shape(fs), spot_ij.copy(),
                basis="ij", cameraslm=fs,
            )
            holo.reset_phase(
                custom_phase=np.random.default_rng(3)
                .uniform(-np.pi, np.pi, holo.slm_shape)
                .astype(np.float32)
            )
            return holo

        prev = F.get_fft_backend()
        F.set_fft_backend("matmul")
        E.set_scrambled_mode(True)
        try:
            a = make_holo()
            a.optimize(
                "WGS-Kim", maxiter=5, verbose=False,
                feedback="experimental_spot", stat_groups=["experimental_spot"],
            )
        finally:
            E.set_scrambled_mode(False)
            F.set_fft_backend(prev)
        b = make_holo()
        b.optimize(
            "WGS-Kim", maxiter=5, verbose=False,
            feedback="experimental_spot", stat_groups=["experimental_spot"],
            callback=lambda h: False,
        )
        sa = a.stats["stats"]["experimental_spot"]
        sb = b.stats["stats"]["experimental_spot"]
        np.testing.assert_allclose(
            sa["uniformity"][1:], sb["uniformity"][1:], rtol=1e-4, atol=1e-5
        )
        dphi = np.angle(np.exp(1j * (np.asarray(a.phase) - np.asarray(b.phase))))
        assert np.max(np.abs(dphi)) < 5e-3

    def test_disqualified_rig_keeps_host_loop(self, fourierslm_calibrated, rng):
        """A rig the composite cannot model exactly (noise) routes the
        experimental loop through the host stepwise path."""
        fs = fourierslm_calibrated
        holo = SpotHologram(
            SpotHologram.get_padded_shape(fs),
            np.array([[300.0, 220.0], [220.0, 300.0]]),
            basis="ij", cameraslm=fs,
        )
        fs.cam.noise = {"dark": lambda x: 0 * x}
        try:
            holo.flags["feedback"] = "experimental_spot"
            assert holo._engine_feedback() == "external_spot"
            holo.optimize(
                "WGS-Kim", maxiter=3, verbose=False,
                feedback="experimental_spot", stat_groups=["experimental_spot"],
            )
            assert len(holo.stats["stats"]["experimental_spot"]["uniformity"]) == 3
        finally:
            fs.cam.noise = None

    def test_refine_offset_on_sim(self, fourierslm_calibrated, rng):
        fs = fourierslm_calibrated
        holo = SpotHologram(
            SpotHologram.get_padded_shape(fs),
            np.array([[300.0, 220.0], [220.0, 300.0]]),
            basis="ij",
            cameraslm=fs,
        )
        holo.optimize("WGS-Leonardo", maxiter=10, verbose=False)
        shifts = holo.refine_offset(basis="kxy")
        assert shifts.shape == (2, 2)
        assert np.all(np.abs(shifts) < 5)  # Sim is near-perfect already.


class TestFeedbackHologramExperimental:
    def test_image_feedback_loop_runs(self, fourierslm_calibrated, rng):
        """Camera-image (non-spot) experimental feedback drives the
        host-paced loop end to end on the simulated rig (regression: the
        engine-config build used to reject feedback='experimental' on
        FeedbackHologram instances)."""
        from slmsuite_tpu.holography.algorithms import FeedbackHologram

        fs = fourierslm_calibrated
        target_ij = np.zeros(fs.cam.shape, np.float32)
        target_ij[200:320:40, 200:320:40] = 1.0

        holo = FeedbackHologram(
            (512, 512), target_ij=target_ij, cameraslm=fs
        )
        holo.flags["feedback"] = "experimental"
        assert holo._engine_feedback() == "external"
        holo.optimize(
            "WGS-Kim", maxiter=4, verbose=False,
            feedback="experimental", stat_groups=["experimental"],
        )
        stats = holo.stats["stats"]["experimental_ij"]
        assert len(stats["efficiency"]) == 4
        assert np.isfinite(stats["efficiency"][-1])


class TestCompressedSpotHologram:
    def test_construct_and_optimize(self, fourierslm_calibrated, rng):
        fs = fourierslm_calibrated
        spots_kxy = np.vstack(
            [rng.uniform(-0.01, 0.01, 5), rng.uniform(-0.01, 0.01, 5)]
        )
        holo = CompressedSpotHologram(spots_kxy, basis="kxy", cameraslm=fs)
        assert len(holo) == 5
        assert holo.spot_zernike.shape[1] == 5

        holo.optimize("WGS-Kim", maxiter=15, verbose=False)
        # Uniform targets: converged amplitudes should be near-uniform.
        assert np.std(holo.amp_ff) / np.mean(holo.amp_ff) < 0.05

    def test_3d_spots(self, fourierslm_calibrated, rng):
        fs = fourierslm_calibrated
        spots = np.vstack(
            [
                rng.uniform(-0.01, 0.01, 4),
                rng.uniform(-0.01, 0.01, 4),
                rng.uniform(-1e-6, 1e-6, 4),
            ]
        )
        holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=fs)
        assert holo.zernike_basis.tolist() == [2, 1, 4]
        holo.optimize("GS", maxiter=5, verbose=False)
        assert np.all(np.isfinite(holo.amp_ff))

    def test_custom_zernike_basis(self, fourierslm_calibrated, rng):
        fs = fourierslm_calibrated
        # x, y, focus, astig
        spots = np.vstack(
            [
                rng.uniform(-5, 5, 3),
                rng.uniform(-5, 5, 3),
                rng.uniform(-0.1, 0.1, 3),
                rng.uniform(-0.1, 0.1, 3),
            ]
        )
        holo = CompressedSpotHologram(
            spots, basis=[2, 1, 4, 3], cameraslm=fs
        )
        assert len(holo) == 3
        holo.optimize("GS", maxiter=3, verbose=False)

    def test_requires_cameraslm(self):
        with pytest.raises(ValueError):
            CompressedSpotHologram(np.zeros((2, 3)))

    def test_basis_must_include_xy(self, fourierslm_calibrated):
        with pytest.raises(ValueError):
            CompressedSpotHologram(
                np.zeros((2, 3)), basis=[4, 3], cameraslm=fourierslm_calibrated
            )

    def test_no_padded_shape(self, fourierslm_calibrated, rng):
        spots = np.vstack([rng.uniform(-0.01, 0.01, 2)] * 2)
        holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=fourierslm_calibrated)
        with pytest.raises(NameError):
            holo.get_padded_shape()

    def test_fused_iteration_pallas_matches_twin(self, rng):
        """The fused compressed round-trip kernel (one sincos per
        iteration) matches both the jnp twin and the unfused transform
        composition (interpreter mode)."""
        import jax.numpy as jnp

        from slmsuite_tpu.ops import compressed as C
        from slmsuite_tpu.ops import pallas_compressed as PC

        D, P, N = 4, 3000, 17  # deliberately unaligned sizes
        basis = jnp.asarray(rng.normal(size=(D, P)).astype(np.float32) * 2)
        coeffs = jnp.asarray(rng.normal(size=(D, N)).astype(np.float32) * 5)
        ffr = jnp.asarray(rng.normal(size=(N,)).astype(np.float32))
        ffi = jnp.asarray(rng.normal(size=(N,)).astype(np.float32))
        amp_plane = jnp.asarray(
            (0.5 + rng.uniform(0, 1, P)).astype(np.float32)
        )

        for amp in (jnp.float32(1.0), amp_plane):
            # Composition reference: f2n -> amp * nf/|nf| -> raw n2f.
            nr, ni = C.farfield_to_nearfield(ffr, ffi, coeffs, basis, N)
            mag = jnp.sqrt(nr**2 + ni**2)
            ur, ui = amp * nr / mag, amp * ni / mag
            want_r, want_i = C.nearfield_to_farfield_raw(
                ur, ui, coeffs, basis, N
            )
            # The fused path drops the internal 1/sqrt(P) scales: compare
            # directions after unit normalization.
            def unit(a, b):
                n = np.sqrt(float(jnp.sum(a * a + b * b)))
                return np.asarray(a) / n, np.asarray(b) / n

            ref = unit(want_r, want_i)
            tw = unit(*C._fused_iteration_jnp(ffr, ffi, coeffs, basis, amp, N))
            np.testing.assert_allclose(tw[0], ref[0], atol=2e-5)
            np.testing.assert_allclose(tw[1], ref[1], atol=2e-5)

            got = unit(*PC.fused_iteration(
                ffr, ffi, coeffs, basis, amp, N, interpret=True
            ))
            np.testing.assert_allclose(got[0], ref[0], atol=2e-5)
            np.testing.assert_allclose(got[1], ref[1], atol=2e-5)

    def test_kernel_cache_matches_recompute(self, rng):
        """The cached-kernel transform twins (cos/sin tiles streamed
        from device memory) match the recompute path — the cache is built with
        the identical einsum/sincos, so tolerances are tight."""
        import jax.numpy as jnp

        from slmsuite_tpu.ops import compressed as C

        D, P, N = 4, 3000, 17  # deliberately unaligned sizes
        basis = jnp.asarray(rng.normal(size=(D, P)).astype(np.float32) * 2)
        coeffs = jnp.asarray(rng.normal(size=(D, N)).astype(np.float32) * 5)
        ffr = jnp.asarray(rng.normal(size=(N,)).astype(np.float32))
        ffi = jnp.asarray(rng.normal(size=(N,)).astype(np.float32))
        nfr = jnp.asarray(rng.normal(size=(P,)).astype(np.float32))
        nfi = jnp.asarray(rng.normal(size=(P,)).astype(np.float32))
        amp_plane = jnp.asarray(
            (0.5 + rng.uniform(0, 1, P)).astype(np.float32)
        )

        kc, ks = C.build_kernel_cache(coeffs, basis)
        n_tiles = -(-P // C.PIXEL_TILE)
        assert kc.shape == (n_tiles, N, C.PIXEL_TILE)

        want = C.farfield_to_nearfield(ffr, ffi, coeffs, basis, N)
        got = C.farfield_to_nearfield_cached(ffr, ffi, kc, ks, P)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], atol=1e-6)

        want = C.nearfield_to_farfield(nfr, nfi, coeffs, basis, N)
        got = C.nearfield_to_farfield_cached(nfr, nfi, kc, ks, P)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)

        for amp in (jnp.float32(1.0), amp_plane):
            want = C._fused_iteration_jnp(ffr, ffi, coeffs, basis, amp, N)
            got = C.fused_iteration_cached(ffr, ffi, kc, ks, amp, N, P)
            assert got[0].shape == (N,)
            np.testing.assert_allclose(got[0], want[0], atol=1e-4)
            np.testing.assert_allclose(got[1], want[1], atol=1e-4)

    def test_kernel_cache_engine_parity(
        self, fourierslm_calibrated, rng, monkeypatch
    ):
        """optimize() with the kernel cache enabled produces the same
        trajectory as the recompute engine (WGS-Kim, 3D spots)."""

        def run(cache_mb):
            monkeypatch.setenv("SLMSUITE_TPU_COMPRESSED_CACHE_MB", cache_mb)
            spots = np.vstack([
                np.random.default_rng(7).uniform(-0.01, 0.01, (2, 9)),
                np.random.default_rng(8).uniform(-2e-6, 2e-6, (1, 9)),
            ])
            holo = CompressedSpotHologram(
                spots, basis="kxy", cameraslm=fourierslm_calibrated
            )
            holo.reset_phase(np.zeros(holo.slm_shape, np.float32))
            holo.optimize("WGS-Kim", maxiter=10, verbose=False)
            assert holo._kernel_cache_enabled() == (cache_mb != "0")
            return (
                np.asarray(holo.phase),
                np.asarray(holo.amp_ff),
                np.asarray(holo.weights),
            )

        p0, a0, w0 = run("0")
        p1, a1, w1 = run("4096")
        np.testing.assert_allclose(a1, a0, atol=1e-5)
        np.testing.assert_allclose(w1, w0, atol=1e-5)
        np.testing.assert_allclose(p1, p0, atol=5e-3)

    def test_kernel_cache_invalidates_on_spot_mutation(
        self, fourierslm_calibrated, rng
    ):
        """Mutating spot coefficients rebuilds the cached kernel tiles;
        unchanged inputs reuse the same device arrays."""
        spots = np.vstack([rng.uniform(-0.01, 0.01, 4)] * 2)
        holo = CompressedSpotHologram(
            spots, basis="kxy", cameraslm=fourierslm_calibrated
        )
        c = holo._compressed_consts(kernel_cache=True)
        kc0 = c["kc_tiles"]
        assert holo._compressed_consts(kernel_cache=True)["kc_tiles"] is kc0
        holo.spot_zernike[0, :] += 0.25
        kc1 = holo._compressed_consts(kernel_cache=True)["kc_tiles"]
        assert kc1 is not kc0
        assert not np.allclose(np.asarray(kc1), np.asarray(kc0))

    def test_kernel_cache_invalidates_on_device_array_replacement(
        self, fourierslm_calibrated, rng
    ):
        """Replacing spot coefficients with a DEVICE array must rebuild
        the cached kernel tiles: for device arrays the host fingerprint
        is None, so without the identity check the cache would compare
        (None, None) == (None, None) and silently reuse stale cos/sin
        tiles aimed at the old spot positions."""
        import jax.numpy as jnp

        spots = np.vstack([rng.uniform(-0.01, 0.01, 4)] * 2)
        holo = CompressedSpotHologram(
            spots, basis="kxy", cameraslm=fourierslm_calibrated
        )
        holo.spot_zernike = jnp.asarray(holo.spot_zernike, jnp.float32)
        kc0 = holo._compressed_consts(kernel_cache=True)["kc_tiles"]
        # Same device object: cache hit.
        assert holo._compressed_consts(kernel_cache=True)["kc_tiles"] is kc0
        holo.spot_zernike = holo.spot_zernike + 0.25
        kc1 = holo._compressed_consts(kernel_cache=True)["kc_tiles"]
        assert kc1 is not kc0
        assert not np.allclose(np.asarray(kc1), np.asarray(kc0))

    def test_populate_and_finalize_fns_rekey_on_spot_count(
        self, fourierslm_calibrated, rng
    ):
        """The jitted populate/finalize epilogues freeze n_spots into
        their closures; their instance caches must be KEYED on it so a
        rebuilt spot set of a different count never slices the packed
        result vector with a stale length."""
        spots = np.vstack([rng.uniform(-0.01, 0.01, 4)] * 2)
        holo = CompressedSpotHologram(
            spots, basis="kxy", cameraslm=fourierslm_calibrated
        )
        holo._populate_results()
        key, fn = holo._populate_fn
        assert key == (len(holo), holo.cuda)
        # A stale-key cache entry is ignored and replaced.
        holo._populate_fn = ((len(holo) + 3, holo.cuda), fn)
        holo._populate_results()
        assert holo._populate_fn[0] == (len(holo), holo.cuda)
        assert holo.amp_ff.shape == (len(holo),)

    def test_dev_cache_invalidates_on_inplace_mutation(
        self, fourierslm_calibrated, rng
    ):
        """In-place mutation of target / spot_zernike between optimize()
        calls (a standard feedback-loop workflow in the reference) must
        not silently reuse stale device constants."""
        spots = np.vstack([rng.uniform(-0.01, 0.01, 4)] * 2)
        holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=fourierslm_calibrated)

        t0 = np.asarray(holo._compressed_consts()["target"])
        holo.target[...] = np.array([4.0, 3.0, 2.0, 1.0], holo.target.dtype)
        t1 = np.asarray(holo._compressed_consts()["target"])
        assert not np.allclose(t0, t1)
        np.testing.assert_allclose(t1, holo.target, rtol=1e-6)

        c0 = np.asarray(holo._compressed_consts()["coeffs"])
        holo.spot_zernike[0, :] += 0.25
        c1 = np.asarray(holo._compressed_consts()["coeffs"])
        assert not np.allclose(c0[0], c1[0])
        np.testing.assert_allclose(c1, holo.spot_zernike, rtol=1e-6)

        # Unchanged arrays still hit the cache (same device object).
        assert holo._compressed_consts()["coeffs"] is holo._compressed_consts()["coeffs"]


class TestMultiplaneHologram:
    def _children(self, rng, B=3, shape=(64, 64)):
        amp = np.ones(shape, np.float32)
        children = []
        for b in range(B):
            target = np.zeros(shape, np.float32)
            target[20 + 8 * b, 24 + 6 * b] = 1
            kernel = np.full(shape, 0.2 * b, np.float32)
            children.append(
                Hologram(target, amp=amp.copy(), slm_shape=shape, propagation_kernel=kernel)
            )
        return children

    def test_optimize(self, rng):
        holo = MultiplaneHologram(self._children(rng))
        holo.optimize(
            "WGS-Leonardo", maxiter=15, verbose=False, stat_groups=["computational"]
        )
        for child in holo.holograms:
            eff = child.stats["stats"]["computational"]["efficiency"]
            assert eff[-1] > 0.1
            assert eff[-1] > eff[0]

    def test_shared_phase(self, rng):
        holo = MultiplaneHologram(self._children(rng))
        holo.optimize("GS", maxiter=3, verbose=False)
        assert holo.phase.shape == (64, 64)

    def test_rejects_recursion(self, rng):
        inner = MultiplaneHologram(self._children(rng))
        with pytest.raises(ValueError):
            MultiplaneHologram([inner])

    def test_set_target_raises(self, rng):
        holo = MultiplaneHologram(self._children(rng))
        with pytest.raises(RuntimeError):
            holo.set_target(None)

    def test_weights_normalized(self, rng):
        holo = MultiplaneHologram(self._children(rng), weights=[1, 2, 3])
        assert np.isclose(np.sum(np.square(holo.weights)), 1)


class TestCGVariants:
    """optimize_cg overrides for compressed and multiplane holograms."""

    def test_compressed_cg(self, fourierslm_calibrated, rng):
        fs = fourierslm_calibrated
        spots_kxy = rng.uniform(-0.01, 0.01, size=(2, 10))
        holo = CompressedSpotHologram(spots_kxy, basis="kxy", cameraslm=fs)
        holo.optimize("CG", maxiter=60, verbose=False,
                      optimizer_kwargs={"learning_rate": 0.3})
        assert holo.flags["loss_result"] < 2e-4
        amps = holo.amp_ff / np.sqrt(np.sum(holo.amp_ff**2))
        target = holo.target / np.sqrt(np.sum(holo.target**2))
        # Spot amplitudes approach the uniform target.
        assert np.max(np.abs(amps - target)) < 0.15

    def test_compressed_cg_matches_gs_quality(self, fourierslm_calibrated, rng):
        fs = fourierslm_calibrated
        spots_kxy = rng.uniform(-0.008, 0.008, size=(2, 6))
        cg = CompressedSpotHologram(spots_kxy.copy(), basis="kxy", cameraslm=fs)
        cg.optimize("CG", maxiter=120, verbose=False,
                    optimizer_kwargs={"learning_rate": 0.3})
        gs = CompressedSpotHologram(spots_kxy.copy(), basis="kxy", cameraslm=fs)
        gs.optimize("GS", maxiter=10, verbose=False)

        def uniformity(h):
            a = h.amp_ff / np.sqrt(np.sum(h.amp_ff**2))
            return 1 - (np.max(a) - np.min(a)) / (np.max(a) + np.min(a))

        assert uniformity(cg) > 0.7

    def test_multiplane_cg(self, rng):
        holo = MultiplaneHologram(self._mp_children(rng))
        holo.optimize("CG", maxiter=80, verbose=False,
                      optimizer_kwargs={"learning_rate": 0.2})
        first_loss = holo.flags["loss_result"]
        # Each plane should concentrate power on its target spot.
        for child in holo.holograms:
            child._populate_results()
            amp_ff = np.asarray(child.amp_ff)
            i, j = np.unravel_index(np.argmax(np.nan_to_num(child.target)),
                                    child.target.shape)
            window = amp_ff[i - 2:i + 3, j - 2:j + 3]
            frac = np.sum(window**2) / np.sum(amp_ff**2)
            assert frac > 0.05, frac

    def _mp_children(self, rng, B=2, shape=(64, 64)):
        amp = np.ones(shape, np.float32)
        children = []
        for b in range(B):
            target = np.zeros(shape, np.float32)
            target[20 + 10 * b, 24 + 8 * b] = 1
            kernel = np.full(shape, 0.2 * b, np.float32)
            children.append(
                Hologram(target, amp=amp.copy(), slm_shape=shape,
                         propagation_kernel=kernel)
            )
        return children


@pytest.mark.slow
class TestWavefrontZernike:
    def test_zernike_calibration_smoke(self, fourierslm_calibrated):
        fs = fourierslm_calibrated
        cal = fs.wavefront_calibrate_zernike(
            calibration_points=9,
            zernike_indices=5,
            perturbation=np.linspace(-0.5, 0.5, 5),
            optimize_weights=2,
            plot=-1,
        )
        assert "corrected_spots" in cal
        assert cal["corrected_spots"].shape[0] == 5


@pytest.mark.slow
class TestWavefrontSuperpixel:
    def test_superpixel_calibration_smoke(self, fourierslm_calibrated):
        fs = fourierslm_calibrated
        cal = fs.wavefront_calibrate_superpixel(
            calibration_points=np.array([[330.0], [220.0]]),
            superpixel_size=128,
            phase_steps=4,
            plot=-1,
        )
        assert "phase" in cal
        processed = fs.wavefront_calibration_superpixel_process(
            apply=True, smooth=2, plot=False
        )
        assert processed["phase"].shape == fs.slm.shape
        assert processed["amplitude"].shape == fs.slm.shape
        assert "phase" in fs.slm.source


def test_multiplane_meshless_scanned_promotion(monkeypatch):
    """Fully-computational meshless multiplane runs route through the
    batched scanned engine (single-device mesh), not the host loop."""
    import numpy as np

    from slmsuite_tpu.holography.algorithms import Hologram, MultiplaneHologram

    N = 64
    children = []
    for b in range(2):
        t = np.zeros((N, N), np.float32)
        t[20 + 8 * b, 24] = 1.0
        children.append(Hologram(t, slm_shape=(N, N)))
    np.random.seed(0)
    mp = MultiplaneHologram(children)

    called = {}
    orig = MultiplaneHologram._optimize_gs_mesh

    def spy(self, maxiter, verbose, name, mesh=None):
        called["mesh"] = mesh
        return orig(self, maxiter, verbose, name, mesh=mesh)

    monkeypatch.setattr(MultiplaneHologram, "_optimize_gs_mesh", spy)
    mp.optimize("WGS-Leonardo", maxiter=4, verbose=False,
                stat_groups=["computational"])
    assert "mesh" in called and called["mesh"] is not None
    assert int(np.prod(list(called["mesh"].shape.values()))) == 1
    assert np.isfinite(np.asarray(mp.phase)).all()

    # A callback forces the host meta loop (promotion must NOT engage).
    called.clear()
    mp.optimize("WGS-Leonardo", maxiter=2, verbose=False,
                callback=lambda h: False,
                stat_groups=["computational"])
    assert "mesh" not in called
