r"""
Optical focus arrays: :class:`SpotHologram` (DFT grid based) and
:class:`CompressedSpotHologram` (grid-free Zernike basis).

Parity: reference ``slmsuite/holography/algorithms/_spots.py``
(_AbstractSpotHologram :8-172, CompressedSpotHologram :174-1089,
SpotHologram :1090-1697).

Implementation notes: spot-integrated feedback inside the computational loop
runs as a precomputed gather inside the scanned engine
(:meth:`ops.engine.spot_gather_indices`); the compressed near/farfield
transforms are matmul pipelines (:mod:`slmsuite_tpu.ops.compressed`)
replacing the reference's CUDA kernels (``cuda.cu:95-288``).
"""

import warnings

import numpy as np

import jax
import jax.numpy as jnp

from slmsuite_tpu.holography import analysis, toolbox
from slmsuite_tpu.holography.algorithms._feedback import FeedbackHologram
from slmsuite_tpu.holography.algorithms._hologram import Hologram
from slmsuite_tpu.misc.math import REAL_TYPES
from slmsuite_tpu.ops import engine as _engine
from slmsuite_tpu.ops.weights import update_weights_generic


class _AbstractSpotHologram(FeedbackHologram):
    """
    Shared spot logic: :meth:`refine_offset` and experimental/external spot
    statistics (ref ``_spots.py:8-172``).
    """

    def remove_vortices(self):
        """Spot holograms do not need to consider vortices."""

    # ------------------------------------------------------------------
    # Device-resident closed loop for the simulated rig.
    # ------------------------------------------------------------------

    def _midloop_cleaning(self):
        super()._midloop_cleaning()
        self._sim_powers_value = None

    def _sim_spot_powers(self):
        """
        Fast path for the simulated closed loop: the whole per-iteration
        measurement — quantized-display formation, simulated far-field,
        camera sampling, saturation, spot-window integration — runs as
        ONE jitted device composite; only the ``(N,)`` spot powers and a
        scalar total cross to the host (the psi -> set_phase -> image
        host round trips dominate the loop otherwise). Returns ``(spot_powers, total)`` or None when the
        rig doesn't qualify (real hardware, noise models, orientation
        transforms, averaging/HDR, non-pow2 bitdepth, out-of-frame
        integration windows — all of which keep the exact host path).

        Note: unlike :meth:`measure`, the fast path does NOT write the
        intermediate phases to the (simulated) SLM display; write the
        final phase with ``slm.set_phase(hologram)`` as usual.
        """
        cached = getattr(self, "_sim_powers_value", None)
        if cached is not None:
            return cached
        run = self._sim_composite()
        if run is None:
            return None
        spots, total = run(self._psi_device())
        out = (np.asarray(spots), float(total))
        self._sim_powers_value = out
        return out

    #: Subclasses whose psi is a (slm_shape) folded DFT phase opt in to
    #: the simulated fast path (the compressed hologram's grid-free psi
    #: has different fold semantics and keeps the host loop).
    _sim_fast_path = False

    #: Per-iteration cache of the one-shot fast measure (host loop only;
    #: cleared by :meth:`_midloop_cleaning`).
    _sim_powers_value = None

    # _host_fingerprint/_dev_const live on the Hologram base class.

    def _sim_engine_inputs(self):
        """
        Qualification + ingredients of the device-resident simulated
        measure (shared by the one-shot fast measure and the in-scan
        closed loop :meth:`ops.engine.sim_measure_spots`). Returns
        ``(consts, statics)`` — loop-invariant device arrays and the
        static kwargs of ``sim_measure_spots`` (minus the dynamic
        ``sim_scale``) — or None when the rig doesn't qualify (real
        hardware, noise models, orientation transforms, averaging/HDR,
        non-pow2 bitdepth, out-of-frame integration windows — all of
        which keep the exact host path).
        """
        if not self._sim_fast_path:
            return None
        cs = self.cameraslm
        if cs is None or not hasattr(cs, "cam") or not hasattr(cs, "slm"):
            return None
        from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera
        from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM

        cam, slm = cs.cam, cs.slm
        if not (isinstance(cam, SimulatedCamera) and isinstance(slm, SimulatedSLM)):
            return None
        if cam.noise is not None or cam.averaging is not None or cam.hdr is not None:
            return None
        if slm.phase_scaling != 1 or (slm.bitresolution & (slm.bitresolution - 1)):
            return None
        if not getattr(cam, "_interpolate", False) or not hasattr(cam, "_hologram"):
            return None
        probe = np.arange(6, dtype=float).reshape(2, 3)
        if not np.array_equal(cam.transform(probe), probe):
            return None
        if getattr(self, "spot_ij", None) is None or self.spot_integration_width_ij is None:
            return None

        # Cache key: identity + strided content fingerprint of every
        # input array (mirroring :meth:`_dev_const`). Identity alone is
        # unsound twice over: in-place mutation (wavefront-calibration
        # updates to ``slm.source["phase"]``) never changes ``id()``,
        # and after ``refine_offset`` reassigns ``spot_ij`` the freed
        # array's address can be recycled by the replacement — the
        # cache entry below also HOLDS the keyed arrays so a live key
        # can never alias a dead array's id.
        keyed_arrays = (
            self.spot_ij, cam.knm_cam,
            slm.source.get("amplitude_sim"), slm.source.get("phase_sim"),
            slm.source.get("phase"), self.propagation_kernel,
        )
        key = tuple(
            (id(a), self._host_fingerprint(a)) for a in keyed_arrays
        ) + (int(self.spot_integration_width_ij),)
        cached = getattr(self, "_sim_inputs_cache", None)
        if cached is not None and cached[0] == key:
            return cached[2]

        from slmsuite_tpu.ops.propagation import checkerboard, pad_window_slices

        slm_shape = tuple(slm.shape)
        # Unfold the hologram's folded carry, fold for the camera canvas.
        y0h, _, x0h, _ = pad_window_slices(tuple(self.shape), slm_shape)
        cb_holo = checkerboard(slm_shape, (y0h, x0h))
        shape_padded = tuple(int(v) for v in cam.shape_padded)
        y0c, _, x0c, _ = pad_window_slices(shape_padded, slm_shape)
        cb_cam = checkerboard(slm_shape, (y0c, x0c))

        # Loop-invariant phase planes collapse to one pre-quantization
        # sum (-hologram checkerboard + propagation kernel + hardware
        # correction) and one post-quantization sum (simulated
        # aberration + camera-canvas checkerboard).
        pre = -np.asarray(cb_holo, np.float32)
        if self.propagation_kernel is not None:
            pre = pre + np.asarray(self.propagation_kernel, np.float32)
        correction = slm.source.get("phase")
        if correction is not None:
            pre = pre + np.asarray(correction, np.float32)
        post = np.asarray(slm.source["phase_sim"], np.float32) + np.asarray(
            cb_cam, np.float32
        )

        flat_cam, valid_cam = cam._sample_maps()

        # Spot-window gather maps: the exact `analysis.take` index math
        # (floor'd anchors, floor'd centered edges); out-of-frame windows
        # disqualify (the host path would raise there).
        width = int(self.spot_integration_width_ij)
        vectors = np.floor(np.asarray(self.spot_ij)).astype(int)
        edge = np.floor(analysis._coordinates(width, True)).astype(int)
        rx, ry = np.meshgrid(edge, edge)
        ix = rx.ravel()[None, :] + vectors[0][:, None]
        iy = ry.ravel()[None, :] + vectors[1][:, None]
        cam_shape = tuple(cam.shape)
        if (
            (ix < 0).any() or (ix >= cam_shape[1]).any()
            or (iy < 0).any() or (iy >= cam_shape[0]).any()
        ):
            return None
        spot_flat = jnp.asarray((iy * cam_shape[1] + ix).astype(np.int32))

        consts = {
            "sim_pre": jnp.asarray(pre),
            "sim_post": jnp.asarray(post),
            "sim_amp": jnp.asarray(
                np.asarray(slm.source["amplitude_sim"], np.float32)
            ),
            "sim_flat_cam": jnp.asarray(flat_cam),
            "sim_valid_cam": jnp.asarray(valid_cam),
            "sim_spot_flat": spot_flat,
        }
        statics = {
            "bitres": float(slm.bitresolution),
            "cam_sat": float(cam.bitresolution - 1),
            # The host camera casts counts to its dtype; mirror the
            # integer truncation (non-negative: floor == trunc).
            "truncates": bool(np.issubdtype(np.dtype(cam.dtype), np.integer)),
            "shape_padded": shape_padded,
        }
        self._sim_inputs_cache = (key, keyed_arrays, (consts, statics))
        return consts, statics

    def _sim_scale(self):
        """Exposure scaling of the simulated camera (dynamic scalar)."""
        cam = self.cameraslm.cam
        return jnp.float32(cam.exposure_s * cam.gain)

    def _sim_composite(self):
        """Build (and cache) the jitted simulated-measure composite; None
        when the rig doesn't qualify (see :meth:`_sim_spot_powers`)."""
        inputs = self._sim_engine_inputs()
        if inputs is None:
            return None
        consts, statics = inputs

        cached = getattr(self, "_sim_composite_cache", None)
        if cached is not None and cached[0] is inputs:
            return cached[1]

        @jax.jit
        def composite(psi, scale):
            return _engine.sim_measure_spots(
                psi, {**consts, "sim_scale": scale}, **statics
            )

        def run(psi):
            return composite(psi, self._sim_scale())

        self._sim_composite_cache = (inputs, run)
        return run

    def refine_offset(self, img=None, basis="kxy", force_affine=True, plot=False):
        """
        Hone spot positions toward their targets: centroid the measured
        spots, optionally fit an affine correction, and shift either the
        k-space targets (``basis="kxy"``/``"knm"``) or the camera
        integration positions (``basis="ij"``).

        Returns the per-spot shift vectors in the ``"ij"`` basis.
        """
        if self.spot_integration_width_ij is None:
            raise ValueError(
                "hologram.spot_integration_width_ij must be set to use refine_offset()."
            )

        if img is None:
            self.measure(basis="ij")
            img = self.img_ij

        regions = analysis.take(
            img, self.spot_ij, self.spot_integration_width_ij, centered=True, integrate=False
        )
        regions = analysis.image_remove_field(regions, deviations=None, out=regions)
        shift_vectors = analysis.image_positions(regions)

        if force_affine:
            affine = analysis.fit_affine(
                self.spot_ij[[0, 1]], self.spot_ij[[0, 1]] + shift_vectors
            )
            shift_vectors = (
                affine["M"] @ self.spot_ij[[0, 1]] + affine["b"]
            ) - self.spot_ij[[0, 1]]

        if plot:
            import matplotlib.pyplot as plt

            plt.imshow(img)
            sv = self.spot_ij[[0, 1]] + shift_vectors
            plt.scatter(sv[0, :], sv[1, :], s=200, fc="none", ec="r")
            plt.title("Refine Offset")
            plt.show()

        if basis is not None:
            if basis in ("kxy", "knm"):
                self.spot_kxy = self.spot_kxy.astype(float)
                self.spot_kxy[[0, 1]] = self.spot_kxy[[0, 1]] - (
                    self.cameraslm.ijcam_to_kxyslm(shift_vectors)
                    - self.cameraslm.ijcam_to_kxyslm((0, 0))
                )

                if hasattr(self, "spot_knm") and self.spot_knm is not None:
                    self.spot_knm = toolbox.convert_vector(
                        self.spot_kxy,
                        "kxy",
                        "knm",
                        hardware=self.cameraslm.slm,
                        shape=self.shape,
                    )
                    self.set_target(reset_weights=True)

                if hasattr(self, "spot_zernike"):
                    spot_zernike_xy = toolbox.convert_vector(
                        self.spot_kxy,
                        "kxy",
                        "zernike",
                        hardware=self.cameraslm.slm,
                        shape=self.shape,
                    )
                    self.spot_zernike[self.zernike_basis_cartesian, :] = spot_zernike_xy
            elif basis == "ij":
                self.spot_ij = self.spot_ij + shift_vectors
            else:
                raise ValueError(f"Unrecognized basis '{basis}'.")

        return shift_vectors

    def _populate_stats(self, stats, stat_groups):
        super()._populate_stats(stats, stat_groups)

        if "experimental_spot" in stat_groups:
            fast = self._sim_spot_powers()
            if fast is not None:
                pwr_feedback, total = fast
            else:
                self.measure(basis="ij")
                pwr_img = np.square(self.img_ij)
                pwr_feedback = analysis.take(
                    pwr_img,
                    self.spot_ij,
                    self.spot_integration_width_ij,
                    centered=True,
                    integrate=True,
                )
                total = np.sum(pwr_img)
            stats["experimental_spot"] = self._calculate_stats(
                np.sqrt(pwr_feedback),
                self.spot_amp,
                efficiency_compensation=False,
                total=total,
                raw=bool(self.flags.get("raw_stats")),
            )

        if "external_spot" in stat_groups:
            pwr_feedback = np.square(np.asarray(self.external_spot_amp, dtype=self.dtype))
            stats["external_spot"] = self._calculate_stats(
                np.sqrt(pwr_feedback),
                self.spot_amp,
                efficiency_compensation=False,
                total=np.sum(pwr_feedback),
                raw=bool(self.flags.get("raw_stats")),
            )


class SpotHologram(_AbstractSpotHologram):
    """
    DFT-based optical focus arrays: N spots tracked in the ``"knm"``
    (computational), ``"kxy"`` (normalized k-space), and ``"ij"`` (camera)
    bases, with per-spot amplitude targets, MRAF null regions, and
    spot-integrated feedback.

    Parity: reference ``_spots.py:1090-1697``.
    """

    _sim_fast_path = True

    def __init__(
        self,
        shape,
        spot_vectors,
        basis="kxy",
        spot_amp=None,
        cameraslm=None,
        null_vectors=None,
        null_radius=None,
        null_region=None,
        null_region_radius_frac=None,
        **kwargs,
    ):
        """
        Initialize a spot hologram from ``(2, N)`` spot vectors in the given
        ``basis`` (``"kxy"`` default; ``"knm"`` computational pixels;
        ``"ij"`` camera pixels, requiring a Fourier-calibrated
        ``cameraslm``). ``null_*`` parameters configure MRAF zero regions.
        Ref ``_spots.py:1090-1373``.
        """
        vectors = toolbox.format_2vectors(spot_vectors)
        N = vectors.shape[1]

        if spot_amp is not None:
            self.spot_amp = np.ravel(spot_amp)
            if len(self.spot_amp) != N:
                raise ValueError("spot_amp must have the same length as the spots.")
        else:
            self.spot_amp = np.full(N, 1.0 / np.sqrt(N))

        self.external_spot_amp = np.copy(self.spot_amp)

        if null_vectors is not None:
            null_vectors = toolbox.format_2vectors(null_vectors)
        self.null_knm = None
        self.null_radius_knm = None
        self.null_region_knm = None

        # Interpret vectors according to the basis.
        if basis is None or basis == "knm":
            self.spot_knm = vectors
            if cameraslm is not None:
                self.spot_kxy = toolbox.convert_vector(
                    self.spot_knm, "knm", "kxy", hardware=cameraslm, shape=shape
                )
                if "fourier" in getattr(cameraslm, "calibrations", {}):
                    self.spot_ij = cameraslm.kxyslm_to_ijcam(self.spot_kxy)
                else:
                    self.spot_ij = None
            else:
                self.spot_kxy = None
                self.spot_ij = None

            self.null_knm = null_vectors
            self.null_radius_knm = null_radius
            self.null_region_knm = null_region
        elif basis == "kxy":
            if cameraslm is None:
                raise ValueError("A cameraslm (or SLM) is needed to interpret kxy.")
            self.spot_kxy = vectors
            if "fourier" in getattr(cameraslm, "calibrations", {}):
                self.spot_ij = cameraslm.kxyslm_to_ijcam(vectors)
            else:
                self.spot_ij = None
            self.spot_knm = toolbox.convert_vector(
                vectors, "kxy", "knm", hardware=cameraslm, shape=shape
            )
        elif basis == "ij":
            if cameraslm is None or "fourier" not in cameraslm.calibrations:
                raise ValueError("A Fourier-calibrated cameraslm is needed for ij.")
            self.spot_ij = vectors
            self.spot_kxy = cameraslm.ijcam_to_kxyslm(vectors)
            self.spot_knm = toolbox.convert_vector(
                vectors, "ij", "knm", hardware=cameraslm, shape=shape
            )
        else:
            raise ValueError(f"Unrecognized basis for spots '{basis}'.")

        # Null conversions for ij/kxy bases.
        if basis in ("ij", "kxy"):
            if null_vectors is not None:
                self.null_knm = toolbox.convert_vector(
                    null_vectors, basis, "knm", hardware=cameraslm, shape=shape
                )
                if null_radius is not None:
                    self.null_radius_knm = toolbox.convert_radius(
                        null_radius, basis, "knm", hardware=cameraslm, shape=shape
                    )
            self.null_region_knm = None  # (possibly via ij transform below)

        # Point spread functions and integration widths.
        if cameraslm is not None and hasattr(cameraslm, "slm"):
            psf_kxy = np.mean(cameraslm.slm.get_spot_radius_kxy())
            psf_knm = toolbox.convert_radius(psf_kxy, "kxy", "knm", cameraslm.slm, shape)
            psf_ij = toolbox.convert_radius(psf_kxy, "kxy", "ij", cameraslm, shape)
        else:
            psf_knm = 0
            psf_ij = np.nan

        psf_knm = 0 if np.isnan(psf_knm) else psf_knm
        psf_ij = 0 if np.isnan(psf_ij) else psf_ij

        # Integration width: ~10x the psf, clipped to [3, spot spacing/1.5], odd.
        N_psf, min_psf = 10, 3
        dist_knm = np.max([toolbox.smallest_distance(self.spot_knm) / 1.5, min_psf])
        width = np.clip(N_psf * psf_knm, min_psf, dist_knm)
        self.spot_integration_width_knm = int(2 * np.floor(width / 2) + 1)

        if self.spot_ij is not None:
            dist_ij = np.max([toolbox.smallest_distance(self.spot_ij) / 1.5, min_psf])
            width = np.clip(N_psf * psf_ij, min_psf, dist_ij)
            self.spot_integration_width_ij = int(2 * np.floor(width / 2) + 1)
        else:
            self.spot_integration_width_ij = None

        # Bounds checks.
        if (
            np.any(self.spot_knm[0] < 0)
            or np.any(self.spot_knm[1] < 0)
            or np.any(self.spot_knm[0] >= shape[1])
            or np.any(self.spot_knm[1] >= shape[0])
        ):
            raise ValueError(
                f"Spots outside SLM computational space bounds!\n"
                f"Spots:\n{self.spot_knm}\nBounds: {shape}"
            )

        if self.spot_ij is not None:
            cam_shape = cameraslm.cam.shape
            half = self.spot_integration_width_ij / 2
            if (
                np.any(self.spot_ij[0] < half)
                or np.any(self.spot_ij[1] < half)
                or np.any(self.spot_ij[0] >= cam_shape[1] - half)
                or np.any(self.spot_ij[1] >= cam_shape[0] - half)
            ):
                raise ValueError(
                    f"Spots outside camera bounds!\nSpots:\n{self.spot_ij}\n"
                    f"Bounds: {cam_shape}"
                )

        if self.null_knm is not None:
            if self.null_radius_knm is None:
                all_spots = np.hstack((self.null_knm, self.spot_knm))
                self.null_radius_knm = toolbox.smallest_distance(all_spots) / 4
            self.null_radius_knm = int(np.ceil(self.null_radius_knm))

        super().__init__(shape, target_ij=None, cameraslm=cameraslm, **kwargs)

        if basis == "ij" and null_region is not None:
            self.null_region_knm = (
                self.ijcam_to_knmslm(null_region, order=0) != 0
            )

        if null_region_radius_frac is not None:
            if self.null_region_knm is None:
                self.null_region_knm = np.zeros(self.shape, dtype=bool)
            xg, yg = np.meshgrid(
                np.linspace(-1, 1, self.null_region_knm.shape[1]),
                np.linspace(-1, 1, self.null_region_knm.shape[0]),
            )
            self.null_region_knm[
                np.square(xg) + np.square(yg) > null_region_radius_frac**2
            ] = True

        self.set_target(reset_weights=True)

    def __len__(self):
        """Number of spots."""
        return self.spot_knm.shape[1]

    # ------------------------------------------------------------------
    # Target construction (ref :1387-1546).
    # ------------------------------------------------------------------

    @staticmethod
    def make_rectangular_array(
        shape,
        array_shape,
        array_pitch,
        array_center=None,
        basis="knm",
        orientation_check=False,
        **kwargs,
    ):
        """
        Build a rectangular spot array of ``array_shape`` spots at
        ``array_pitch`` spacing about ``array_center`` (defaults to the
        zeroth order in the chosen basis). ``orientation_check`` removes the
        last two spots for the Fourier-calibration parity check.
        """
        if isinstance(array_shape, REAL_TYPES):
            array_shape = (int(array_shape), int(array_shape))
        if isinstance(array_pitch, REAL_TYPES):
            array_pitch = (array_pitch, array_pitch)

        if array_center is None:
            if basis == "knm":
                array_center = (shape[1] / 2.0, shape[0] / 2.0)
            elif basis == "kxy":
                array_center = (0, 0)
            elif basis == "ij":
                cameraslm = kwargs.get("cameraslm")
                if cameraslm is None or "fourier" not in cameraslm.calibrations:
                    raise ValueError("A Fourier-calibrated cameraslm is needed for ij.")
                array_center = toolbox.convert_vector(
                    (0, 0), "kxy", "ij", hardware=cameraslm
                )

        x_edge = (np.arange(array_shape[0]) - (array_shape[0] - 1) / 2.0) * array_pitch[0] + array_center[0]
        y_edge = (np.arange(array_shape[1]) - (array_shape[1] - 1) / 2.0) * array_pitch[1] + array_center[1]

        x_grid, y_grid = np.meshgrid(x_edge, y_edge)
        x_list, y_list = x_grid.ravel(), y_grid.ravel()

        if orientation_check and len(x_list) > 2:
            x_list = x_list[:-2]
            y_list = y_list[:-2]

        return SpotHologram(
            shape, np.vstack((x_list, y_list)), basis=basis, spot_amp=None, **kwargs
        )

    def _set_target_spots(self, reset_weights=False):
        """Scatter spot amplitudes (+null regions) into the target plane."""
        self.spot_knm_rounded = np.rint(self.spot_knm).astype(int)

        if self.cameraslm is not None:
            self.spot_kxy_rounded = toolbox.convert_vector(
                self.spot_knm_rounded,
                "knm",
                "kxy",
                hardware=self.cameraslm.slm,
                shape=self.shape,
            )
            if "fourier" in self.cameraslm.calibrations:
                self.spot_ij_rounded = self.cameraslm.kxyslm_to_ijcam(self.spot_kxy_rounded)
            else:
                self.spot_ij_rounded = None
        else:
            self.spot_kxy_rounded = None
            self.spot_ij_rounded = None

        if self.target is None:
            self.target = np.zeros(self.shape, dtype=self.dtype)

        # MRAF (nan background) engages only with explicit null *vectors*
        # (ref `_spots.py:1522-1530`: a bare null_region leaves zero fill).
        if self.null_knm is None:
            self.target.fill(0)
        else:
            # Amplitude-free (nan) background, with explicit zero regions.
            self.target.fill(np.nan)
            if self.null_region_knm is not None:
                self.target[self.null_region_knm] = 0
            if self.null_knm is not None:
                all_spots = np.hstack((self.null_knm, self.spot_knm))
                w = int(2 * self.null_radius_knm + 1)
                for ii in range(all_spots.shape[1]):
                    toolbox.imprint(
                        self.target,
                        (np.rint(all_spots[0, ii]), w, np.rint(all_spots[1, ii]), w),
                        0,
                        centered=True,
                        circular=True,
                    )

        self.target[self.spot_knm_rounded[1, :], self.spot_knm_rounded[0, :]] = self.spot_amp
        self.target /= Hologram._norm(self.target)

        if reset_weights:
            self.reset_weights()

    def set_target(self, new_target=None, reset_weights=False, plot=False):
        """Update the target from the current :attr:`spot_knm` positions."""
        del new_target  # Target is derived from spot positions.
        self._set_target_spots(reset_weights=reset_weights)

    # ------------------------------------------------------------------
    # Engine integration: spot feedback inside the scan.
    # ------------------------------------------------------------------

    @property
    def _spot_count(self):
        return int(self.spot_knm.shape[1])

    @property
    def _spot_window(self):
        return int(self.spot_integration_width_knm)

    @property
    def _spot_single_px(self):
        return tuple(self.shape) == tuple(self.slm_shape)

    def _engine_feedback(self):
        feedback = self.flags.get("feedback", "computational")
        if feedback in ("computational", "computational_spot"):
            return feedback
        if feedback == "experimental_spot" and self._sim_engine_inputs() is not None:
            # Simulated rig the device composite models exactly: the
            # whole camera-in-the-loop iteration runs inside the scan.
            return "experimental_spot_sim"
        return "external_spot"  # host-updated weights

    def _device_stat_groups(self):
        allowed = {"computational", "computational_spot"}
        if self._sim_engine_inputs() is not None:
            allowed.add("experimental_spot")
        return tuple(
            g for g in self.flags.get("stat_groups", []) if g in allowed
        )

    def _stats_pending_groups(self):
        pending = super()._stats_pending_groups()
        if self._sim_engine_inputs() is not None:
            # The scan computes measured spot stats on device.
            pending = [g for g in pending if g != "experimental_spot"]
        return pending

    def _amend_config(self, config):
        config = super()._amend_config(config)
        if (
            config.feedback == "experimental_spot_sim"
            or "experimental_spot" in config.stat_groups
        ):
            import dataclasses

            _, statics = self._sim_engine_inputs()
            config = dataclasses.replace(
                config,
                sim_bitres=statics["bitres"],
                sim_cam_sat=statics["cam_sat"],
                sim_truncates=statics["truncates"],
                sim_shape_padded=tuple(statics["shape_padded"]),
            )
        return config

    def _extend_consts(self, consts, config):
        super()._extend_consts(consts, config)
        needs_spots = (
            config.feedback == "computational_spot"
            or "computational_spot" in config.stat_groups
        )
        needs_sim = (
            config.feedback == "experimental_spot_sim"
            or "experimental_spot" in config.stat_groups
        )
        if needs_spots or needs_sim:
            # Gather maps: stats use the raw (floored) spot positions like
            # analysis.take; weight updates use the rounded spot pixels.
            flat_idx, _ = _engine.spot_gather_indices(
                np.floor(self.spot_knm).astype(int),
                self.spot_integration_width_knm,
                self.shape,
            )
            weight_flat_idx, center_idx = _engine.spot_gather_indices(
                self.spot_knm_rounded, self.spot_integration_width_knm, self.shape
            )
            consts["spot_flat_idx"] = jnp.asarray(flat_idx)
            consts["spot_weight_flat_idx"] = jnp.asarray(weight_flat_idx)
            consts["spot_center_idx"] = jnp.asarray(center_idx)
            consts["spot_amp"] = jnp.asarray(self.spot_amp, dtype=jnp.float32)
        if needs_sim:
            sim_consts, _ = self._sim_engine_inputs()
            consts.update(sim_consts)
            consts["sim_scale"] = self._sim_scale()

    # ------------------------------------------------------------------
    # Host-side weighting (stepwise/experimental paths; ref :1573-1624).
    # ------------------------------------------------------------------

    def _update_weights(self):
        feedback = self.flags["feedback"]

        if feedback == "experimental":
            warnings.warn(
                "SpotHologram feedback 'experimental' is interpreted as 'experimental_spot'"
            )
            feedback = self.flags["feedback"] = "experimental_spot"

        if feedback == "computational":
            super()._update_weights()
            return

        if feedback == "computational_spot":
            amp_feedback = np.sqrt(
                analysis.take(
                    np.square(self.amp_ff),
                    self.spot_knm_rounded,
                    self.spot_integration_width_knm,
                    centered=True,
                    integrate=True,
                )
            )
        elif feedback == "experimental_spot":
            fast = self._sim_spot_powers()
            if fast is not None:
                amp_feedback = np.sqrt(fast[0])
            else:
                self.measure(basis="ij")
                amp_feedback = np.sqrt(
                    analysis.take(
                        np.square(np.asarray(self.img_ij, dtype=self.dtype)),
                        self.spot_ij,
                        self.spot_integration_width_ij,
                        centered=True,
                        integrate=True,
                    )
                )
        elif feedback == "external_spot":
            amp_feedback = self.external_spot_amp
        else:
            raise ValueError(f"Feedback '{feedback}' not recognized.")

        rows = self.spot_knm_rounded[1, :]
        cols = self.spot_knm_rounded[0, :]
        # Writable copy then reassign: after a scanned run the weights
        # host view is a read-only materialization of the device copy
        # (dual-store), so in-place scatter would raise.
        weights = np.array(self.weights)
        weights[rows, cols] = np.asarray(
            update_weights_generic(
                jnp.asarray(weights[rows, cols], dtype=jnp.float32),
                jnp.asarray(np.asarray(amp_feedback, dtype=np.float32)),
                jnp.asarray(self.spot_amp, dtype=jnp.float32),
                self.flags["method"],
                self.flags.get("feedback_exponent", 0.8),
                self.flags.get("feedback_factor", 0.1),
            )
        )
        self.weights = weights

    def _populate_stats(self, stats, stat_groups):
        super()._populate_stats(stats, stat_groups)

        if "computational_spot" in stat_groups:
            if tuple(self.shape) == tuple(self.slm_shape):
                feedback = self.amp_ff[
                    self.spot_knm_rounded[1, :], self.spot_knm_rounded[0, :]
                ]
                total = np.sum(np.square(self.amp_ff))
            else:
                pwr_ff = np.square(self.amp_ff)
                pwr_feedback = analysis.take(
                    pwr_ff,
                    self.spot_knm,
                    self.spot_integration_width_knm,
                    centered=True,
                    integrate=True,
                )
                feedback = np.sqrt(pwr_feedback)
                total = np.sum(pwr_ff)

            stats["computational_spot"] = self._calculate_stats(
                feedback,
                self.spot_amp,
                efficiency_compensation=False,
                total=total,
                raw=bool(self.flags.get("raw_stats")),
            )


class CompressedSpotHologram(_AbstractSpotHologram):
    r"""
    Grid-free spot holography: the farfield is a length-``N`` complex
    vector and the near<->far transform is an explicit Zernike-phase
    kernel contraction — each spot carries its own Zernike coefficients
    (3D position + aberrations). Parity: reference ``_spots.py:174-1089``;
    the CUDA kernels are replaced by matmul + sincos pipelines
    (:mod:`slmsuite_tpu.ops.compressed`) and, on a GPU, fused Pallas
    kernels (:mod:`slmsuite_tpu.ops.pallas_compressed`).

    Attributes
    ----------
    spot_zernike : numpy.ndarray
        ``(D, N)`` spot coefficients in the Zernike basis.
    zernike_basis : numpy.ndarray
        ANSI indices of the basis (``-1`` = vortex waveplate).
    spot_ij : numpy.ndarray OR None
        Camera-basis lateral positions.
    """

    #: ``optimize(mesh=...)`` shards the pixel axis over the mesh.
    _supports_mesh = True

    #: Device-resident copy of the optimized (flat) nearfield phase.
    #: Valid only while ``_raw_phase`` is None (i.e. the host copy has
    #: never been materialized since the last engine run) — this keeps
    #: back-to-back ``optimize()`` calls free of the 4 MB psi host round
    #: trip while staying correct if a user reads (and
    #: possibly mutates in place) ``holo.phase`` between calls.
    _psi_dev = None
    _raw_phase = None

    def __init__(self, spot_vectors, basis="kxy", spot_amp=None, cameraslm=None, cuda=None, **kwargs):
        """
        Initialize from ``(D, N)`` spot vectors in basis ``"kxy"``,
        ``"ij"``, ``"zernike"``, or an explicit list of ANSI indices.
        ``cuda`` selects the fused transform kernels of
        :mod:`slmsuite_tpu.ops.pallas_compressed` (reference-API name,
        ref ``_spots.py:214-545``); they run on a GPU, and elsewhere the
        jnp path runs instead. ``None`` enables them on a GPU, mirroring
        how the reference auto-loads its CUDA kernels when available.
        """
        if cameraslm is None:
            raise ValueError("cameraslm must be passed.")

        spot_vectors = toolbox.format_vectors(spot_vectors, handle_dimension="pass")
        D, N = spot_vectors.shape
        if N == 0:
            raise ValueError("CompressedSpotHologram requires at least one spot.")

        if spot_amp is not None:
            self.spot_amp = np.asarray(spot_amp).ravel()
            if self.spot_amp.size != N:
                raise ValueError("spot_amp must have the same length as the spots.")
        else:
            self.spot_amp = np.full(N, 1.0 / np.sqrt(N))

        # Zernike basis.
        from slmsuite_tpu.holography.toolbox import phase as tphase

        if isinstance(basis, str):
            self.zernike_basis = tphase._zernike_indices_parse(None, D)
        else:
            self.zernike_basis = np.ravel(basis)
            basis = "zernike"
            if len(self.zernike_basis) != D:
                raise ValueError("zernike_basis must match the spot dimension.")
            if 0 in self.zernike_basis:
                warnings.warn(
                    "Found ANSI index '0' (piston) in the zernike_basis; "
                    "spot phase is controlled externally."
                )

        if not np.any(self.zernike_basis == 2) or not np.any(self.zernike_basis == 1):
            raise ValueError("Compressed basis must include x, y (ANSI indices 2, 1)")
        self.zernike_basis_cartesian = [
            np.argwhere(self.zernike_basis == 2)[0],
            np.argwhere(self.zernike_basis == 1)[0],
        ]
        if np.any(self.zernike_basis == 4):
            self.zernike_basis_cartesian.append(np.argwhere(self.zernike_basis == 4)[0])
        self.zernike_basis_cartesian = np.squeeze(self.zernike_basis_cartesian)

        # Convert vectors into the zernike/kxy/ij triple.
        if basis == "zernike":
            self.spot_zernike = np.array(spot_vectors, dtype=float)
            self.spot_kxy = toolbox.convert_vector(
                spot_vectors[self.zernike_basis_cartesian, :],
                "zernike",
                "kxy",
                hardware=cameraslm,
            )
            try:
                self.spot_ij = toolbox.convert_vector(
                    spot_vectors, "zernike", "ij", hardware=cameraslm
                )
            except Exception:
                self.spot_ij = None
        else:
            self.spot_zernike = toolbox.convert_vector(
                spot_vectors, basis, "zernike", hardware=cameraslm
            )
            self.spot_kxy = toolbox.convert_vector(
                spot_vectors, basis, "kxy", hardware=cameraslm
            )
            try:
                self.spot_ij = toolbox.convert_vector(
                    spot_vectors, basis, "ij", hardware=cameraslm
                )
            except Exception:
                self.spot_ij = None

        # Bounds + integration widths.
        if hasattr(cameraslm, "slm"):
            kmax = 1.0 / np.min(cameraslm.slm.pitch) / 2.0
            if np.any(np.abs(self.spot_kxy[:2, :]) > 1.1 * kmax):
                raise ValueError("Spots laterally outside the bounds of the farfield")
            psf_kxy = np.mean(cameraslm.slm.get_spot_radius_kxy())
            if "fourier" in getattr(cameraslm, "calibrations", {}):
                self.spot_ij = cameraslm.kxyslm_to_ijcam(self.spot_kxy)
                psf_ij = toolbox.convert_radius(psf_kxy, "kxy", "ij", cameraslm)
            else:
                self.spot_ij = None
                psf_ij = np.nan
        else:
            psf_ij = np.nan
            self.spot_ij = None

        if np.isnan(psf_ij):
            psf_ij = 0

        min_psf = 3
        if self.spot_ij is not None:
            dist_ij = np.max([toolbox.smallest_distance(self.spot_ij) / 1.5, min_psf])
            if psf_ij > dist_ij:
                warnings.warn("The expected camera spot psf is too large; clipping.")
            width = np.clip(2 * psf_ij, 3, dist_ij)
            self.spot_integration_width_ij = int(2 * np.floor(width / 2) + 1)

            cam_shape = cameraslm.cam.shape
            half = self.spot_integration_width_ij / 2
            if (
                np.any(self.spot_ij[0] < half)
                or np.any(self.spot_ij[1] < half)
                or np.any(self.spot_ij[0] >= cam_shape[1] - half)
                or np.any(self.spot_ij[1] >= cam_shape[0] - half)
            ):
                raise ValueError(
                    f"Spots outside camera bounds!\nSpots:\n{self.spot_ij}\n"
                    f"Bounds: {cam_shape}"
                )
        else:
            self.spot_integration_width_ij = None

        super().__init__(shape=None, target_ij=None, cameraslm=cameraslm, **kwargs)
        self.shape = self.slm_shape

        self.set_target(new_target=self.spot_amp, reset_weights=True)
        self.reset()

        self.external_spot_amp = np.copy(self.spot_amp)

        # Basis stack for the compressed transforms (host-built, cached).
        from slmsuite_tpu.ops.compressed import build_zernike_basis

        slm = cameraslm.slm if hasattr(cameraslm, "slm") else cameraslm
        self._basis = build_zernike_basis(self.zernike_basis, slm)
        if cuda is None:
            from slmsuite_tpu.ops.platform import accelerator

            cuda = accelerator() == "gpu"
        self.cuda = bool(cuda)

    def __len__(self):
        return int(self.spot_amp.size)

    def get_padded_shape(self, *args, **kwargs):
        """Compressed holograms have no DFT grid and need no padding."""
        raise NameError(
            "CompressedSpotHologram does not use a DFT grid and does not need padding."
        )

    # ------------------------------------------------------------------
    # Target management (ref :917-947).
    # ------------------------------------------------------------------

    def _set_target(self, new_target, reset_weights=False):
        # Called by Hologram.__init__ before spot data exists; defer.
        if not hasattr(self, "spot_amp"):
            self.target = None
            return
        self.set_target(new_target, reset_weights)

    def set_target(self, new_target=None, reset_weights=False):
        """Set the ``(N,)`` spot-amplitude target (cleans and normalizes)."""
        if new_target is None:
            self.target = np.asarray(self.spot_amp, dtype=self.dtype)
        else:
            new_target = np.squeeze(np.asarray(new_target).ravel())
            if new_target.shape != (len(self),):
                raise ValueError("Target must have one amplitude per spot.")
            self.target = np.array(new_target, dtype=self.dtype)
            self.spot_amp = np.array(new_target, dtype=self.dtype)

        self.target = np.abs(self.target)
        self.target = self.target / Hologram._norm(self.target)

        if reset_weights:
            self.reset_weights()

    # ------------------------------------------------------------------
    # Engine integration.
    # ------------------------------------------------------------------

    def _use_kernels(self):
        """Whether the transforms run the fused kernels: ``cuda`` set
        and a GPU to run them on."""
        from slmsuite_tpu.ops.platform import accelerator

        return self.cuda and accelerator() == "gpu"

    def _kernel_cache_enabled(self):
        """Whether the scanned engine streams precomputed cos/sin kernel
        tiles instead of recomputing the sincos each iteration (the
        analog of the reference's cached kernel batches,
        ``_spots.py:595-636``). On whenever the jnp path runs and the
        cache fits the memory budget (:func:`ops.compressed.cache_budget_mb`);
        off under a mesh (the pixel-sharded engine recomputes per shard)
        and when the fused kernels run (they recompute by design)."""
        from slmsuite_tpu.ops.compressed import cache_budget_mb, kernel_cache_bytes

        if self._mesh is not None or self._use_kernels():
            return False
        return kernel_cache_bytes(
            len(self), int(np.prod(self.slm_shape))
        ) <= cache_budget_mb() * 1e6

    def _compressed_config(self, kernel_cache=False):
        from slmsuite_tpu.ops.compressed import CompressedGSConfig

        return CompressedGSConfig(
            method=self.flags["method"],
            n_pixels=int(np.prod(self.slm_shape)),
            n_spots=len(self),
            stat_groups=tuple(
                g for g in self.flags.get("stat_groups", []) if g == "computational_spot"
            ),
            kim_efficiency_trigger=(
                "Kim" in self.flags["method"]
                and self.flags.get("fix_phase_efficiency") is not None
            ),
            use_pallas=self._use_kernels(),
            mraf=self._mraf_enabled(),
            kernel_cache=kernel_cache,
        )

    def _compressed_consts(self, kernel_cache=False):
        amp = self.amp
        if np.isscalar(amp):
            amp_flat = jnp.float32(amp)
        else:
            amp_flat = self._dev_const(
                "amp", amp,
                lambda a: jnp.asarray(np.asarray(a, np.float32).ravel()),
            )
        target_dev, mask_dev = self._dev_const(
            "target", self.target,
            lambda t: (
                jnp.asarray(np.nan_to_num(np.asarray(t, np.float32))),
                jnp.asarray(np.nan_to_num(np.asarray(t, np.float32)) != 0),
            ),
        )
        consts = {
            "amp": amp_flat,
            "coeffs": self._dev_const(
                "coeffs", self.spot_zernike,
                lambda c: jnp.asarray(c, dtype=jnp.float32),
            ),
            "basis": self._dev_const(
                "basis", self._basis, jnp.asarray
            ),
            "target": target_dev,
            "stat_mask": mask_dev,
            "feedback_exponent": jnp.float32(self.flags.get("feedback_exponent", 0.8)),
            "feedback_factor": jnp.float32(self.flags.get("feedback_factor", 0.1)),
            "fix_phase_iteration": jnp.int32(self.flags.get("fix_phase_iteration", 10)),
            "fix_phase_efficiency": jnp.float32(
                self.flags.get("fix_phase_efficiency") or np.nan
            ),
        }
        if self._mraf_enabled():
            # Per-spot MRAF (reference parity): nan spot_amp = noise
            # spots (amplitude freedom), zeros = null spots.
            consts["signal_mask"] = self._dev_const(
                "signal_mask", self.target,
                lambda t: jnp.asarray(
                    ~np.isnan(np.asarray(t, float))
                    & (np.nan_to_num(np.asarray(t, float)) > 0)
                ),
            )
            consts["noise_mask"] = self._dev_const(
                "noise_mask", self.target,
                lambda t: jnp.asarray(np.isnan(np.asarray(t, float))),
            )
            mraf_factor = self.flags.get("mraf_factor")
            consts["mraf_k"] = jnp.float32(
                1.0 if mraf_factor is None else mraf_factor
            )
        if kernel_cache:
            consts["kc_tiles"], consts["ks_tiles"] = self._kernel_cache_tiles(
                consts["coeffs"], consts["basis"]
            )
        return consts

    def _kernel_cache_tiles(self, coeffs_dev, basis_dev):
        """Device-resident cos/sin kernel tiles, rebuilt only when the
        spot coefficients or basis change (same invalidation contract
        as :meth:`_dev_const`, fingerprinting BOTH inputs)."""
        from slmsuite_tpu.ops.compressed import build_kernel_cache

        # Identity AND content fingerprint, like _dev_const: for device
        # arrays _host_fingerprint returns None (immutable — identity
        # suffices), so without the `is` checks a replaced device-array
        # spot_zernike/_basis would degenerate to (None,)*2 == (None,)*2
        # and silently reuse stale kernel tiles.
        spots, basis = self.spot_zernike, self._basis
        fp = (self._host_fingerprint(spots), self._host_fingerprint(basis))
        cached = getattr(self, "_kcache", None)
        if (
            cached is not None
            and cached[0] is spots
            and cached[1] is basis
            and cached[2] == fp
        ):
            return cached[3]
        tiles = build_kernel_cache(coeffs_dev, basis_dev)
        self._kcache = (spots, basis, fp, tiles)
        return tiles

    def optimize_gs(self, maxiter, callback, verbose=True, name=None):
        """Compressed GS: scanned engine, or host loop for camera feedback."""
        from slmsuite_tpu.ops import compressed as _comp
        from slmsuite_tpu.misc.progress import tqdm as _tqdm

        if isinstance(maxiter, range):
            maxiter = len(maxiter)

        feedback = self.flags.get("feedback", "computational")
        if feedback == "computational":
            feedback = self.flags["feedback"] = "computational_spot"
        if feedback == "experimental":
            warnings.warn(
                "CompressedSpotHologram feedback 'experimental' is interpreted "
                "as 'experimental_spot'"
            )
            feedback = self.flags["feedback"] = "experimental_spot"

        host_loop = (
            callback is not None
            or bool(self._stats_pending_groups())
            or feedback in ("experimental_spot", "external_spot")
            or (
                # Evolving zero-region weights carry complex per-null-spot
                # state the scanned engine does not; the host loop keeps
                # it as an attribute like the reference.
                bool(self.flags.get("zero_factor", 0))
                and self._mraf_enabled()
            )
        )
        if host_loop and self._mesh is not None:
            warnings.warn(
                "mesh-sharded optimization requires the fully-computational "
                "path (no callback/experimental feedback); running on a "
                "single device."
            )

        config = self._compressed_config(
            kernel_cache=(not host_loop) and self._kernel_cache_enabled()
        )
        consts = self._compressed_consts(kernel_cache=config.kernel_cache)
        start_iter = self.iter

        state = _comp.CompressedGSState(
            psi=self._psi_device_flat(for_donation=True),
            weights=jnp.asarray(np.nan_to_num(np.asarray(self.weights, np.float32))),
            phase_ff=(
                self._phase_ff_folded_device(for_donation=True)
                if self._has_phase_ff()
                else jnp.zeros(len(self), jnp.float32)
            ),
            fixed_phase=jnp.asarray(bool(self.flags.get("fixed_phase", False))),
            unfixed_streak=jnp.zeros((), jnp.int32),
            iteration=jnp.asarray(self.iter, jnp.int32),
        )

        if not host_loop:
            mesh = self._mesh
            if mesh is not None:
                # Pixel-sharded multi-chip path: each device owns a pixel
                # slab; one (N,) psum per transform direction per
                # iteration (see slmsuite_tpu.parallel.compressed).
                n_dev = int(np.prod(list(mesh.shape.values())))
                if config.n_pixels % n_dev:
                    # Degrade like the other mesh paths: warn and run
                    # single-device rather than aborting mid-optimize.
                    warnings.warn(
                        f"mesh-sharded compressed optimization unavailable "
                        f"(pixel count {config.n_pixels} must divide the "
                        f"mesh ({n_dev})); running on a single device."
                    )
                    mesh = None
            if mesh is not None:
                from slmsuite_tpu.parallel.compressed import (
                    run_sharded_compressed_gs,
                    shard_compressed_consts,
                )

                axis = mesh.axis_names[0]
                consts = shard_compressed_consts(consts, mesh, axis)
            iterator = _tqdm(total=maxiter, desc=name) if verbose and maxiter > 1 else None
            chunk = maxiter if not verbose else max(1, int(np.ceil(maxiter / 10)))
            remaining = maxiter
            all_stats = []
            while remaining > 0:
                n = min(chunk, remaining)
                if mesh is not None:
                    state, stats = run_sharded_compressed_gs(
                        config, state, consts, mesh, n, axis
                    )
                else:
                    state, stats = _comp.run_compressed_gs(config, state, consts, n)
                all_stats.append(stats)
                remaining -= n
                if iterator is not None:
                    iterator.update(n)
            if iterator is not None:
                iterator.close()

            self._finalize_scan_fused(
                state, all_stats, config, consts, start_iter,
                sharded=mesh is not None,
            )
        else:
            step = _comp.make_compressed_gs_step(
                dataclasses_replace_stats(config)
            )
            iterations = range(maxiter)
            if verbose and maxiter > 1:
                iterations = _tqdm(iterations, desc=name)
            step_jit = jax.jit(step)
            for _ in iterations:
                state = self._stepwise_compressed(state, consts, config, callback, step_jit)
                if self._break_requested:
                    break
            self._sync_compressed_state(state)
            self._populate_results()

    def _stepwise_compressed(self, state, consts, config, callback, step_jit):
        """One host-paced compressed iteration with hardware feedback."""
        from slmsuite_tpu.ops import compressed as _comp

        self._break_requested = False

        # Forward only: compute farfield from current psi.
        amp = consts["amp"]
        nf_re = amp * jnp.cos(state.psi)
        nf_im = amp * jnp.sin(state.psi)
        n2f = _comp._get_transforms(config)[1]
        ff_re, ff_im = n2f(nf_re, nf_im, consts["coeffs"], consts["basis"], config.n_spots)
        self.amp_ff = np.sqrt(np.asarray(ff_re) ** 2 + np.asarray(ff_im) ** 2)
        theta_host = np.arctan2(np.asarray(ff_im), np.asarray(ff_re))
        self._midloop_cleaning()
        self.weights = np.array(state.weights)
        self.iter = int(state.iteration)

        if callback is not None and callback(self):
            self._break_requested = True
            return state
        self._update_stats(self.flags["stat_groups"])

        was_not_fixed = not self.flags.get("fixed_phase", False)
        if "WGS" in self.flags["method"] and self.iter > 0:
            self._update_weights()
            self._kim_decision_host()
        if was_not_fixed or self._phase_ff_folded is None:
            self._phase_ff_folded = theta_host

        # Backward.
        weights = jnp.asarray(np.nan_to_num(np.asarray(self.weights, np.float32)))
        phase_ff = jnp.asarray(self._phase_ff_folded, dtype=jnp.float32)
        ffp_re = weights * jnp.cos(phase_ff)
        ffp_im = weights * jnp.sin(phase_ff)
        if config.mraf:
            # Same per-spot MRAF mix as the scanned steps: noise spots
            # keep the (unit-norm-transform) farfield; null spots take
            # the evolving zero_factor weights (reference
            # ``_hologram.py:1613-1616``) when the flag is set, else 0.
            zero_re = zero_im = None
            zf = float(self.flags.get("zero_factor", 0) or 0)
            if zf:
                zmask = np.asarray(consts["signal_mask"]) == False  # noqa: E712
                zmask &= np.asarray(consts["noise_mask"]) == False  # noqa: E712
                if not hasattr(self, "_zero_weights_c"):
                    self._zero_weights_c = np.zeros(len(self), np.complex64)
                fz = np.asarray(ff_re) + 1j * np.asarray(ff_im)
                self._zero_weights_c -= np.where(
                    zmask, zf * np.abs(fz) * fz, 0
                ).astype(np.complex64)
                zero_re = jnp.asarray(self._zero_weights_c.real)
                zero_im = jnp.asarray(self._zero_weights_c.imag)
            ffp_re, ffp_im = _comp.apply_compressed_mraf_mix(
                ffp_re, ffp_im, ff_re, ff_im, consts,
                zero_re=zero_re, zero_im=zero_im,
            )
        f2n = _comp._get_transforms(config)[0]
        nfp_re, nfp_im = f2n(
            ffp_re,
            ffp_im,
            consts["coeffs"],
            consts["basis"],
            config.n_spots,
        )
        psi = jnp.arctan2(nfp_im, nfp_re)

        return _comp.CompressedGSState(
            psi=psi,
            weights=weights,
            phase_ff=phase_ff,
            fixed_phase=jnp.asarray(bool(self.flags.get("fixed_phase", False))),
            unfixed_streak=state.unfixed_streak,
            iteration=state.iteration + 1,
        )

    def _sync_compressed_state(self, state):
        # Keep psi on device; the host copy materializes lazily through
        # the ``phase`` property (it is a 4 MB download per megapixel
        # that back-to-back optimize calls never need).
        self._set_psi_device(state.psi)
        self.weights = np.array(state.weights)
        self._phase_ff_folded = np.asarray(state.phase_ff)
        self.flags["fixed_phase"] = bool(state.fixed_phase)
        self._final_fixed_phase = bool(state.fixed_phase)
        self.iter = int(state.iteration)

    def _finalize_scan_fused(self, state, all_stats, config, consts,
                             start_iter, sharded=False):
        """Adopt the final scan state, farfield, and stats with ONE
        device fetch.

        The naive epilogue (sync weights/phase/flags, then
        ``_populate_results``, then the stats download) costs ~7 serial
        host<->device round trips; each is pure latency
        and dominates the wall time of short ``optimize()`` calls
        (BENCH config 5). Everything small is packed into a single f32
        vector ON DEVICE and downloaded once; psi stays device-resident.
        Matches ``_sync_compressed_state`` + ``_populate_results`` +
        ``_record_scan_stats`` field-for-field.
        """
        from slmsuite_tpu.ops import compressed as _comp

        n_spots = len(self)
        # On the pixel-sharded mesh path the consts arrive REWRITTEN by
        # shard_compressed_consts (basis/amp sharded over pixels) and
        # state.psi is sharded too; a pallas_call has no SPMD
        # partitioning rule, so use the jnp twin — XLA's GSPMD
        # partitions its einsum and inserts the psum over pixel shards.
        use_pallas = self._use_kernels() and not sharded

        # n_spots/use_pallas are frozen into the jitted closure, so the
        # cache is keyed on them: rebuilding the spot set to a different
        # count on the same hologram must not slice the packed vector
        # with a stale length.
        fn_key = (n_spots, use_pallas)
        cached_fn = getattr(self, "_finalize_fn", None)
        fn = cached_fn[1] if cached_fn and cached_fn[0] == fn_key else None
        if fn is None:

            @jax.jit
            def fn(psi, weights, fixed, it, stats, amp, coeffs, basis):
                nf_re = amp * jnp.cos(psi)
                nf_im = amp * jnp.sin(psi)
                if use_pallas:
                    from slmsuite_tpu.ops.pallas_compressed import (
                        nearfield_to_farfield as n2f,
                    )
                else:
                    n2f = _comp.nearfield_to_farfield
                ff_re, ff_im = n2f(nf_re, nf_im, coeffs, basis, n_spots)
                amp_ff = jnp.sqrt(ff_re**2 + ff_im**2)
                ph_ff = jnp.arctan2(ff_im, ff_re)
                return jnp.concatenate([
                    weights.astype(jnp.float32), ph_ff, amp_ff,
                    jnp.stack([
                        fixed.astype(jnp.float32), it.astype(jnp.float32),
                    ]),
                    stats.ravel().astype(jnp.float32),
                ])

            self._finalize_fn = (fn_key, fn)

        stats_shape = None
        if all_stats:
            stats_dev = (
                all_stats[0] if len(all_stats) == 1
                else jnp.concatenate(all_stats)
            )
            stats_shape = tuple(stats_dev.shape)
        else:
            stats_dev = jnp.zeros((0,), jnp.float32)
        packed = np.asarray(fn(
            state.psi, state.weights, state.fixed_phase, state.iteration,
            stats_dev, consts["amp"], consts["coeffs"], consts["basis"],
        ))

        N = n_spots
        self._set_psi_device(state.psi)
        self.weights = packed[:N].copy()
        # _populate_results overwrites the Kim stored farfield phase with
        # the freshly computed one — identical ordering here.
        self._phase_ff_folded = packed[N:2 * N].copy()
        self._farfield_folded = None
        self.amp_ff = packed[2 * N:3 * N].copy()
        self.flags["fixed_phase"] = bool(packed[3 * N])
        self._final_fixed_phase = bool(packed[3 * N])
        self.iter = int(packed[3 * N + 1])
        if config.stat_groups and stats_shape is not None:
            self._record_scan_stats(
                packed[3 * N + 2:].reshape(stats_shape), start_iter
            )

    # The compressed hologram's phase is stored directly (no fold).
    @property
    def phase(self):
        if self._raw_phase is None and self._psi_dev is not None:
            self._raw_phase = np.asarray(
                self._psi_dev, dtype=self.dtype
            ).reshape(self.slm_shape)
        return self._raw_phase

    @phase.setter
    def phase(self, value):
        self._raw_phase = (
            None if value is None else np.asarray(value, dtype=self.dtype)
        )
        self._psi_dev = None

    # Alias for shared code paths (the base class stores the folded
    # nearfield phase in ``_psi``; compressed holograms store it
    # directly, so the two views coincide).
    @property
    def _psi(self):
        return self.phase

    @_psi.setter
    def _psi(self, value):
        self.phase = value

    def _psi_device_flat(self, for_donation=False):
        """Flat float32 psi on device, reusing the engine's copy when
        the host copy was never materialized (and so cannot have been
        mutated behind our back). ``for_donation``: return a private
        on-device copy of the resident buffer so donating runs cannot
        leave ``_psi_dev`` deleted if they raise (see the base class's
        ``_psi_device``)."""
        if self._psi_dev is not None and self._raw_phase is None:
            return self._psi_dev.copy() if for_donation else self._psi_dev
        return jnp.asarray(np.asarray(self.phase, np.float32).ravel())

    def _set_psi_device(self, psi):
        """Adopt a device-resident flat psi as the current phase; the
        host copy materializes lazily through the ``phase`` property."""
        self._raw_phase = None
        self._psi_dev = psi

    @property
    def phase_ff(self):
        """(N,) farfield spot phases."""
        return self._phase_ff_folded

    @phase_ff.setter
    def phase_ff(self, value):
        self._phase_ff_folded = None if value is None else np.asarray(value)

    def _populate_results(self):
        """Compute the (N,) farfield from the current phase."""
        from slmsuite_tpu.ops import compressed as _comp

        consts = self._compressed_consts()
        psi = self._psi_device_flat()

        n_spots = len(self)
        use_pallas = self._use_kernels()
        fn_key = (n_spots, use_pallas)
        cached_fn = getattr(self, "_populate_fn", None)
        fn = cached_fn[1] if cached_fn and cached_fn[0] == fn_key else None
        if fn is None:
            import functools

            @functools.partial(jax.jit)
            def fn(psi, amp, coeffs, basis):
                nf_re = amp * jnp.cos(psi)
                nf_im = amp * jnp.sin(psi)
                if use_pallas:
                    from slmsuite_tpu.ops.pallas_compressed import (
                        nearfield_to_farfield as n2f,
                    )
                else:
                    n2f = _comp.nearfield_to_farfield
                ff_re, ff_im = n2f(nf_re, nf_im, coeffs, basis, n_spots)
                return (
                    jnp.sqrt(ff_re**2 + ff_im**2),
                    jnp.arctan2(ff_im, ff_re),
                )

            self._populate_fn = (fn_key, fn)

        amp_ff, phase_ff = fn(
            psi, consts["amp"], consts["coeffs"], consts["basis"]
        )
        self._farfield_folded = None
        self.amp_ff = np.asarray(amp_ff)
        self._phase_ff_folded = np.asarray(phase_ff)

    @property
    def farfield(self):
        """(N,) complex spot farfield."""
        if self.amp_ff is None:
            return None
        return self.amp_ff * np.exp(1j * self._phase_ff_folded)

    def get_farfield(self, *args, **kwargs):
        """(N,) complex spot farfield from the current phase."""
        self._populate_results()
        return self.farfield

    # ------------------------------------------------------------------
    # Quadratic initial-phase support (ref _spots.py:566-592): the target
    # is a spot list, so moments are taken over spot positions in
    # normalized knm space instead of over a 2D grid.
    # ------------------------------------------------------------------

    def _get_target_moments_knm_norm(self):
        """First/second moments of the spot ensemble in normalized knm."""
        target = np.nan_to_num(np.asarray(self.target, dtype=float))
        target = target.reshape(1, -1, 1)

        spot_knm_norm = toolbox.convert_vector(
            self.spot_kxy[:2, :],
            from_units="kxy",
            to_units="knm",
            hardware=self.cameraslm,
            shape=(1, 1),
        )
        grid = (
            spot_knm_norm[0, :].reshape(-1, 1) - 0.5,
            spot_knm_norm[1, :].reshape(-1, 1) - 0.5,
        )
        center = analysis.image_positions(target, grid=grid, nansum=True)
        std = np.sqrt(
            analysis.image_variances(
                target, centers=center, grid=grid, nansum=True
            )[:2, 0]
        )
        return np.squeeze(center), np.squeeze(std)

    # ------------------------------------------------------------------
    # Conjugate gradient (ref _hologram.py:1664-1740 applied to the
    # compressed transform; jax.grad flows through the Zernike kernel).
    # ------------------------------------------------------------------

    def optimize_cg(self, iterations, callback):
        """
        Gradient descent on the SLM phase through the compressed
        near->far transform with :func:`jax.value_and_grad` and an optax
        optimizer; flags mirror :meth:`Hologram.optimize_cg` (``loss``,
        ``optimizer``, ``optimizer_kwargs``).
        """
        import optax

        from slmsuite_tpu.ops import compressed as _comp

        consts = self._compressed_consts()
        # Always differentiate through the jnp transform: the fused
        # kernels (``self.cuda``) have no autodiff rule.
        n2f = _comp.nearfield_to_farfield

        amp = consts["amp"]
        coeffs = consts["coeffs"]
        basis = consts["basis"]
        n_spots = len(self)
        target = jnp.asarray(self.target, dtype=jnp.float32)
        target = target / jnp.sqrt(jnp.sum(jnp.square(target)))

        loss = self.flags.get("loss")
        if loss is None:
            def loss(farfield, target):
                amp_ff = jnp.abs(farfield)
                amp_ff = amp_ff / jnp.sqrt(jnp.sum(jnp.square(amp_ff)))
                return jnp.mean(jnp.square(amp_ff - target))

        def loss_from_psi(psi):
            nf_re = amp * jnp.cos(psi)
            nf_im = amp * jnp.sin(psi)
            ff_re, ff_im = n2f(nf_re, nf_im, coeffs, basis, n_spots)
            return loss(ff_re + 1j * ff_im, target)

        optimizer_name = str(self.flags.get("optimizer", "adam")).lower()
        kwargs = dict(self.flags.get("optimizer_kwargs", {"learning_rate": 0.1}))
        if "lr" in kwargs:
            kwargs["learning_rate"] = kwargs.pop("lr")
        optimizer = getattr(optax, optimizer_name)(**kwargs)

        @jax.jit
        def cg_step(psi, opt_state):
            value, grads = jax.value_and_grad(loss_from_psi)(psi)
            updates, opt_state = optimizer.update(grads, opt_state, psi)
            return optax.apply_updates(psi, updates), opt_state, value

        psi = self._psi_device_flat()
        opt_state = optimizer.init(psi)

        for _ in iterations:
            psi, opt_state, value = cg_step(psi, opt_state)
            self.flags["loss_result"] = float(value)
            if hasattr(iterations, "set_description"):
                iterations.set_description(f"loss={float(value):.3e}")
            if callback is not None:
                self._set_psi_device(psi)
                if callback(self):
                    break
            if self.flags.get("stat_groups"):
                self._set_psi_device(psi)
                self._populate_results()
                self._update_stats(self.flags["stat_groups"])
            self.iter += 1

        self._set_psi_device(psi)
        self._populate_results()

    # ------------------------------------------------------------------
    # Weighting and stats (ref :949-1045).
    # ------------------------------------------------------------------

    def _update_weights(self):
        feedback = self.flags["feedback"]

        if feedback == "computational":
            feedback = self.flags["feedback"] = "computational_spot"
        if feedback == "experimental":
            feedback = self.flags["feedback"] = "experimental_spot"

        if feedback == "computational_spot":
            amp_feedback = self.amp_ff
        elif feedback == "experimental_spot":
            self.measure(basis="ij")
            amp_feedback = np.sqrt(
                analysis.take(
                    np.square(np.asarray(self.img_ij, dtype=self.dtype)),
                    self.spot_ij,
                    self.spot_integration_width_ij,
                    centered=True,
                    integrate=True,
                )
            )
        elif feedback == "external_spot":
            amp_feedback = self.external_spot_amp
        else:
            raise ValueError(f"Feedback '{feedback}' not recognized.")

        self.weights = np.asarray(
            update_weights_generic(
                jnp.asarray(np.nan_to_num(self.weights), dtype=jnp.float32),
                jnp.asarray(np.asarray(amp_feedback, np.float32)),
                jnp.asarray(np.nan_to_num(np.asarray(self.target, np.float32))),
                self.flags["method"],
                self.flags.get("feedback_exponent", 0.8),
                self.flags.get("feedback_factor", 0.1),
            )
        )

    def _populate_stats(self, stats, stat_groups):
        if "computational_spot" in stat_groups and self._has_amp_ff():
            stats["computational_spot"] = self._calculate_stats(
                self.amp_ff,
                np.nan_to_num(np.asarray(self.target)),
                efficiency_compensation=False,
                raw=bool(self.flags.get("raw_stats")),
            )
        # Experimental/external spot groups from the shared abstract class.
        _AbstractSpotHologram._populate_stats(self, stats, stat_groups)


def dataclasses_replace_stats(config):
    """Stepwise path computes stats host-side; strip device stat groups."""
    import dataclasses as _dc

    return _dc.replace(config, stat_groups=())
