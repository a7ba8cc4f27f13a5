r"""
Multiplane holography: several child holograms sharing one nearfield.

Parity: reference ``slmsuite/holography/algorithms/_multiplane.py``.

Each child (possibly at a different focal plane via its
``propagation_kernel``) computes its own farfield and constraint; the
complex nearfields (kernels removed) are weight-summed into the shared
phase. The loop runs as jitted per-child forward/constraint stages plus
one jitted combine; for homogeneous computational children the
mesh-sharded batched engine (:mod:`slmsuite_tpu.parallel.multiplane`)
offers the same math data-parallel across chips.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from slmsuite_tpu.misc.progress import tqdm

from slmsuite_tpu.holography.algorithms._hologram import Hologram
from slmsuite_tpu.ops import propagation as _prop


@functools.lru_cache(maxsize=32)
def _child_backward(config):
    """
    Jitted: constrained farfield -> weighted complex nearfield window
    (propagation kernel removed).
    """
    y0, _, x0, _ = _prop.pad_window_slices(config.shape, config.slm_shape)

    def backward(farfield, weights, phase_ff, plane_weight, consts):
        kernel = consts.get("kernel") if config.has_kernel else None
        constrained = weights * jnp.exp(1j * phase_ff)
        if config.mraf:
            constrained = jnp.where(consts["signal_mask"], constrained, farfield)
            if config.mraf_factor:
                constrained = jnp.where(
                    consts["noise_mask"], consts["mraf_factor"] * constrained, constrained
                )
            constrained = jnp.where(consts["zero_mask"], 0.0, constrained)
        nearfield = _prop.farfield_to_nearfield(constrained)
        window = jax.lax.dynamic_slice(nearfield, (y0, x0), tuple(config.slm_shape))
        if kernel is not None:
            window = window * jnp.exp(-1j * kernel)
        return plane_weight * window

    return jax.jit(backward)


@jax.jit
def _combine_windows(windows):
    """Sum the per-child complex windows; extract the shared folded phase."""
    total = functools.reduce(jnp.add, windows)
    return jnp.arctan2(total.imag, total.real)


class MultiplaneHologram(Hologram):
    """
    Meta-hologram optimizing ``N`` child holograms simultaneously through
    one shared phase pattern.

    Attributes
    ----------
    holograms : list of Hologram
        Children (any non-multiplane Hologram subclass).
    weights : numpy.ndarray
        Per-child power weights (normalized).
    """

    def __init__(self, holograms, weights=None):
        """Initialize from children; weights default to even power."""
        self.holograms = holograms

        for h in self.holograms:
            if isinstance(h, MultiplaneHologram):
                raise ValueError("Multiplane hologram recursion is not supported.")
            if not isinstance(h, Hologram):
                raise ValueError(
                    f"Multiplane hologram must be given child holograms, not {type(h)}"
                )

        super().__init__(
            target=holograms[0].slm_shape,
            amp=holograms[0].amp,
            phase=holograms[0].phase,
            slm_shape=holograms[0].slm_shape,
            dtype=holograms[0].dtype,
        )
        self.target = None

        # Children share the parent's nearfield.
        for h in self.holograms:
            h.amp = self.amp

        if weights is None:
            weights = np.ones(len(self), dtype=self.dtype)
        self.weights = np.asarray(weights, dtype=self.dtype)
        self.weights = self.weights / Hologram._norm(self.weights)

    def __len__(self):
        return len(self.holograms)

    @staticmethod
    def get_multiplane_defocus_blur(cameraslm, targets, target_depths, return_depths=None, sharp_focus=True):
        """
        Propagate a stack of target images between depths with Gaussian
        defocus blur (ref ``_multiplane.py:86-170``).
        """
        import cv2

        if return_depths is None:
            return_depths = target_depths
        targets = np.asarray(targets)
        if targets.ndim != 3:
            raise ValueError("Expected 3D stack of 2D images.")
        image_count, h, w = targets.shape
        if image_count != len(target_depths):
            raise ValueError("There should be the same number of images as target_depths.")

        if cameraslm.cam.pitch_um is None:
            raise ValueError("Camera pitch_um is necessary to calculate defocus blur.")

        canvas = np.zeros((len(return_depths), h, w))
        f_eff = np.sqrt(np.abs(np.linalg.det(cameraslm.calibrations["fourier"]["M"])))
        w0_kxy = cameraslm.slm.get_spot_radius_kxy()
        w0_pix = f_eff * w0_kxy
        w0_um = w0_pix * np.mean(cameraslm.cam.pitch_um)
        zr = np.pi * w0_um * w0_um / cameraslm.slm.wav_um

        for j, z2 in enumerate(return_depths):
            for i, z1 in enumerate(target_depths):
                dz = (z1 - z2) * (f_eff * f_eff)
                blur = w0_pix * (np.sqrt(1 + (dz / zr) ** 2) - (1 if sharp_focus else 0))
                blur = 2 * int(blur) + 1
                canvas[j, :, :] += cv2.GaussianBlur(targets[i], (blur, blur), 0)

        return canvas

    # ------------------------------------------------------------------
    # Meta plumbing (ref :175-289).
    # ------------------------------------------------------------------

    def _update_flags(self, method, verbose, feedback, stat_groups, **kwargs):
        super()._update_flags(method, verbose, feedback, stat_groups, **kwargs)
        for h in self.holograms:
            h.flags.update(self.flags)

    def reset(self, reset_phase=True, reset_flags=False):
        super().reset(reset_phase, reset_flags)
        if hasattr(self, "holograms"):
            for h in self.holograms:
                h.reset(reset_phase=False, reset_flags=reset_flags)

    def reset_weights(self):
        if hasattr(self, "holograms"):
            for h in self.holograms:
                h.reset_weights()

    def set_target(self, *args, **kwargs):
        raise RuntimeError(
            "Do not use MultiplaneHologram.set_target(). "
            "Update the targets of the child holograms directly."
        )

    def _update_stats(self, stat_groups=[]):
        for h in self.holograms:
            h._update_stats(stat_groups)

    def plot_farfield(self, *args, **kwargs):
        for h in self.holograms:
            h.plot_farfield(*args, **kwargs)

    def plot_stats(self, *args, **kwargs):
        for h in self.holograms:
            h.plot_stats(*args, **kwargs)

    def remove_vortices(self):
        for h in self.holograms:
            h.remove_vortices()

    # ------------------------------------------------------------------
    # Optimization: meta GS loop.
    # ------------------------------------------------------------------

    #: ``optimize(mesh=...)`` runs planes data-parallel over the mesh.
    _supports_mesh = True

    def _mesh_eligible(self, callback, n_dev=None, warn=True):
        """Whether the data-parallel batched engine covers this problem:
        homogeneous plain-Hologram children (MRAF masks included — they
        are plane-local), computational feedback, plane count divisible
        by the device count. With ``n_dev=1`` (the meshless scanned
        promotion) the check is silent unless ``warn``."""
        import warnings

        children = self.holograms
        reasons = []
        if callback is not None:
            reasons.append("callback requires the host meta loop")
        if any(type(h) is not Hologram for h in children):
            reasons.append("children must be plain Hologram instances")
        if self.flags.get("feedback", "computational") != "computational":
            reasons.append("only computational feedback is data-parallel")
        shapes = {tuple(h.shape) for h in children}
        if len(shapes) != 1:
            reasons.append("children must share one farfield shape")
        if any(bool(h.flags.get("zero_factor", 0)) for h in children) or bool(
            self.flags.get("zero_factor", 0)
        ):
            reasons.append(
                "zero_factor (evolving zero-region weights) carries extra "
                "complex state; host meta loop only"
            )
        groups = set(self.flags.get("stat_groups", []))
        if groups - {"computational"}:
            reasons.append("only 'computational' stats are device-side here")
        if n_dev is None:
            n_dev = int(np.prod(list(self._mesh.shape.values())))
        if len(children) % n_dev:
            reasons.append(
                f"plane count {len(children)} must divide the mesh ({n_dev})"
            )
        if reasons:
            if warn:
                warnings.warn(
                    "mesh-sharded multiplane optimization unavailable ("
                    + "; ".join(reasons) + "); running the host meta loop."
                )
            return False
        return True

    def _optimize_gs_mesh(self, maxiter, verbose, name, mesh=None):
        """Data-parallel multiplane GS: planes shard over the mesh, the
        nearfield accumulation is one psum per iteration
        (:mod:`slmsuite_tpu.parallel.multiplane`). With a single-device
        ``mesh`` this is the meshless scanned promotion: the whole run is
        one on-device scan instead of per-iteration host-paced calls."""
        from slmsuite_tpu.parallel.multiplane import (
            BatchedGSConfig,
            make_multiplane_consts,
            run_batched_gs,
        )

        children = self.holograms
        start_iter = self.iter
        shape = tuple(children[0].shape)
        slm_shape = tuple(self.slm_shape)

        # Raw targets keep their NaN noise regions: make_multiplane_consts
        # derives per-plane MRAF region codes from them and cleans the
        # stored planes.
        targets = np.stack(
            [np.asarray(h.target, np.float32) for h in children]
        )
        mraf = bool(np.any(np.isnan(targets)))
        kernels = np.stack(
            [
                np.zeros(slm_shape, np.float32)
                if h.propagation_kernel is None
                else np.asarray(h.propagation_kernel, np.float32)
                for h in children
            ]
        )
        weights0 = jnp.asarray(
            np.stack(
                [
                    np.nan_to_num(np.asarray(h.weights, np.float32))
                    for h in children
                ]
            )
        )
        config = BatchedGSConfig(
            method=self.flags["method"],
            shape=shape,
            slm_shape=slm_shape,
            n_planes=len(children),
            # Kernel-free batches skip the per-plane kernel add and the
            # backward complex multiply entirely (the zero-kernel stack
            # stays in consts only to keep the sharding specs uniform).
            has_kernel=any(
                h.propagation_kernel is not None for h in children
            ),
            stats=bool(self.flags.get("stat_groups", [])),
            kim_efficiency_trigger=(
                "Kim" in self.flags["method"]
                and self.flags.get("fix_phase_efficiency") is not None
            ),
            mraf=mraf,
            mraf_factor=mraf and self.flags.get("mraf_factor") is not None,
        )
        consts = make_multiplane_consts(
            targets,
            kernels,
            np.asarray(self.weights, np.float32),
            self.amp,
            feedback_exponent=self.flags.get("feedback_exponent", 0.8),
            feedback_factor=self.flags.get("feedback_factor", 0.1),
            fix_phase_iteration=self.flags.get("fix_phase_iteration", 10),
            fix_phase_efficiency=self.flags.get("fix_phase_efficiency"),
            mraf_factor=self.flags.get("mraf_factor"),
        )
        psi = self._psi_device()
        if mesh is None:
            mesh = self._mesh
        axis = mesh.axis_names[0]

        # Resume state, mirroring the single-plane engine's seeding:
        # global iterations continue at self.iter, the Kim fixed flags
        # come from the children's flags, and the phase store from
        # their _phase_ff_folded (zeros on a fresh run) — so back-to-back
        # optimize() calls match one longer run.
        phase_ff0 = (
            jnp.stack([h._phase_ff_folded_device() for h in children])
            if all(h._has_phase_ff() for h in children)
            else None
        )
        fixed0 = np.array(
            [bool(h.flags.get("fixed_phase", False)) for h in children]
        )

        progress = tqdm(total=maxiter, desc=name) if verbose and maxiter > 1 else None
        psi, weights, stats, phase_ff, fixed = run_batched_gs(
            config, psi, weights0, consts, maxiter,
            mesh=mesh, axis_name=axis,
            start_iteration=start_iter, phase_ff=phase_ff0, fixed=fixed0,
        )
        if progress is not None:
            progress.update(maxiter)
            progress.close()

        # Scatter the state back into the children (gather across shards).
        self._psi = np.asarray(psi)  # host: children share the same view
        stats = np.asarray(stats)  # (n, B, 5): 4 metrics + Kim flag history.
        weights = np.asarray(weights)
        phase_ff = np.asarray(phase_ff)
        fixed = np.asarray(fixed)
        for b, h in enumerate(children):
            h._psi = self._psi
            h.weights = weights[b]
            h._phase_ff_folded = phase_ff[b]
            h.flags["fixed_phase"] = bool(fixed[b])
            h.iter = start_iter + maxiter
            if config.stats and h.flags.get("stat_groups"):
                # History column records the pre-iteration flag, so this
                # lags a potential flip in the very last iteration.
                h._final_fixed_phase = bool(stats[-1, b, 4])
                # (n, n_groups + 1, 4): the child's computational row plus
                # the internal flag-history row the recorder expects.
                n_groups = len(h.flags["stat_groups"])
                arr = np.full((maxiter, n_groups + 1, 4), np.nan, np.float32)
                for g, group in enumerate(h.flags["stat_groups"]):
                    if group == "computational":
                        arr[:, g, :] = stats[:, b, :4]
                arr[:, -1, 0] = stats[:, b, 0]
                arr[:, -1, 1] = stats[:, b, 4]
                h._record_scan_stats(arr, start_iter)
        self.iter = start_iter + maxiter
        self._populate_results()

    def optimize_gs(self, maxiter, callback, verbose=True, name=None):
        """
        Meta GS: per-iteration, every child runs its jitted forward +
        stats + weight update + constraint; the complex nearfields combine
        through one jitted weighted sum into the shared phase.

        With ``optimize(mesh=...)`` and a homogeneous computational
        problem, planes run data-parallel over the mesh instead
        (one psum of the weighted nearfields per iteration).
        """
        if isinstance(maxiter, range):
            maxiter = len(maxiter)

        if self._mesh is not None and self._mesh_eligible(callback):
            return self._optimize_gs_mesh(maxiter, verbose, name)
        if self._mesh is None and self._mesh_eligible(callback, n_dev=1, warn=False):
            # Meshless scanned promotion: run the batched engine on one
            # device — a single jitted scan replaces per-iteration
            # host-paced child calls.
            from slmsuite_tpu.parallel import make_mesh

            import jax as _jax

            mesh = make_mesh(axis_names=("data",), devices=_jax.devices()[:1])
            return self._optimize_gs_mesh(maxiter, verbose, name, mesh=mesh)

        children = self.holograms
        configs = [h._build_config() for h in children]
        consts = [h._build_consts(c) for h, c in zip(children, configs)]

        iterations = range(maxiter)
        if verbose and maxiter > 1:
            iterations = tqdm(iterations, desc=name)

        amp = (
            jnp.float32(self.amp)
            if np.isscalar(self.amp)
            else jnp.asarray(self.amp, dtype=jnp.float32)
        )

        for _ in iterations:
            windows = []
            stop = False

            psi_dev = self._psi_device()
            for h, config, c in zip(children, configs, consts):
                # Forward with the child's kernel, from the shared phase.
                h._psi = psi_dev
                kernel = c.get("kernel") if config.has_kernel else None
                farfield, amp_ff, theta = _prop.forward_fields(
                    psi_dev,
                    amp,
                    config.shape,
                    kernel,
                )
                h._farfield_folded = farfield
                h.amp_ff = amp_ff  # device; host view materializes lazily
                h._midloop_cleaning()
                h.iter = self.iter

                # Stats + weights + Kim decision per child.
                h._update_stats(h.flags.get("stat_groups", []))
                was_not_fixed = not h.flags.get("fixed_phase", False)
                if "WGS" in h.flags["method"] and h.iter > 0:
                    h._update_weights()
                    h._kim_decision_host()
                if was_not_fixed or not h._has_phase_ff():
                    h._phase_ff_folded = theta

                weights = jnp.asarray(
                    np.nan_to_num(np.asarray(h.weights, dtype=np.float32))
                )
                backward = _child_backward(config)
                windows.append(
                    backward(
                        farfield,
                        weights,
                        h._phase_ff_folded_device(),
                        jnp.float32(self.weights[children.index(h)]),
                        c,
                    )
                )

            self._psi = _combine_windows(tuple(windows))  # stays on device

            if callback is not None and callback(self):
                stop = True

            self.iter += 1
            if stop:
                break

        self._populate_results()

    # ------------------------------------------------------------------
    # Conjugate gradient: summed child losses (ref _multiplane.py:246-253).
    # ------------------------------------------------------------------

    def optimize_cg(self, iterations, callback):
        """
        Gradient descent on the shared phase: the total loss is the
        plane-weighted sum of each child's loss (each child forward runs
        with its own propagation kernel and target), differentiated in
        one :func:`jax.value_and_grad` through all planes.
        """
        import optax

        children = self.holograms
        amp = (
            jnp.float32(self.amp)
            if np.isscalar(self.amp)
            else jnp.asarray(self.amp, dtype=jnp.float32)
        )
        shapes = [tuple(h.shape) for h in children]
        kernels = [
            None
            if h.propagation_kernel is None
            else jnp.asarray(h.propagation_kernel, dtype=jnp.float32)
            for h in children
        ]
        targets = [
            jnp.asarray(np.nan_to_num(np.asarray(h.target, np.float32)))
            for h in children
        ]
        plane_weights = [jnp.float32(w) for w in self.weights]

        loss = self.flags.get("loss")
        if loss is None:
            def loss(farfield, target):
                amp_ff = jnp.abs(farfield)
                amp_ff = amp_ff / jnp.sqrt(jnp.sum(jnp.square(amp_ff)))
                return jnp.mean(jnp.square(amp_ff - target))

        def loss_from_psi(psi):
            total = 0.0
            for shape, kernel, target, weight in zip(
                shapes, kernels, targets, plane_weights
            ):
                nearfield = _prop.build_folded_nearfield(psi, amp, shape, kernel)
                farfield = _prop.unfold_farfield(
                    _prop.nearfield_to_farfield(nearfield)
                )
                total = total + weight * loss(farfield, target)
            return total

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

        psi = self._psi_device()
        opt_state = optimizer.init(psi)

        for _ in iterations:
            psi, opt_state, value = cg_step(psi, opt_state)
            self.flags["loss_result"] = float(value)
            if hasattr(iterations, "set_description"):
                iterations.set_description(f"loss={float(value):.3e}")
            if callback is not None:
                self._psi = psi
                if callback(self):
                    break
            self.iter += 1

        self._psi = psi
        for h in children:
            h._psi = psi
            h.iter = self.iter
        self._populate_results()
