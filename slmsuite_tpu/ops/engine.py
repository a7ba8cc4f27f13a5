r"""
The scanned Gerchberg-Saxton engine.

The reference's hot loop (``_hologram.py:1427-1493``) mutates device
arrays in place between two FFTs. Here the whole iteration is a pure step
function over an immutable :class:`GSState` pytree, scanned with
``lax.scan`` and jitted with donated buffers — XLA fuses every elementwise
stage into the FFT prologue/epilogue, and per-iteration statistics are
accumulated on device (fetched once per optimize call).

Iteration structure (parity with ``optimize_gs``):

    (A) folded nearfield -> farfield          (fft2, no shifts; see ops.propagation)
    (B.2) device stats per stat group
    (B.3) WGS weight update (iter > 0), Kim phase-fixing decision,
          amplitude constraint (plain or MRAF-masked)
    (C) farfield -> nearfield, folded phase extraction

Static configuration (method, feedback mode, MRAF masks present, stats
groups) selects the traced branch; numeric flags (exponents, factors,
fix-phase thresholds) are dynamic scalars so tuning them never recompiles.
"""

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slmsuite_tpu.ops.propagation import (
    build_folded_nearfield,
    extract_folded_phase,
    farfield_to_nearfield,
    nearfield_to_farfield,
)
from slmsuite_tpu.ops.stats import calculate_stats
from slmsuite_tpu.ops.weights import update_weights_generic


class GSState(NamedTuple):
    """
    Scan carry: everything that evolves across GS iterations.

    All leaves are real-valued: complex quantities live only inside the
    jitted step (``zero_weights`` is carried as a (2, H, W) re/im pair),
    so host transfers never move complex arrays.
    """

    psi: jnp.ndarray            # (Hs, Ws) folded nearfield phase
    weights: jnp.ndarray        # (H, W) farfield weight amplitudes
    phase_ff: jnp.ndarray       # (H, W) stored farfield phase (Kim)
    zero_weights: jnp.ndarray   # (2, H, W) f32 re/im (zero_factor) or (2, 0, 0)
    fixed_phase: jnp.ndarray    # bool scalar
    unfixed_streak: jnp.ndarray  # int32: consecutive unfixed iterations
    iteration: jnp.ndarray      # int32: global iteration counter
    #: f32 scalar: the current weights' norm under the fused loop's
    #: deferred-by-one normalization (weights are stored unnormalized and
    #: renormalized once on exit); None on non-fused paths.
    w_norm: jnp.ndarray = None


@dataclasses.dataclass(frozen=True)
class GSConfig:
    """Static (trace-time) configuration of the engine."""

    method: str
    shape: tuple
    slm_shape: tuple
    #: Device feedback mode. ``computational`` / ``computational_spot``
    #: update weights on device from the computed farfield;
    #: ``experimental_spot_sim`` closes the camera loop ON DEVICE for a
    #: simulated rig (see :meth:`sim_measure_spots`); ``external`` /
    #: ``external_spot`` leave weights to host updates between stepwise
    #: invocations.
    feedback: str = "computational"
    stat_groups: tuple = ()
    mraf: bool = False
    mraf_factor: bool = False        # apply the noise-region attenuation factor
    zero_factor: bool = False        # evolving zero-region weights
    has_kernel: bool = False
    kim_efficiency_trigger: bool = False
    nan_checks: bool = True
    spot_count: int = 0
    spot_window: int = 0             # integration width for *_spot feedback
    spot_single_px: bool = False     # stats skip integration (shape == slm_shape)
    scrambled: bool = False          # farfield in four-step (k1,k2) layout
    # Simulated-rig closed loop (feedback == "experimental_spot_sim" or
    # stat group "experimental_spot" on a qualifying rig): statics of the
    # in-scan camera model. See :meth:`sim_measure_spots`.
    sim_bitres: float = 0.0          # SLM gray levels (power of two)
    sim_cam_sat: float = 0.0         # camera saturation level (counts)
    sim_truncates: bool = False      # camera dtype is integer (floor counts)
    sim_shape_padded: tuple = ()     # camera FFT canvas shape
    #: Four-step matmul precision for THIS compiled run ("HIGHEST" |
    #: "HIGH" | "DEFAULT"; on a GPU "DEFAULT" runs the stage matmuls in
    #: TF32); None inherits the module global
    #: (:func:`slmsuite_tpu.ops.fft.set_fft_precision`). Distinct values
    #: compile distinct programs (the field is part of the lru_cache
    #: key), which is what makes the coarse-then-refine precision
    #: schedule of :func:`run_gs_scheduled` possible. The ``"xla"`` FFT
    #: tier ignores it.
    kernel_precision: str = None

    @property
    def is_wgs(self):
        return self.method.startswith("WGS")

    @property
    def is_kim(self):
        return "Kim" in self.method


def sim_measure_spots(psi, consts, *, bitres, cam_sat, truncates,
                      shape_padded):
    """
    Device twin of the simulated rig's measure path: quantized-display
    formation (``SLM._phase2gray`` for ``phase_scaling == 1`` and a
    power-of-two bitdepth), simulated far-field on the camera's padded
    canvas, interpolated camera sampling, exposure scaling, saturation,
    and spot-window integration. The exact jit composite behind both the
    one-shot fast measure (``_AbstractSpotHologram._sim_spot_powers``)
    and the in-scan device-resident closed loop
    (``feedback == "experimental_spot_sim"``). Reference semantics:
    ``/root/reference/slmsuite/hardware/cameras/simulated.py:344-404``
    driven per-iteration by ``_hologram.py:1186-1212``.

    ``consts`` keys (all device-resident, loop-invariant):

    - ``sim_pre``: slm-shaped phase pre-sum (-hologram checkerboard +
      propagation kernel + hardware correction phase).
    - ``sim_post``: slm-shaped post-sum (simulated aberration phase +
      camera-canvas checkerboard).
    - ``sim_amp``: slm-shaped simulated source amplitude.
    - ``sim_flat_cam`` / ``sim_valid_cam``: camera-pixel gather map into
      the raveled padded farfield power + validity weights.
    - ``sim_spot_flat``: (N, D*D) gather of spot integration windows
      into the raveled camera image.
    - ``sim_scale``: exposure_s * gain (dynamic scalar).

    Returns ``(spot_powers (N,), total_power ())`` in camera counts.
    """
    two_pi = 2.0 * np.pi
    phase = psi + consts["sim_pre"]
    # Quantization twin of SLM._phase2gray: display = (rint(-phase*s)
    # - 1) mod 2^b (the all-negative shift is a multiple of the modulus).
    q = jnp.round(phase * jnp.float32(-bitres / two_pi)) - 1.0
    disp = jnp.mod(q, jnp.float32(bitres))
    # Global phase offsets drop out of |F|; the quantized phase + the
    # simulated aberration remain.
    phase_cam = -disp * jnp.float32(two_pi / bitres) + consts["sim_post"]
    nearfield = build_folded_nearfield(
        phase_cam, consts["sim_amp"], tuple(shape_padded)
    )
    farfield = nearfield_to_farfield(nearfield)
    pwr = (jnp.square(farfield.real) + jnp.square(farfield.imag)).ravel()
    img = (
        jnp.take(pwr, consts["sim_flat_cam"].ravel())
        * consts["sim_valid_cam"].ravel()
        * consts["sim_scale"]
    )
    img = jnp.minimum(img, jnp.float32(cam_sat))
    if truncates:
        # The host camera casts counts to its integer dtype (non-negative
        # values: floor == trunc).
        img = jnp.floor(img)
    total = jnp.sum(img)
    spots = jnp.sum(jnp.take(img, consts["sim_spot_flat"]), axis=-1)
    return spots, total


def _spot_feedback_amp(amp_ff_sq, consts):
    """
    Integrated power around each spot -> feedback amplitudes (N,).
    ``consts["spot_flat_idx"]`` is a precomputed (N, D*D) gather map into
    the raveled farfield plane (the jit analog of ``analysis.take``).
    """
    gathered = jnp.take(amp_ff_sq.ravel(), consts["spot_flat_idx"], axis=0)
    return jnp.sqrt(jnp.sum(gathered, axis=-1))


def _compute_group_stats(group, config, consts, amp_ff, spot_feedback,
                         sim_measured=None):
    """Length-4 stats vector for one stat group (device-side)."""
    if group == "computational":
        return calculate_stats(
            amp_ff,
            consts["target"],
            mask=consts["stat_mask"],
            efficiency_compensation=False,
        )
    if group == "computational_spot":
        total = jnp.sum(jnp.square(amp_ff))
        if config.spot_single_px:
            # Spot size is one pixel wide: no integration (ref :1632-1641).
            feedback = amp_ff.ravel()[consts["spot_center_idx"]]
        else:
            feedback = spot_feedback
        return calculate_stats(
            feedback,
            consts["spot_amp"],
            mask=consts["spot_amp"] != 0,
            efficiency_compensation=False,
            total=total,
        )
    if group == "experimental_spot" and sim_measured is not None:
        # Device-resident simulated closed loop: stats from the in-scan
        # camera measure (host twin: _AbstractSpotHologram._populate_stats).
        sim_spot_pwr, sim_total = sim_measured
        return calculate_stats(
            jnp.sqrt(sim_spot_pwr),
            consts["spot_amp"],
            mask=consts["spot_amp"] != 0,
            efficiency_compensation=False,
            total=sim_total,
        )
    # Remaining experimental groups are host-side; filled with nan on device.
    return jnp.full((4,), jnp.nan, dtype=jnp.float32)


#: WGS rules whose weight correction is purely elementwise (no global
#: reduction mid-update) once the Parseval feedback norm is substituted —
#: the set the fully-fused step supports. Nogrette needs a nanmean of the
#: correction and stays on the standard path.
_FUSABLE_METHODS = ("WGS-Leonardo", "WGS-Kim", "WGS-Wu", "WGS-tanh")


def _fused_common(config: GSConfig):
    """Shared gate for the fused/semi-fused scrambled WGS steps."""
    needs_spot = (
        config.feedback == "computational_spot"
        or "computational_spot" in config.stat_groups
    )
    return (
        config.scrambled
        and tuple(config.shape) == tuple(config.slm_shape)
        and not config.has_kernel
        and config.is_wgs
        and config.feedback == "computational"
        and not needs_spot
        and config.method in _FUSABLE_METHODS
        and (not config.kim_efficiency_trigger or bool(config.stat_groups))
        and config.nan_checks
        and all(g == "computational" for g in config.stat_groups)
    )


def _fused_active(config: GSConfig):
    """True when the fully-fused scrambled WGS step applies to ``config``.

    Requires the phase-in/phase-out geometry (farfield == SLM shape, no
    propagation kernel), plain computational feedback, a fusable weight
    rule, and no couplings that need a reduction before the constraint
    (MRAF masks, spot integration). Kim's efficiency trigger fuses when
    stats are tracked: it compares the current-step efficiency that the
    kernel already accumulates, and the in-kernel phase select always
    uses the previous flag.
    """
    return _fused_common(config) and not config.mraf


def _mraf_fused_active(config: GSConfig):
    """True when the MRAF carry-mode step applies: like the fused WGS
    gate but WITH MRAF masks (the signal:noise mix needs the exact
    current weight norm, so one scalar reduction syncs between the
    forward and inverse column passes). Evolving zero-region weights
    (``zero_factor``) fold into the mix kernel as an elementwise complex
    update of the carried (2, H, W) plane. Restricted to Leonardo/Kim:
    their correction factor is exactly 1 on the cleaned (noise -> 0)
    target, matching the standard path's NaN guard; Wu/tanh propagate
    the NaN target into 1e-4 noise weights (reference behavior) whose
    norm contribution the kernels would not reproduce."""
    return (
        _fused_common(config)
        and config.mraf
        and config.method in ("WGS-Leonardo", "WGS-Kim")
    )


def _augment_fused_consts(config: GSConfig, consts):
    """Loop-invariant scalars for the fused step (computed once per run,
    before the scan — XLA does not hoist these out of the loop itself)."""
    consts = dict(consts)
    amp = consts["amp"]
    H, W = config.shape
    if jnp.ndim(amp) == 0:
        # Parseval: sum |F|^2 == sum amp^2 exactly for the ortho pair.
        fsum = jnp.square(amp) * (H * W)
    else:
        fsum = jnp.sum(jnp.square(amp))
    consts["_inv_fsum"] = 1.0 / fsum
    consts["_inv_fnorm"] = 1.0 / jnp.sqrt(fsum)
    if config.stat_groups:
        mask_f = consts["stat_mask"].astype(jnp.float32)
        consts["_stat_mask_f32"] = mask_f
        consts["_stat_count"] = jnp.sum(mask_f)
        consts["_inv_tsum"] = 1.0 / jnp.sum(jnp.square(consts["target"]))
    else:
        consts["_inv_tsum"] = jnp.float32(1.0)
    if config.mraf:
        # Region code plane for the semi-fused MRAF mix:
        # 1 = signal, 2 = noise, 0 = zero.
        consts["_mraf_code"] = (
            consts["signal_mask"].astype(jnp.float32)
            + 2.0 * consts["noise_mask"].astype(jnp.float32)
        )
        consts["_mraf_k"] = (
            consts["mraf_factor"]
            if config.mraf_factor
            else jnp.float32(1.0)
        )
        # The user-facing target carries NaN in the noise region; the
        # kernels consume the cleaned plane (noise -> 0). For the
        # Leonardo/Kim rule the zero target lands on correction factor 1
        # exactly like the NaN guard, and the stats match
        # calculate_stats' internal nan_to_num.
        consts["target"] = jnp.nan_to_num(consts["target"])
        if config.stat_groups:
            consts["_inv_tsum"] = 1.0 / jnp.sum(
                jnp.square(consts["target"])
            )
    return consts


def _make_fused_step(config: GSConfig):
    """Fully-fused WGS step in CARRY mode: the scan carries the
    rows-transformed field pair in ``state.psi`` (converted at the scan
    boundaries by :meth:`_compiled_run`); each iteration is one
    :meth:`slmsuite_tpu.ops.fft.wgs_carry_step`."""
    from slmsuite_tpu.ops import fft as _fft

    stats_on = bool(config.stat_groups)
    rule = config.method[4:].lower()

    def step(state, consts):
        was_not_fixed = jnp.logical_not(state.fixed_phase)
        apply_update = state.iteration > 0
        scalars = {
            "inv_prev_norm": 1.0 / state.w_norm,
            "apply_update": apply_update.astype(jnp.float32),
            "use_theta": was_not_fixed.astype(jnp.float32),
            "feedback_exponent": consts["feedback_exponent"],
            "feedback_factor": consts["feedback_factor"],
            "inv_fnorm": consts["_inv_fnorm"],
            "inv_tsum": consts["_inv_tsum"],
            "inv_fsum": consts["_inv_fsum"],
        }
        gr, gi = state.psi
        gr, gi, weights, pff_out, sums, maxs = _fft.wgs_carry_step(
            gr, gi,
            consts["amp"],
            state.weights,
            state.phase_ff if config.is_kim else None,
            consts["target"],
            consts.get("_stat_mask_f32"),
            scalars,
            rule=rule,
            kim=config.is_kim,
            stats_on=stats_on,
        )
        psi = (gr, gi)

        w_norm = jnp.where(apply_update, jnp.sqrt(sums[3]), state.w_norm)

        if stats_on:
            count = consts["_stat_count"]
            efficiency = (
                jnp.square(sums[0]) * consts["_inv_tsum"] * consts["_inv_fsum"]
            )
            u_max, u_min = maxs[1], -maxs[3]
            uniformity = 1 - (u_max - u_min) / (u_max + u_min)
            err_mean = sums[1] / count
            err_var = sums[2] / count - jnp.square(err_mean)
            pkpk_err = count * (maxs[0] - (-maxs[2]))
            std_err = count * jnp.sqrt(jnp.maximum(err_var, 0.0))
            stats_rows = [
                jnp.stack([efficiency, uniformity, pkpk_err, std_err]).astype(
                    jnp.float32
                )
            ]
        else:
            efficiency = jnp.float32(jnp.nan)
            stats_rows = []

        # Kim phase-fixing decision. The efficiency trigger compares the
        # CURRENT (pre-constraint) efficiency — already accumulated by
        # the fused kernel — so it fuses exactly like the iteration
        # trigger (the in-kernel phase select always uses the PREVIOUS
        # flag, matching the standard path).
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                fixed = jnp.logical_or(
                    fixed, efficiency > consts["fix_phase_efficiency"]
                )
            streak = jnp.where(
                was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak
            )
            iter_trigger = jnp.logical_and(
                jnp.logical_and(
                    was_not_fixed,
                    state.iteration >= consts["fix_phase_iteration"] - 1,
                ),
                streak >= consts["fix_phase_iteration"],
            )
            fixed = jnp.logical_or(fixed, iter_trigger)
            fixed = jnp.logical_and(fixed, state.iteration > 0)
            phase_ff = pff_out
        else:
            fixed = jnp.zeros((), dtype=bool)
            streak = state.unfixed_streak
            # phase_ff is only consumed by Kim; carry it unchanged (the
            # wrapper repopulates it from the final phase after the run).
            phase_ff = state.phase_ff

        new_state = GSState(
            psi=psi,
            weights=weights,
            phase_ff=phase_ff,
            zero_weights=state.zero_weights,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
            w_norm=w_norm,
        )
        internal = jnp.stack(
            [
                efficiency,
                state.fixed_phase.astype(jnp.float32),
                jnp.float32(0),
                jnp.float32(0),
            ]
        )
        return new_state, jnp.stack(stats_rows + [internal])

    return step


def _make_mraf_fused_step(config: GSConfig):
    """MRAF carry-mode step with one exact scalar norm sync (see
    :meth:`slmsuite_tpu.ops.fft.mraf_carry_step`). The
    scan carries the rows-transformed field pair in ``state.psi``
    (converted at the scan boundaries by :meth:`_compiled_run`) and the
    weight carry is unnormalized with its norm in ``w_norm`` (finalized
    on exit), exactly like the fused WGS step. ``zero_factor`` updates
    ride in the carried ``zero_weights`` plane pair."""
    from slmsuite_tpu.ops import fft as _fft

    stats_on = bool(config.stat_groups)
    rule = config.method[4:].lower()

    def step(state, consts):
        was_not_fixed = jnp.logical_not(state.fixed_phase)
        apply_update = state.iteration > 0
        scalars = {
            "inv_prev_norm": 1.0 / state.w_norm,
            "apply_update": apply_update.astype(jnp.float32),
            "use_theta": was_not_fixed.astype(jnp.float32),
            "feedback_exponent": consts["feedback_exponent"],
            "feedback_factor": consts["feedback_factor"],
            "inv_fnorm": consts["_inv_fnorm"],
            "inv_tsum": consts["_inv_tsum"],
            "inv_fsum": consts["_inv_fsum"],
            "mraf_factor": consts["_mraf_k"],
            "zero_factor": consts.get("zero_factor", jnp.float32(0.0)),
        }
        gr, gi = state.psi
        gr, gi, weights, pff_out, zw_out, sums, maxs = _fft.mraf_carry_step(
            gr, gi,
            consts["amp"],
            state.weights,
            state.phase_ff if config.is_kim else None,
            consts["target"],
            consts.get("_stat_mask_f32"),
            consts["_mraf_code"],
            state.zero_weights if config.zero_factor else None,
            scalars,
            rule=rule,
            kim=config.is_kim,
            stats_on=stats_on,
            zero=config.zero_factor,
        )
        psi = (gr, gi)
        zero_weights = zw_out if config.zero_factor else state.zero_weights

        w_norm = jnp.where(apply_update, jnp.sqrt(sums[3]), state.w_norm)

        if stats_on:
            count = consts["_stat_count"]
            efficiency = (
                jnp.square(sums[0]) * consts["_inv_tsum"] * consts["_inv_fsum"]
            )
            u_max, u_min = maxs[1], -maxs[3]
            uniformity = 1 - (u_max - u_min) / (u_max + u_min)
            err_mean = sums[1] / count
            err_var = sums[2] / count - jnp.square(err_mean)
            pkpk_err = count * (maxs[0] - (-maxs[2]))
            std_err = count * jnp.sqrt(jnp.maximum(err_var, 0.0))
            stats_rows = [
                jnp.stack([efficiency, uniformity, pkpk_err, std_err]).astype(
                    jnp.float32
                )
            ]
        else:
            efficiency = jnp.float32(jnp.nan)
            stats_rows = []

        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                fixed = jnp.logical_or(
                    fixed, efficiency > consts["fix_phase_efficiency"]
                )
            streak = jnp.where(
                was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak
            )
            iter_trigger = jnp.logical_and(
                jnp.logical_and(
                    was_not_fixed,
                    state.iteration >= consts["fix_phase_iteration"] - 1,
                ),
                streak >= consts["fix_phase_iteration"],
            )
            fixed = jnp.logical_or(fixed, iter_trigger)
            fixed = jnp.logical_and(fixed, state.iteration > 0)
            phase_ff = pff_out
        else:
            fixed = jnp.zeros((), dtype=bool)
            streak = state.unfixed_streak
            phase_ff = state.phase_ff

        new_state = GSState(
            psi=psi,
            weights=weights,
            phase_ff=phase_ff,
            zero_weights=zero_weights,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
            w_norm=w_norm,
        )
        internal = jnp.stack(
            [
                efficiency,
                state.fixed_phase.astype(jnp.float32),
                jnp.float32(0),
                jnp.float32(0),
            ]
        )
        return new_state, jnp.stack(stats_rows + [internal])

    return step


def make_gs_step(config: GSConfig):
    """
    Build the pure per-iteration step function
    ``step(state, consts) -> (state, stats (n_groups+1, 4))``.

    The extra trailing stats row always carries
    ``[efficiency(computational), fixed_phase, 0, 0]`` for internal use
    (Kim efficiency trigger and flag history).
    """
    if _fused_active(config):
        return _make_fused_step(config)
    if _mraf_fused_active(config):
        return _make_mraf_fused_step(config)

    needs_spot_feedback = (
        config.feedback == "computational_spot"
        or "computational_spot" in config.stat_groups
    )
    needs_sim_measure = (
        config.feedback == "experimental_spot_sim"
        or "experimental_spot" in config.stat_groups
    )

    # Fully-fused phase-in/phase-out loop: valid when the computational
    # farfield equals the SLM shape with no propagation kernel — then
    # nearfield == amp * e^{i psi} exactly and no complex array needs to
    # exist in HBM on either side of the constraint.
    full_fuse = (
        config.scrambled
        and tuple(config.shape) == tuple(config.slm_shape)
        and not config.has_kernel
    )

    if config.scrambled:
        # Transpose-free hot loop: the farfield lives in the four-step
        # (k1, k2) layout; consts/state were permuted by scramble_consts/
        # _scramble_state. Elementwise constraint + sum-stats are
        # order-independent.
        from slmsuite_tpu.ops import fft as _fft

        def _forward_polar(nearfield):
            return _fft.fft2_scrambled_polar(nearfield.real, nearfield.imag)

        def _backward(farfield):
            re, im = _fft.ifft2_scrambled_pair(farfield.real, farfield.imag)
            return (re + 1j * im).astype(jnp.complex64)

    else:
        def _forward_polar(nearfield):
            farfield = nearfield_to_farfield(nearfield)
            return jnp.abs(farfield), jnp.arctan2(farfield.imag, farfield.real)

        _backward = farfield_to_nearfield

    def step(state, consts):
        # --- (A) Nearfield -> farfield. ---
        kernel = consts.get("kernel") if config.has_kernel else None
        if full_fuse:
            from slmsuite_tpu.ops import fft as _fft

            amp_ff, theta = _fft.fft2_scrambled_polar_from_phase(
                state.psi, consts["amp"]
            )
        else:
            nearfield = build_folded_nearfield(
                state.psi, consts["amp"], config.shape, kernel
            )
            amp_ff, theta = _forward_polar(nearfield)

        spot_feedback = (
            _spot_feedback_amp(jnp.square(amp_ff), consts)
            if needs_spot_feedback
            else None
        )

        # --- (B.1) Simulated-camera measure (device-resident closed
        # loop): psi is the natural folded nearfield phase in every
        # standard-step layout (the scrambled promotion permutes only
        # farfield-resident planes), so the camera model runs on it
        # directly.
        sim_measured = (
            sim_measure_spots(
                state.psi, consts,
                bitres=config.sim_bitres,
                cam_sat=config.sim_cam_sat,
                truncates=config.sim_truncates,
                shape_padded=config.sim_shape_padded,
            )
            if needs_sim_measure
            else None
        )

        # --- (B.2) Stats. ---
        stats_rows = [
            _compute_group_stats(
                group, config, consts, amp_ff, spot_feedback, sim_measured
            )
            for group in config.stat_groups
        ]

        # --- (B.3) Weights + Kim decision. ---
        weights = state.weights
        if config.is_wgs:
            if config.feedback == "computational":
                updated = update_weights_generic(
                    weights,
                    amp_ff,
                    consts["target"],
                    config.method,
                    consts["feedback_exponent"],
                    consts["feedback_factor"],
                    nan_checks=config.nan_checks,
                )
            elif config.feedback == "computational_spot":
                # Weight feedback integrates around the *rounded* spot pixels
                # (ref `_spots.py:1598-1624`); stats use the raw positions.
                weight_feedback = jnp.sqrt(
                    jnp.sum(
                        jnp.take(
                            jnp.square(amp_ff).ravel(),
                            consts["spot_weight_flat_idx"],
                            axis=0,
                        ),
                        axis=-1,
                    )
                )
                spot_weights = weights.ravel()[consts["spot_center_idx"]]
                new_spot_weights = update_weights_generic(
                    spot_weights,
                    weight_feedback,
                    consts["spot_amp"],
                    config.method,
                    consts["feedback_exponent"],
                    consts["feedback_factor"],
                    nan_checks=config.nan_checks,
                )
                updated = (
                    jnp.zeros_like(weights)
                    .ravel()
                    .at[consts["spot_center_idx"]]
                    .set(new_spot_weights)
                    .reshape(weights.shape)
                )
            elif config.feedback == "experimental_spot_sim":
                # Device-resident closed loop: weight feedback is the
                # sqrt of the camera-measured spot-window powers (host
                # twin: _AbstractSpotHologram._update_weights for
                # 'experimental_spot' on the simulated fast path).
                spot_weights = weights.ravel()[consts["spot_center_idx"]]
                new_spot_weights = update_weights_generic(
                    spot_weights,
                    jnp.sqrt(sim_measured[0]),
                    consts["spot_amp"],
                    config.method,
                    consts["feedback_exponent"],
                    consts["feedback_factor"],
                    nan_checks=config.nan_checks,
                )
                updated = (
                    jnp.zeros_like(weights)
                    .ravel()
                    .at[consts["spot_center_idx"]]
                    .set(new_spot_weights)
                    .reshape(weights.shape)
                )
            else:
                # External/experimental feedback: weights updated host-side
                # between stepwise invocations.
                updated = weights
            weights = jnp.where(state.iteration > 0, updated, weights)

        # Kim phase fixing.
        was_not_fixed = jnp.logical_not(state.fixed_phase)
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                # Reference semantics: trigger on the last stat group's
                # efficiency (`_hologram.py:1561-1570`); the wrapper
                # guarantees stat_groups is non-empty in this mode.
                efficiency = stats_rows[-1][0]
                fixed = jnp.logical_or(
                    fixed, efficiency > consts["fix_phase_efficiency"]
                )
            streak = jnp.where(was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak)
            iter_trigger = jnp.logical_and(
                jnp.logical_and(
                    was_not_fixed,
                    state.iteration >= consts["fix_phase_iteration"] - 1,
                ),
                streak >= consts["fix_phase_iteration"],
            )
            fixed = jnp.logical_or(fixed, iter_trigger)
            # Applies only once WGS weighting starts (iter > 0), like the ref.
            fixed = jnp.logical_and(fixed, state.iteration > 0)
            phase_ff = jnp.where(was_not_fixed, theta, state.phase_ff)
        else:
            fixed = jnp.zeros((), dtype=bool)
            streak = state.unfixed_streak
            phase_ff = theta

        # The constraint phase: current angle while unfixed (including the
        # iteration that fixes), stored phase once fixed (ref :1589-1605).
        if full_fuse and not config.mraf:
            # Backward half from the real constraint planes: the complex
            # farfield is never materialized.
            from slmsuite_tpu.ops import fft as _fft

            psi = _fft.wexp_ifft2_scrambled_phase(weights, phase_ff)
            new_state = GSState(
                psi=psi,
                weights=weights,
                phase_ff=phase_ff,
                zero_weights=state.zero_weights,
                fixed_phase=fixed,
                unfixed_streak=streak,
                iteration=state.iteration + 1,
                w_norm=state.w_norm,
            )
            internal = jnp.stack(
                [
                    stats_rows[-1][0] if stats_rows else jnp.float32(jnp.nan),
                    state.fixed_phase.astype(jnp.float32),
                    jnp.float32(0),
                    jnp.float32(0),
                ]
            )
            return new_state, jnp.stack(stats_rows + [internal])

        constrained = weights * jnp.exp(1j * phase_ff)
        if config.mraf:
            # Reconstruct the free-evolution farfield from polar form
            # (the complex array was never materialized).
            farfield = (amp_ff * jnp.exp(1j * theta)).astype(jnp.complex64)
            new_farfield = jnp.where(consts["signal_mask"], constrained, farfield)
            if config.mraf_factor:
                new_farfield = jnp.where(
                    consts["noise_mask"],
                    consts["mraf_factor"] * new_farfield,
                    new_farfield,
                )
            if config.zero_factor:
                fz = jnp.where(consts["zero_mask"], farfield, 0.0)
                zw_complex = (
                    state.zero_weights[0] + 1j * state.zero_weights[1]
                ).astype(jnp.complex64)
                zw_complex = zw_complex - consts["zero_factor"] * jnp.abs(fz) * fz
                zero_weights = jnp.stack([zw_complex.real, zw_complex.imag])
                new_farfield = jnp.where(consts["zero_mask"], zw_complex, new_farfield)
            else:
                zero_weights = state.zero_weights
                new_farfield = jnp.where(consts["zero_mask"], 0.0, new_farfield)
        else:
            new_farfield = constrained
            zero_weights = state.zero_weights

        # --- (C) Farfield -> nearfield. ---
        if full_fuse:
            from slmsuite_tpu.ops import fft as _fft

            psi = _fft.ifft2_scrambled_phase(
                new_farfield.real, new_farfield.imag
            )
        else:
            new_nearfield = _backward(new_farfield)
            psi = extract_folded_phase(new_nearfield, config.slm_shape, kernel)

        new_state = GSState(
            psi=psi,
            weights=weights,
            phase_ff=phase_ff,
            zero_weights=zero_weights,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
            w_norm=state.w_norm,
        )

        # Internal row: current computational efficiency + flag history.
        internal = jnp.stack(
            [
                stats_rows[-1][0] if stats_rows else jnp.float32(jnp.nan),
                state.fixed_phase.astype(jnp.float32),
                jnp.float32(0),
                jnp.float32(0),
            ]
        )
        stats = jnp.stack(stats_rows + [internal])
        return new_state, stats

    return step


#: When True, engine runs are instrumented with ``jax.experimental.checkify``
#: float checks (nan / divide-by-zero) — the analog of the reference's
#: numeric sanitization. Enabled for tests via SLMSUITE_TPU_CHECKIFY=1.
_NUMERIC_CHECKS = False


def set_numeric_checks(enable):
    """Toggle checkify instrumentation of the scanned engine (flushes the
    compile cache so the change applies to subsequent runs)."""
    global _NUMERIC_CHECKS
    _NUMERIC_CHECKS = bool(enable)
    _compiled_run.cache_clear()


@functools.lru_cache(maxsize=64)
def _compiled_run(config: GSConfig, n_iterations: int):
    """Compile ``scan(step, state, length=n)`` with donated state."""
    step = make_gs_step(config)
    fused = _fused_active(config) or _mraf_fused_active(config)
    carry_mode = _fused_active(config) or _mraf_fused_active(config)

    def run(state, consts):
        if fused:
            consts = _augment_fused_consts(config, consts)
        if carry_mode:
            # The fused scan carries the rows-transformed field pair in
            # ``psi`` and the Kim phase store as a unit-phasor pair (no
            # atan2/sincos inside the loop); convert at the boundaries.
            # Entry handles unbounded psi (warm starts).
            from slmsuite_tpu.ops import fft as _fft

            state = state._replace(
                psi=_fft.wgs_carry_entry(state.psi, consts["amp"])
            )
            if config.is_kim:
                state = state._replace(
                    phase_ff=_fft.wgs_phasor_entry(state.phase_ff)
                )

        def body(carry, _):
            return step(carry, consts)

        final, stats = jax.lax.scan(body, state, None, length=n_iterations)
        if carry_mode:
            from slmsuite_tpu.ops import fft as _fft

            final = final._replace(psi=_fft.wgs_carry_exit(*final.psi))
            if config.is_kim:
                final = final._replace(
                    phase_ff=_fft.wgs_phasor_exit(*final.phase_ff)
                )
        return final, stats

    if _NUMERIC_CHECKS:
        from jax.experimental import checkify

        checked = jax.jit(checkify.checkify(run, errors=checkify.float_checks))

        def run_checked(state, consts):
            error, out = checked(state, consts)
            error.throw()
            return out

        return _with_kernel_precision(run_checked, config)

    return _with_kernel_precision(
        jax.jit(run, donate_argnums=(0,)), config
    )


def _with_kernel_precision(jitted, config: GSConfig):
    """Pin ``config.kernel_precision`` around every invocation of a
    compiled run: the four-step tier reads its precision global at TRACE
    time (the first call), so the pin guarantees the cached executable
    carries the config's precision whatever the global is then. The
    set/restore on warm calls is nanoseconds."""
    if config.kernel_precision is None:
        return jitted
    from slmsuite_tpu.ops import fft as _fft

    def run_pinned(state, consts):
        prior = _fft._PRECISION
        _fft.set_fft_precision(config.kernel_precision)
        try:
            return jitted(state, consts)
        finally:
            _fft._PRECISION = prior

    return run_pinned


#: Scrambled (transpose-free) loop mode. "auto" takes the per-platform
#: default of :data:`_SCRAMBLED_DEFAULT` (off where not listed: on the
#: CPU the einsum scrambled form costs +19% bytes under XLA layout
#: assignment, 3463 vs 2904 MB per 2048^2 WGS step). The loop also
#: needs the four-step ("matmul") FFT tier. Forcible via
#: set_scrambled_mode(True/False).
_SCRAMBLED_MODE = "auto"

#: Platforms on which "auto" promotes to the scrambled loop (when the
#: four-step tier is selected). On an H100 the scrambled loop beat the
#: natural one within that tier: 0.94 vs 1.22 ms per 2048^2 WGS-Kim
#: iteration at HIGHEST, 0.84 vs 1.10 ms at TF32.
_SCRAMBLED_DEFAULT = {"gpu": True}


def set_scrambled_mode(enable):
    """Force the scrambled loop on/off, or ``"auto"`` (platform default)."""
    global _SCRAMBLED_MODE
    _SCRAMBLED_MODE = enable


def _can_scramble(config: GSConfig):
    """Scrambled loop: enabled + matmul FFT + four-step-splittable shape
    (all powers of two, plus balanced composites like 1536/1920/3072)."""
    from slmsuite_tpu.ops import fft as _fft
    from slmsuite_tpu.ops.platform import accelerator

    if _SCRAMBLED_MODE == "auto":
        enabled = _SCRAMBLED_DEFAULT.get(accelerator(), False)
    else:
        enabled = bool(_SCRAMBLED_MODE)
    return (
        enabled
        and not config.scrambled
        and _fft.get_fft_backend() == "matmul"
        and _fft._matmul_shape(tuple(config.shape))
    )


@functools.lru_cache(maxsize=16)
def _scramble_maps(shape):
    """(perm_h, perm_w, flat position map natural->scrambled) for ``shape``."""
    from slmsuite_tpu.ops import fft as _fft

    perm_h, perm_w = _fft.scramble_permutation_2d(shape)
    inv_h = np.empty_like(perm_h)
    inv_w = np.empty_like(perm_w)
    inv_h[perm_h] = np.arange(shape[0])
    inv_w[perm_w] = np.arange(shape[1])
    flat_map = (inv_h[:, None] * shape[1] + inv_w[None, :]).astype(np.int64)
    return perm_h, perm_w, flat_map


_FARFIELD_CONSTS = ("target", "stat_mask", "signal_mask", "noise_mask", "zero_mask")
_SPOT_IDX_CONSTS = ("spot_flat_idx", "spot_weight_flat_idx", "spot_center_idx")


def scramble_consts(consts, shape):
    """Permute farfield-resident consts into the scrambled layout."""
    perm_h, perm_w, flat_map = _scramble_maps(tuple(shape))
    out = dict(consts)
    for key in _FARFIELD_CONSTS:
        if key in out:
            out[key] = jnp.take(
                jnp.take(out[key], jnp.asarray(perm_h), axis=0),
                jnp.asarray(perm_w), axis=1,
            )
    for key in _SPOT_IDX_CONSTS:
        if key in out:
            out[key] = jnp.asarray(
                flat_map.ravel()[np.asarray(out[key])], dtype=jnp.int32
            )
    return out


def _permute_state(state: GSState, shape, unscramble=False):
    perm_h, perm_w, _ = _scramble_maps(tuple(shape))
    if unscramble:
        inv_h = np.empty_like(perm_h); inv_h[perm_h] = np.arange(shape[0])
        inv_w = np.empty_like(perm_w); inv_w[perm_w] = np.arange(shape[1])
        perm_h, perm_w = inv_h, inv_w
    ph = jnp.asarray(perm_h)
    pw = jnp.asarray(perm_w)

    def permute2d(x, axis0):
        return jnp.take(jnp.take(x, ph, axis=axis0), pw, axis=axis0 + 1)

    return state._replace(
        weights=permute2d(state.weights, 0),
        phase_ff=permute2d(state.phase_ff, 0),
        zero_weights=(
            permute2d(state.zero_weights, 1)
            if state.zero_weights.size
            else state.zero_weights
        ),
    )


def run_gs(config: GSConfig, state: GSState, consts: dict, n_iterations: int):
    """
    Run ``n_iterations`` of GS/WGS on device.

    When the matmul FFT is active and the farfield is power-of-two, the
    loop transparently runs in the four-step scrambled layout (no
    transposes inside the scan; see :mod:`slmsuite_tpu.ops.fft`) —
    state/consts are permuted on entry and the state is restored to
    natural order on exit, so callers never see the scrambled basis.

    Returns ``(state, stats)`` where stats has shape
    ``(n_iterations, len(stat_groups) + 1, 4)``.
    """
    if _can_scramble(config):
        sconfig = dataclasses.replace(config, scrambled=True)
        state = _permute_state(state, config.shape)
        consts = scramble_consts(consts, config.shape)
        state = _provision_fused(sconfig, state)
        state, stats = _compiled_run(sconfig, int(n_iterations))(state, consts)
        state = _permute_state(state, config.shape, unscramble=True)
        return _finalize_fused(sconfig, state), stats
    return _compiled_run(config, int(n_iterations))(state, consts)


def run_gs_scheduled(config: GSConfig, state: GSState, consts: dict,
                     n_iterations: int, n_refine: int = 16,
                     coarse: str = "DEFAULT"):
    """
    Run ``n_iterations`` of GS/WGS with a PRECISION SCHEDULE: the first
    ``n_iterations - n_refine`` iterations use the ``coarse`` four-step
    matmul precision (``"DEFAULT"``: TF32 stage matmuls on a GPU), and
    the final ``n_refine`` iterations run at ``"HIGHEST"`` to polish the
    converged phase/weights to full f32 quality.

    Why this is sound: WGS is a fixed-point iteration — each step
    replaces the nearfield amplitude and rebuilds the weights from the
    CURRENT farfield, so transform error in early iterations perturbs
    the trajectory but not the fixed point; the HIGHEST refine
    iterations re-converge the phase at full accuracy. The trajectory
    plumbing is pinned by ``TestScheduledEngine``. Analog of the
    reference's own accuracy/speed guidance (reference
    ``_hologram.py:378-384``, shape/precision trades).

    The precision only reaches the ``"matmul"`` FFT tier. With the
    ``"xla"`` tier (``jnp.fft``, cuFFT on a GPU) or on the CPU the
    schedule is a no-op: two plain scans, numerically identical to
    :func:`run_gs`, so the API is portable.

    Returns ``(state, stats)`` with stats shape
    ``(n_iterations, len(stat_groups) + 1, 4)`` like :func:`run_gs`.
    """
    n_iterations = int(n_iterations)
    n_refine = max(0, min(int(n_refine), n_iterations))
    n_coarse = n_iterations - n_refine
    if n_coarse == 0 or coarse == "HIGHEST":
        return run_gs(config, state, consts, n_iterations)

    promoted = _can_scramble(config)
    if promoted:
        run_config = dataclasses.replace(config, scrambled=True)
        state = _permute_state(state, config.shape)
        consts = scramble_consts(consts, config.shape)
        state = _provision_fused(run_config, state)
    else:
        run_config = config

    c_coarse = dataclasses.replace(run_config, kernel_precision=coarse)
    state, stats_coarse = _compiled_run(c_coarse, n_coarse)(state, consts)
    parts = [stats_coarse]
    if n_refine:
        # Pin the refine phase to HIGHEST explicitly (unless the caller
        # set a precision on the config): with kernel_precision=None it
        # would inherit the ops.fft module GLOBAL, so a user-level
        # set_fft_precision("DEFAULT") would silently degrade the
        # "HIGHEST refine" this function documents.
        c_fine = (
            run_config
            if run_config.kernel_precision is not None
            else dataclasses.replace(run_config, kernel_precision="HIGHEST")
        )
        state, stats_fine = _compiled_run(c_fine, n_refine)(
            state, consts
        )
        parts.append(stats_fine)

    if promoted:
        state = _permute_state(state, config.shape, unscramble=True)
        state = _finalize_fused(run_config, state)
    return state, jnp.concatenate(parts, axis=0)


def _provision_fused(config: GSConfig, state: GSState):
    """Give the fused loop its deferred-normalization scalar."""
    if (_fused_active(config) or _mraf_fused_active(config)) and state.w_norm is None:
        state = state._replace(w_norm=jnp.ones((), jnp.float32))
    return state


def _finalize_fused(config: GSConfig, state: GSState):
    """Renormalize the deferred-norm weights once on exit (the in-loop
    trajectory is weight-scale-invariant; see ``_make_fused_step``)."""
    if (
        _fused_active(config) or _mraf_fused_active(config)
    ) and state.w_norm is not None:
        state = state._replace(
            weights=state.weights / state.w_norm,
            w_norm=jnp.ones((), jnp.float32),
        )
    return state


@functools.lru_cache(maxsize=16)
def _compiled_batch_run(config: GSConfig, n_iterations: int, scramble: bool):
    """Compile ``vmap(scan(step))`` over a leading batch axis — K
    *independent* holograms advance in lockstep through one program.
    Scramble promotion, fused provisioning, and carry entry/exit happen
    per instance inside the vmap (all pure jnp transforms)."""
    base_config = config
    sconfig = (
        dataclasses.replace(config, scrambled=True) if scramble else config
    )
    step = make_gs_step(sconfig)
    fused = _fused_active(sconfig) or _mraf_fused_active(sconfig)

    def single(state, consts):
        if scramble:
            state = _permute_state(state, base_config.shape)
            consts = scramble_consts(consts, base_config.shape)
        state = _provision_fused(sconfig, state)
        if fused:
            consts = _augment_fused_consts(sconfig, consts)
            from slmsuite_tpu.ops import fft as _fft

            state = state._replace(
                psi=_fft.wgs_carry_entry(state.psi, consts["amp"])
            )
            if sconfig.is_kim:
                state = state._replace(
                    phase_ff=_fft.wgs_phasor_entry(state.phase_ff)
                )

        def body(carry, _):
            return step(carry, consts)

        final, stats = jax.lax.scan(body, state, None, length=n_iterations)

        if fused:
            from slmsuite_tpu.ops import fft as _fft

            final = final._replace(psi=_fft.wgs_carry_exit(*final.psi))
            if sconfig.is_kim:
                final = final._replace(
                    phase_ff=_fft.wgs_phasor_exit(*final.phase_ff)
                )
        if scramble:
            final = _permute_state(final, base_config.shape, unscramble=True)
        final = _finalize_fused(sconfig, final)
        return final, stats

    return jax.jit(jax.vmap(single), donate_argnums=(0,))


def run_gs_batch(config, states, consts, n_iterations, mesh=None,
                 axis_name="data"):
    """
    Run ``n_iterations`` of GS/WGS on a BATCH of independent holograms
    (no coupling — contrast :mod:`slmsuite_tpu.parallel.multiplane`,
    whose planes share one phase). ``states``/``consts`` are the
    per-instance pytrees stacked on a leading axis of size B.

    With ``mesh``, the batch axis shards over ``axis_name`` — B
    holograms optimize on B/n_devices chips each with NO collectives
    (embarrassingly parallel; no traffic between the cards). B must
    divide evenly.

    Returns ``(states, stats)`` with stats shape
    ``(B, n_iterations, len(stat_groups) + 1, 4)``.
    """
    import jax.tree_util as jtu

    scramble = _can_scramble(config)
    # Pin the config's precision like the single-instance runs: the
    # batch jit traces the same four-step matmuls and would otherwise
    # silently ignore config.kernel_precision.
    run = _with_kernel_precision(
        _compiled_batch_run(config, int(n_iterations), scramble), config
    )

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        n_devices = int(np.prod(list(mesh.shape.values())))
        batch = jtu.tree_leaves(states)[0].shape[0]
        if batch % n_devices:
            raise ValueError(
                f"Batch size {batch} must divide the mesh "
                f"({n_devices} devices) for sharded batch optimization."
            )
        sharding = NamedSharding(mesh, PartitionSpec(axis_name))

        def shard(x):
            return jax.device_put(x, sharding)

        states = jtu.tree_map(shard, states)
        consts = jtu.tree_map(shard, consts)
    return run(states, consts)


def run_gs_chunked(config, state, consts, n_iterations, chunk=None,
                   on_chunk=None, n_refine=None, coarse="DEFAULT"):
    """
    Like :meth:`run_gs` but split into ``chunk``-sized scans with
    ``on_chunk(n)`` called between them (progress reporting). The
    scrambled promotion happens ONCE across all chunks — per-chunk
    permutes would otherwise cost ~100 MB of HBM traffic each.

    ``n_refine``/``coarse`` apply the :func:`run_gs_scheduled` precision
    schedule across the chunked run: every iteration before the final
    ``n_refine`` uses the ``coarse`` four-step matmul precision,
    and the last ``n_refine`` polish at the config's own precision
    (chunks are split at the boundary). ``n_refine=None`` disables.

    Returns ``(state, [stats_chunk, ...])``.
    """
    n_iterations = int(n_iterations)
    chunk = n_iterations if chunk is None else max(1, int(chunk))
    promoted = _can_scramble(config)
    if promoted:
        run_config = dataclasses.replace(config, scrambled=True)
        state = _permute_state(state, config.shape)
        consts = scramble_consts(consts, config.shape)
        state = _provision_fused(run_config, state)
    else:
        run_config = config

    n_coarse = 0
    coarse_config = run_config
    if n_refine is not None and coarse != "HIGHEST":
        n_coarse = n_iterations - max(0, min(int(n_refine), n_iterations))
        coarse_config = dataclasses.replace(
            run_config, kernel_precision=coarse
        )
        if run_config.kernel_precision is None:
            # Pin the refine chunks like run_gs_scheduled: inheriting
            # the module global would let a user-level DEFAULT override
            # silently degrade the documented full-precision refine.
            run_config = dataclasses.replace(
                run_config, kernel_precision="HIGHEST"
            )

    all_stats = []
    done = 0
    while done < n_iterations:
        n = min(chunk, n_iterations - done)
        if done < n_coarse:
            n = min(n, n_coarse - done)  # Split at the schedule boundary.
            cfg = coarse_config
        else:
            cfg = run_config
        state, stats = _compiled_run(cfg, n)(state, consts)
        all_stats.append(stats)
        done += n
        if on_chunk is not None:
            on_chunk(n)

    if promoted:
        state = _permute_state(state, config.shape, unscramble=True)
        state = _finalize_fused(run_config, state)
    return state, all_stats


def init_gs_state(config: GSConfig, psi, weights, phase_ff=None):
    """Fresh scan state from initial folded phase and weights."""
    return GSState(
        psi=jnp.asarray(psi, dtype=jnp.float32),
        weights=jnp.asarray(weights, dtype=jnp.float32),
        phase_ff=(
            jnp.zeros(config.shape, dtype=jnp.float32)
            if phase_ff is None
            else jnp.asarray(phase_ff, dtype=jnp.float32)
        ),
        zero_weights=(
            jnp.zeros((2,) + tuple(config.shape), dtype=jnp.float32)
            if config.zero_factor
            else jnp.zeros((2, 0, 0), dtype=jnp.float32)
        ),
        fixed_phase=jnp.zeros((), dtype=bool),
        unfixed_streak=jnp.zeros((), dtype=jnp.int32),
        iteration=jnp.zeros((), dtype=jnp.int32),
    )


def spot_gather_indices(spot_ij, window, shape):
    """
    Precompute the (N, D*D) flat gather map for spot-integration feedback
    and the (N,) spot-center flat indices.

    Parameters
    ----------
    spot_ij : numpy.ndarray
        (2, N) integer spot pixel coordinates (x; y) in the farfield plane.
    window : int
        Integration width D (centered).
    shape : (int, int)
        Farfield plane shape.
    """
    spot_ij = np.asarray(spot_ij, dtype=int)
    edge = np.floor(np.arange(window) - ((window - 1) / 2)).astype(int)
    ex, ey = np.meshgrid(edge, edge)

    ix = np.clip(spot_ij[0][:, None] + ex.ravel()[None, :], 0, shape[1] - 1)
    iy = np.clip(spot_ij[1][:, None] + ey.ravel()[None, :], 0, shape[0] - 1)

    flat = (iy * shape[1] + ix).astype(np.int32)
    center = (spot_ij[1] * shape[1] + spot_ij[0]).astype(np.int32)
    return flat, center
