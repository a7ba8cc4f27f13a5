r"""
Batched / multiplane GS over a device mesh.

The multiplane structure (reference ``_multiplane.py:255-279``) is the
natural data-parallel axis of holography: ``B`` child holograms share one
nearfield phase; each plane runs its own farfield constraint; the
complex nearfields (with per-plane propagation kernels removed) are
weight-summed back into the shared phase. On a mesh, planes shard over
the ``"data"`` axis and the nearfield sum is a ``psum`` over NVLink — the
one real collective in the hot loop.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from slmsuite_tpu.ops.engine import GSConfig
from slmsuite_tpu.ops.propagation import (
    build_folded_nearfield,
    farfield_to_nearfield,
    nearfield_to_farfield,
    pad_window_slices,
)
from slmsuite_tpu.ops.stats import calculate_stats
from slmsuite_tpu.ops.weights import update_weights_generic


@dataclasses.dataclass(frozen=True)
class BatchedGSConfig:
    """Static configuration for a batched multiplane GS step."""

    method: str
    shape: tuple
    slm_shape: tuple
    n_planes: int
    has_kernel: bool = True
    stats: bool = True
    scrambled: bool = False  # farfield in four-step (k1,k2) layout
    kim_efficiency_trigger: bool = False
    #: MRAF: per-plane region codes (``consts["mcodes"]``: 1 = signal,
    #: 2 = noise, 0 = zero) select the constraint mix. Masks are
    #: plane-local, so no extra collective is needed; the weight norm is
    #: per plane exactly like the host meta loop's children.
    mraf: bool = False
    mraf_factor: bool = False  # apply the noise-region retention factor

    @property
    def is_wgs(self):
        return self.method.startswith("WGS")

    @property
    def is_kim(self):
        return "Kim" in self.method


def make_batched_gs_step(config: BatchedGSConfig, axis_name=None):
    """
    Build the per-iteration step for ``B`` planes sharing one phase:
    ``step(psi, weights(B,H,W), consts) -> (psi', weights', stats(B,4))``.

    When ``axis_name`` is given the step is written per-shard: the plane
    axis holds only the local planes and the nearfield accumulation is
    ``psum`` over ``axis_name``.
    """
    y0, y1, x0, x1 = pad_window_slices(config.shape, config.slm_shape)

    if config.scrambled:
        from slmsuite_tpu.ops import fft as _fft

    # Non-MRAF scrambled planes build the constrained farfield from its
    # real planes (plane_backward_wexp); MRAF's region mixing needs the
    # explicit complex farfield.
    use_wexp = config.scrambled and not config.mraf

    def plane_forward(psi, kernel, amp, amp_canvas):
        """Returns (amp_ff, theta). In the scrambled mode the forward
        starts from the padded phase canvas, without a complex
        nearfield."""
        if config.scrambled:
            total = psi + kernel if config.has_kernel else psi
            phase = jax.lax.dynamic_update_slice(
                jnp.zeros(config.shape, jnp.float32), total, (y0, x0)
            )
            return _fft.fft2_scrambled_polar_from_phase(phase, amp_canvas)
        nearfield = build_folded_nearfield(
            psi, amp, config.shape, kernel if config.has_kernel else None
        )
        farfield = nearfield_to_farfield(nearfield)
        return jnp.abs(farfield), jnp.arctan2(farfield.imag, farfield.real)

    def plane_constrain(amp_ff, theta, weights, target, mcode, phase_ff,
                        fixed, streak, consts, iteration):
        fixed_in = fixed  # Flag history records the pre-decision state.
        if config.stats or config.kim_efficiency_trigger:
            stats = calculate_stats(
                amp_ff, target, mask=target != 0, efficiency_compensation=False
            )
        else:
            stats = jnp.zeros((4,), jnp.float32)

        if config.is_wgs:
            updated = update_weights_generic(
                weights, amp_ff, target, config.method,
                consts["feedback_exponent"], consts["feedback_factor"],
            )
            weights = jnp.where(iteration > 0, updated, weights)

        # Kim phase fixing, per plane (same semantics as ops.engine).
        if config.is_kim:
            was_not_fixed = jnp.logical_not(fixed)
            if config.kim_efficiency_trigger:
                fixed = jnp.logical_or(
                    fixed, stats[0] > consts["fix_phase_efficiency"]
                )
            streak = jnp.where(was_not_fixed, streak + 1, streak)
            iter_trigger = jnp.logical_and(
                jnp.logical_and(
                    was_not_fixed,
                    iteration >= consts["fix_phase_iteration"] - 1,
                ),
                streak >= consts["fix_phase_iteration"],
            )
            fixed = jnp.logical_and(
                jnp.logical_or(fixed, iter_trigger), iteration > 0
            )
            phase_ff = jnp.where(was_not_fixed, theta, phase_ff)
        else:
            phase_ff = theta

        # Column 4 carries the fixed-phase flag history next to the stats.
        stats = jnp.concatenate([stats, fixed_in.astype(jnp.float32)[None]])
        if use_wexp:
            # The constrained farfield is synthesized INSIDE the fused
            # inverse kernel (plane_backward_wexp) from (weights,
            # phase_ff) — never materialize it here.
            constrained = jnp.zeros((), jnp.complex64)
            return constrained, weights, phase_ff, fixed, streak, stats
        constrained = weights * jnp.exp(1j * phase_ff)
        if config.mraf:
            # Mixed-region constraint (engine parity, ref
            # `_hologram.py:1606-1653`): signal keeps the weighted
            # constraint, noise evolves freely (x retention factor),
            # zero regions are cleared. Non-MRAF planes in a mixed batch
            # are unaffected: their weights are identically zero outside
            # the signal region.
            farfield = (amp_ff * jnp.exp(1j * theta)).astype(jnp.complex64)
            new_ff = jnp.where(mcode == 1, constrained, farfield)
            if config.mraf_factor:
                new_ff = jnp.where(
                    mcode == 2, consts["mraf_factor"] * new_ff, new_ff
                )
            constrained = jnp.where(mcode == 0, 0.0, new_ff)
        return (
            constrained,
            weights, phase_ff, fixed, streak, stats,
        )

    def _window_contribution(nearfield, kernel, plane_weight):
        window = jax.lax.dynamic_slice(
            nearfield, (y0, x0), tuple(config.slm_shape)
        )
        if config.has_kernel:
            window = window * jnp.exp(-1j * kernel)
        return plane_weight * window

    def plane_backward(constrained, kernel, plane_weight):
        if config.scrambled:
            re, im = _fft.ifft2_scrambled_pair(constrained.real, constrained.imag)
            nearfield = (re + 1j * im).astype(jnp.complex64)
        else:
            nearfield = farfield_to_nearfield(constrained)
        return _window_contribution(nearfield, kernel, plane_weight)

    def plane_backward_wexp(weights, phase_ff, kernel, plane_weight):
        """Fused backward: the constrained farfield w * e^{i phase} is
        synthesized inside the inverse cols kernel and never crosses
        HBM (non-MRAF scrambled path only — MRAF's region mixing needs
        the explicit complex farfield)."""
        re, im = _fft.wexp_ifft2_scrambled(weights, phase_ff)
        nearfield = (re + 1j * im).astype(jnp.complex64)
        return _window_contribution(nearfield, kernel, plane_weight)

    def step(carry, consts):
        psi, weights, phase_ff, fixed, streak = carry
        kernels = consts["kernels"]          # (B_local, Hs, Ws)
        targets = consts["targets"]          # (B_local, H, W)
        plane_weights = consts["plane_weights"]  # (B_local,)
        iteration = consts["iteration"]
        mcodes = (
            consts["mcodes"] if config.mraf
            else jnp.zeros((targets.shape[0], 1, 1), jnp.uint8)
        )

        if config.scrambled:
            # Padded source-amplitude plane, shared by every plane and
            # iteration (XLA CSEs it across the vmap).
            amp_canvas = jax.lax.dynamic_update_slice(
                jnp.zeros(config.shape, jnp.float32),
                jnp.broadcast_to(
                    jnp.asarray(consts["amp"], jnp.float32),
                    tuple(config.slm_shape),
                ),
                (y0, x0),
            )
        else:
            amp_canvas = None
        amps_ff, thetas = jax.vmap(
            lambda k: plane_forward(psi, k, consts["amp"], amp_canvas)
        )(kernels)
        constrained, weights, phase_ff, fixed, streak, stats = jax.vmap(
            lambda a, th, w, t, mc, pff, fx, st: plane_constrain(
                a, th, w, t, mc, pff, fx, st, consts, iteration
            )
        )(amps_ff, thetas, weights, targets, mcodes, phase_ff, fixed, streak)

        if use_wexp:
            contributions = jax.vmap(plane_backward_wexp)(
                weights, phase_ff, kernels, plane_weights
            )
        else:
            contributions = jax.vmap(plane_backward)(
                constrained, kernels, plane_weights
            )
        combined = jnp.sum(contributions, axis=0)
        if axis_name is not None:
            combined = jax.lax.psum(combined, axis_name)

        psi_new = jnp.arctan2(combined.imag, combined.real)
        return (psi_new, weights, phase_ff, fixed, streak), stats

    return step


def _batched_can_scramble(config):
    """Gate for the batched scrambled promotion: the ENGINE's gate
    (shared, so a forced ``set_scrambled_mode(True)`` behaves the same
    here as on single-plane runs — including on CPU) plus the
    batched-path size floor (sub-128 planes underfill the stage dots
    and the permute overhead dominates)."""
    from slmsuite_tpu.ops import engine as _engine

    H, W = config.shape
    return (
        _engine._can_scramble(
            _engine.GSConfig(
                method=config.method, shape=tuple(config.shape),
                slm_shape=tuple(config.slm_shape),
                scrambled=config.scrambled,
            )
        )
        and H >= 128 and W >= 128
    )


def _permute_planes(arrays, shape, unscramble=False):
    """Permute (B, H, W) farfield-resident arrays into/out of the
    scrambled layout."""
    from slmsuite_tpu.ops import engine as _engine

    perm_h, perm_w, _ = _engine._scramble_maps(tuple(shape))
    if unscramble:
        inv_h = np.empty_like(perm_h); inv_h[perm_h] = np.arange(shape[0])
        inv_w = np.empty_like(perm_w); inv_w[perm_w] = np.arange(shape[1])
        perm_h, perm_w = inv_h, inv_w
    ph, pw = jnp.asarray(perm_h), jnp.asarray(perm_w)
    return [
        jnp.take(jnp.take(a, ph, axis=-2), pw, axis=-1) for a in arrays
    ]


def _scan_planes(step, n_iterations, psi, weights, phase_ff, fixed,
                 streak, start, consts):
    """Scan the step from the RESUMABLE Kim state: global iteration
    numbers ``start + [0, n)`` and the carried fixed/phase store, so a
    second ``optimize()`` call continues the trajectory exactly like the
    single-plane engine (which seeds ``state.iteration = holo.iter`` and
    ``fixed_phase`` from the flags) instead of silently restarting the
    WGS warm-up and un-fixing the Kim phase."""
    carry = (psi, weights, phase_ff, fixed, streak)

    def body(carry, i):
        return step(carry, dict(consts, iteration=i))

    carry, stats = jax.lax.scan(
        body, carry, start + jnp.arange(n_iterations)
    )
    return carry[0], carry[1], carry[2], carry[3], stats


def _scalar_keys(config):
    return (
        "amp", "feedback_exponent", "feedback_factor",
        "fix_phase_iteration", "fix_phase_efficiency",
    ) + (("mraf_factor",) if config.mraf else ())


def _plane_keys(config):
    return ("kernels", "targets") + (("mcodes",) if config.mraf else ())


@functools.lru_cache(maxsize=32)
def _compiled_batched_single(config, n_iterations):
    """Cached jitted single-device runner — rebuilding the jit wrapper
    per call would retrace the whole scan every invocation (a ~1 s cost
    at 1024² that used to swamp per-iteration timing)."""
    step = make_batched_gs_step(config)
    return jax.jit(functools.partial(_scan_planes, step, n_iterations))


@functools.lru_cache(maxsize=16)
def _compiled_batched_sharded(config, n_iterations, mesh, axis_name):
    """Cached jitted shard_map runner (planes over ``axis_name``)."""
    step = make_batched_gs_step(config, axis_name=axis_name)

    replicated = P()
    scalar_keys = _scalar_keys(config)
    plane_keys = _plane_keys(config)
    in_specs = (
        replicated,                      # psi
        P(axis_name, None, None),        # weights
        P(axis_name, None, None),        # phase_ff
        P(axis_name),                    # fixed
        P(axis_name),                    # streak
        replicated,                      # start iteration
        {
            **{key: P(axis_name, None, None) for key in plane_keys},
            "plane_weights": P(axis_name),
            **{key: replicated for key in scalar_keys},
        },
    )
    out_specs = (
        replicated,                      # psi
        P(axis_name, None, None),        # weights
        P(axis_name, None, None),        # phase_ff
        P(axis_name),                    # fixed
        P(None, axis_name, None),        # stats
    )

    return jax.jit(
        shard_map(
            functools.partial(_scan_planes, step, n_iterations),
            mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False,
        )
    )


def run_batched_gs(config, psi, weights, consts, n_iterations, mesh=None,
                   axis_name="data", start_iteration=0, phase_ff=None,
                   fixed=None):
    """
    Run ``n_iterations`` of the batched multiplane loop.

    Single-device when ``mesh`` is ``None``; otherwise planes shard over
    ``axis_name`` with the nearfield sum as a ``psum`` collective. The
    per-plane FFTs promote to the scrambled path
    (targets/weights permuted here, transparently to the caller).

    ``start_iteration``/``phase_ff``/``fixed`` RESUME a previous run —
    the same semantics as the single-plane engine's state seeding
    (``state.iteration = holo.iter``, ``fixed_phase`` from the flags,
    phase store from ``_phase_ff_folded``): global iteration numbers
    continue, so the WGS warm-up is not silently re-run and a fixed Kim
    phase stays fixed. Defaults start a fresh run.

    Returns ``(psi, weights, stats (n, B, 5), phase_ff, fixed)`` — per
    plane ``[efficiency, uniformity, pkpk_err, std_err, fixed_phase]``
    (the last column is the Kim flag history; zeros for non-Kim
    methods), plus the final per-plane farfield phase store and Kim
    fixed flags to feed back on resume.
    """
    if _batched_can_scramble(config):
        config = dataclasses.replace(config, scrambled=True)
        weights, targets = _permute_planes(
            [weights, consts["targets"]], config.shape
        )
        consts = dict(consts, targets=targets)
        if config.mraf:
            (mcodes,) = _permute_planes([consts["mcodes"]], config.shape)
            consts["mcodes"] = mcodes
        if phase_ff is not None:
            (phase_ff,) = _permute_planes([phase_ff], config.shape)
        psi, weights, stats, phase_ff, fixed = run_batched_gs(
            config, psi, weights, consts, n_iterations, mesh, axis_name,
            start_iteration=start_iteration, phase_ff=phase_ff,
            fixed=fixed,
        )
        weights, phase_ff = _permute_planes(
            [weights, phase_ff], config.shape, unscramble=True
        )
        return psi, weights, stats, phase_ff, fixed

    B = weights.shape[0]
    if phase_ff is None:
        phase_ff = jnp.zeros_like(weights)
    else:
        phase_ff = jnp.asarray(phase_ff, jnp.float32)
    fixed = (
        jnp.zeros(B, dtype=bool) if fixed is None
        else jnp.asarray(fixed, dtype=bool)
    )
    streak = jnp.zeros(B, dtype=jnp.int32)
    start = jnp.int32(start_iteration)

    if mesh is None:
        run = _compiled_batched_single(config, int(n_iterations))
        psi, weights, phase_ff, fixed, stats = run(
            psi, weights, phase_ff, fixed, streak, start, consts
        )
        return psi, weights, stats, phase_ff, fixed

    fn = _compiled_batched_sharded(config, int(n_iterations), mesh, axis_name)
    scalar_keys = _scalar_keys(config)
    plane_keys = _plane_keys(config)

    # Place inputs on the mesh.
    psi = jax.device_put(psi, NamedSharding(mesh, P()))
    plane_sharded = NamedSharding(mesh, P(axis_name, None, None))
    vec_sharded = NamedSharding(mesh, P(axis_name))
    weights = jax.device_put(weights, plane_sharded)
    phase_ff = jax.device_put(phase_ff, plane_sharded)
    fixed = jax.device_put(fixed, vec_sharded)
    streak = jax.device_put(streak, vec_sharded)
    consts = {
        **{
            key: jax.device_put(consts[key], plane_sharded)
            for key in plane_keys
        },
        "plane_weights": jax.device_put(
            consts["plane_weights"], vec_sharded
        ),
        **{key: consts[key] for key in scalar_keys},
    }
    psi, weights, phase_ff, fixed, stats = fn(
        psi, weights, phase_ff, fixed, streak, start, consts
    )
    return psi, weights, stats, phase_ff, fixed


def make_multiplane_consts(targets, kernels, plane_weights, amp,
                           feedback_exponent=0.8, feedback_factor=0.1,
                           fix_phase_iteration=10, fix_phase_efficiency=None,
                           mraf_factor=None):
    """Assemble the consts dict for :meth:`run_batched_gs` (numpy inputs
    ok). ``targets`` may carry NaN noise regions (MRAF): per-plane region
    codes are derived here and the stored targets are cleaned."""
    targets = np.asarray(targets, dtype=np.float32)
    consts = {
        "kernels": jnp.asarray(kernels, dtype=jnp.float32),
        "targets": jnp.asarray(np.nan_to_num(targets)),
        "plane_weights": jnp.asarray(plane_weights, dtype=jnp.float32),
        "amp": (
            jnp.float32(amp) if np.isscalar(amp) else jnp.asarray(amp, dtype=jnp.float32)
        ),
        "feedback_exponent": jnp.float32(feedback_exponent),
        "feedback_factor": jnp.float32(feedback_factor),
        "fix_phase_iteration": jnp.int32(fix_phase_iteration),
        "fix_phase_efficiency": jnp.float32(
            np.nan if fix_phase_efficiency is None else fix_phase_efficiency
        ),
    }
    if np.any(np.isnan(targets)):
        nan = np.isnan(targets)
        consts["mcodes"] = jnp.asarray(
            np.where(nan, 2, np.nan_to_num(targets) > 0).astype(np.uint8)
        )
        consts["mraf_factor"] = jnp.float32(
            1.0 if mraf_factor is None else mraf_factor
        )
    return consts
