r"""
Row-sharded full-plane GS: farfields larger than one chip.

For computational holography whose k-space exceeds a single card's memory
(e.g. 16384\ :sup:`2`\ +), the whole GS iteration runs with the plane's
**rows sharded** over a mesh axis:

- forward/backward transforms are the distributed pencil FFT
  (:mod:`slmsuite_tpu.parallel.fft2d`): local FFTs along the
  unsharded axis + one tiled ``all_to_all`` transpose per axis;
- the amplitude constraint, MRAF masking, and weight corrections are
  elementwise on each shard;
- the weight renormalization, statistics, and Kim triggers reduce with
  ``psum``/``pmin``/``pmax`` — a handful of scalars per iteration over
  NVLink.

Requires full-plane geometry (farfield shape == SLM shape), so the
nearfield is exactly ``amp * e^{i (psi + kernel)}`` per shard and the
extracted phase stays shard-local (a propagation kernel is an
elementwise shard-local phase — supported). Reached from the public API
via ``Hologram.optimize(mesh=...)``.

This is the holography analog of sequence parallelism (SURVEY section
5): the long axis of computational k-space shards over the mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from slmsuite_tpu.ops.engine import GSConfig, GSState
from slmsuite_tpu.ops.stats import calculate_stats
from slmsuite_tpu.ops.weights import update_weights_generic
from slmsuite_tpu.parallel.fft2d import _fft2_sharded

__all__ = ["plane_shardable", "run_sharded_plane_gs"]


def plane_shardable(config: GSConfig, n_devices: int):
    """Whether the row-sharded engine covers ``config`` on ``n_devices``:
    full-plane geometry (farfield shape == SLM shape; a propagation
    kernel is fine — it is a shard-local elementwise phase), computational
    feedback (no spot gathers — their index maps would cross shards),
    rows divisible by the mesh."""
    needs_spot = (
        config.feedback == "computational_spot"
        or "computational_spot" in config.stat_groups
    )
    H, W = config.shape
    return (
        tuple(config.shape) == tuple(config.slm_shape)
        and config.feedback == "computational"
        and not needs_spot
        and all(g == "computational" for g in config.stat_groups)
        and H % n_devices == 0
        and W % n_devices == 0  # The pencil transpose splits columns too.
    )


def make_sharded_plane_step(config: GSConfig, axis_name):
    """Per-shard step ``(state, consts) -> (state, stats)``; all plane
    arrays hold this shard's rows, scalars are replicated."""

    def step(state, consts):
        # --- (A) Nearfield -> farfield (local rows; pencil FFT). ---
        # A propagation kernel is a shard-local elementwise phase:
        # added before the forward transform, removed after the inverse
        # (mirrors ops.propagation.build_folded_nearfield /
        # extract_folded_phase at full-plane geometry).
        total = (
            state.psi + consts["kernel"] if config.has_kernel else state.psi
        )
        nearfield = (consts["amp"] * jnp.exp(1j * total)).astype(
            jnp.complex64
        )
        farfield = _fft2_sharded(nearfield, axis_name, inverse=False)
        amp_ff = jnp.abs(farfield)
        theta = jnp.arctan2(farfield.imag, farfield.real)

        # --- (B.2) Stats (psum-reduced; every shard gets the vector). ---
        # plane_shardable restricts stat_groups to "computational", so
        # one row per group of the same reduction; the guard keeps a
        # future gate relaxation from silently recording the wrong
        # metric instead of failing loudly.
        assert all(g == "computational" for g in config.stat_groups)
        stats_rows = [
            calculate_stats(
                amp_ff,
                consts["target"],
                mask=consts["stat_mask"],
                efficiency_compensation=False,
                axis_name=axis_name,
            )
            for _group in config.stat_groups
        ]

        # --- (B.3) Weights + Kim decision. ---
        weights = state.weights
        if config.is_wgs:
            updated = update_weights_generic(
                weights,
                amp_ff,
                consts["target"],
                config.method,
                consts["feedback_exponent"],
                consts["feedback_factor"],
                nan_checks=config.nan_checks,
                axis_name=axis_name,
            )
            weights = jnp.where(state.iteration > 0, updated, weights)

        was_not_fixed = jnp.logical_not(state.fixed_phase)
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                # The trigger needs the current efficiency even when no
                # stat group is tracked (fix_phase_efficiency set alone
                # IndexError'd here at trace time — same guard as
                # ops.compressed's carry step).
                if stats_rows:
                    eff = stats_rows[-1][0]
                else:
                    eff = calculate_stats(
                        amp_ff,
                        consts["target"],
                        mask=consts["stat_mask"],
                        efficiency_compensation=False,
                        axis_name=axis_name,
                    )[0]
                fixed = jnp.logical_or(
                    fixed, eff > consts["fix_phase_efficiency"]
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
            fixed = jnp.logical_and(
                jnp.logical_or(fixed, iter_trigger), state.iteration > 0
            )
            phase_ff = jnp.where(was_not_fixed, theta, state.phase_ff)
        else:
            fixed = jnp.zeros((), dtype=bool)
            streak = state.unfixed_streak
            phase_ff = theta

        constrained = weights * jnp.exp(1j * phase_ff)
        if config.mraf:
            new_farfield = jnp.where(consts["signal_mask"], constrained, farfield)
            if config.mraf_factor:
                new_farfield = jnp.where(
                    consts["noise_mask"],
                    consts["mraf_factor"] * new_farfield,
                    new_farfield,
                )
            if config.zero_factor:
                fz = jnp.where(consts["zero_mask"], farfield, 0.0)
                zw = (
                    state.zero_weights[0] + 1j * state.zero_weights[1]
                ).astype(jnp.complex64)
                zw = zw - consts["zero_factor"] * jnp.abs(fz) * fz
                zero_weights = jnp.stack([zw.real, zw.imag])
                new_farfield = jnp.where(consts["zero_mask"], zw, new_farfield)
            else:
                zero_weights = state.zero_weights
                new_farfield = jnp.where(consts["zero_mask"], 0.0, new_farfield)
        else:
            new_farfield = constrained
            zero_weights = state.zero_weights

        # --- (C) Farfield -> nearfield; local phase extraction. ---
        back = _fft2_sharded(
            new_farfield.astype(jnp.complex64), axis_name, inverse=True
        )
        psi = jnp.arctan2(back.imag, back.real)
        if config.has_kernel:
            psi = psi - consts["kernel"]

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
        internal = jnp.stack(
            [
                stats_rows[-1][0] if stats_rows else jnp.float32(jnp.nan),
                state.fixed_phase.astype(jnp.float32),
                jnp.float32(0),
                jnp.float32(0),
            ]
        )
        return new_state, jnp.stack(stats_rows + [internal])

    return step


_ROW_CONSTS = (
    "target", "stat_mask", "signal_mask", "noise_mask", "zero_mask", "kernel",
)


@functools.lru_cache(maxsize=16)
def _compiled_sharded_plane(config: GSConfig, n_iterations: int, mesh,
                            axis_name, consts_keys, amp_2d):
    step = make_sharded_plane_step(config, axis_name)

    def run(state, consts):
        def body(carry, _):
            return step(carry, consts)

        return jax.lax.scan(body, state, None, length=n_iterations)

    row = P(axis_name, None)
    state_specs = GSState(
        psi=row, weights=row, phase_ff=row,
        zero_weights=P(None, axis_name, None) if config.zero_factor else P(),
        fixed_phase=P(), unfixed_streak=P(), iteration=P(), w_norm=None,
    )
    specs = {
        key: row
        if key in _ROW_CONSTS or (key == "amp" and amp_2d)
        else P()
        for key in consts_keys
    }
    return jax.jit(
        shard_map(
            run, mesh=mesh,
            in_specs=(state_specs, specs),
            out_specs=(state_specs, P()),
            check_vma=False,
        )
    )


def run_sharded_plane_gs(config, state, consts, mesh, n_iterations,
                         axis_name="rows"):
    """
    Run ``n_iterations`` of full-plane GS with rows sharded over ``mesh``.

    ``state``/``consts`` follow :mod:`slmsuite_tpu.ops.engine` conventions
    (natural layout); plane arrays are placed row-sharded here. Returns
    ``(state, stats)`` shaped like :meth:`ops.engine.run_gs` — callers
    gather simply by ``np.asarray``.
    """
    n_devices = int(np.prod(list(mesh.shape.values())))
    if not plane_shardable(config, n_devices):
        raise ValueError(
            "Configuration not row-shardable (see plane_shardable)."
        )

    row = NamedSharding(mesh, P(axis_name, None))
    replicated = NamedSharding(mesh, P())

    def place_state(leaf_name, value):
        if value is None:
            return None
        if leaf_name in ("psi", "weights", "phase_ff"):
            return jax.device_put(value, row)
        if leaf_name == "zero_weights" and config.zero_factor:
            return jax.device_put(
                value, NamedSharding(mesh, P(None, axis_name, None))
            )
        return jax.device_put(value, replicated)

    state = GSState(
        **{
            name: place_state(name, getattr(state, name))
            for name in GSState._fields
        }
    )
    placed = {}
    for key, value in consts.items():
        if key in _ROW_CONSTS or (key == "amp" and jnp.ndim(value) == 2):
            placed[key] = jax.device_put(value, row)
        else:
            placed[key] = jax.device_put(value, replicated)

    fn = _compiled_sharded_plane(
        config, int(n_iterations), mesh, axis_name,
        tuple(sorted(consts.keys())), jnp.ndim(consts["amp"]) == 2,
    )
    return fn(state, placed)
