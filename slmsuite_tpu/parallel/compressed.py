r"""
Pixel-sharded compressed-spot holography over a device mesh.

The compressed transforms contract a ``(D, P)`` Zernike basis against
``(N,)`` spots (``P`` = SLM pixels, typically millions; ``N`` = spots,
typically hundreds). Sharding the **pixel axis** across the mesh makes

- ``farfield -> nearfield`` embarrassingly parallel (each chip expands
  its own pixel slab; zero communication), and
- ``nearfield -> farfield`` a local partial reduction followed by ONE
  ``psum`` of an ``(N,)`` vector per direction — a few kilobytes over
  the interconnect per iteration, negligible against the local matmuls.

Spot-space state (weights, farfield phase, Kim flags) is replicated;
every device redundantly runs the tiny ``(N,)`` weight update instead of
communicating it. The entire GS scan runs inside one ``shard_map`` so
XLA overlaps the collective with local compute.

This is the multi-chip path for grid-free holography
(cf. the single-chip engine in :mod:`slmsuite_tpu.ops.compressed`,
replacing the reference's single-GPU CUDA kernels ``cuda.cu:95-288``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from slmsuite_tpu.ops import compressed as _comp

__all__ = ["run_sharded_compressed_gs", "shard_compressed_consts"]


def _sharded_transforms(axis_name, n_devices):
    """(f2n, n2f) operating on a local pixel slab inside ``shard_map``."""
    correction = 1.0 / np.sqrt(n_devices)  # Local 1/sqrt(P_loc) -> global 1/sqrt(P).

    def f2n(ff_re, ff_im, coeffs, basis, n_spots):
        nf_re, nf_im = _comp.farfield_to_nearfield(ff_re, ff_im, coeffs, basis, n_spots)
        return nf_re * correction, nf_im * correction

    def n2f(nf_re, nf_im, coeffs, basis, n_spots):
        ff_re, ff_im = _comp.nearfield_to_farfield_raw(
            nf_re, nf_im, coeffs, basis, n_spots
        )
        # Global overlap: sum partials across the mesh, then normalize.
        ff_re = jax.lax.psum(ff_re, axis_name)
        ff_im = jax.lax.psum(ff_im, axis_name)
        norm = jnp.sqrt(jnp.sum(jnp.square(ff_re) + jnp.square(ff_im)))
        return ff_re / norm, ff_im / norm

    return f2n, n2f


@functools.lru_cache(maxsize=16)
def _compiled_sharded_run(config, n_iterations, mesh, axis_name):
    n_devices = mesh.shape[axis_name]
    step = _comp.make_compressed_gs_step(
        config, transforms=_sharded_transforms(axis_name, n_devices)
    )

    def run(state, consts):
        def body(carry, _):
            return step(carry, consts)

        return jax.lax.scan(body, state, None, length=n_iterations)

    state_specs = _comp.CompressedGSState(
        psi=P(axis_name), weights=P(), phase_ff=P(),
        fixed_phase=P(), unfixed_streak=P(), iteration=P(),
    )
    consts_specs = {
        "amp": P(axis_name),          # (P,) source amplitude slab.
        "basis": P(None, axis_name),  # (D, P) basis slab.
        "coeffs": P(), "target": P(), "stat_mask": P(),
        "feedback_exponent": P(), "feedback_factor": P(),
        "fix_phase_iteration": P(), "fix_phase_efficiency": P(),
    }
    if config.mraf:
        # Per-spot MRAF masks/factor are spot-space: replicated.
        consts_specs.update(
            signal_mask=P(), noise_mask=P(), mraf_k=P()
        )

    mapped = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(state_specs, consts_specs),
        out_specs=(state_specs, P()),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0,))


def shard_compressed_consts(consts, mesh, axis_name="pixels"):
    """
    Place a consts dict on the mesh: ``basis``/``amp`` sharded along the
    pixel axis, everything else replicated. Scalar ``amp`` is broadcast
    to a ``(P,)`` array first (the sharded engine requires the array form).
    """
    basis = np.asarray(consts["basis"])
    n_pixels = basis.shape[1]
    n_devices = mesh.shape[axis_name]
    if n_pixels % n_devices:
        raise ValueError(
            f"Pixel count {n_pixels} must divide the mesh axis ({n_devices})."
        )

    amp = consts["amp"]
    if jnp.ndim(amp) == 0:
        amp = jnp.full((n_pixels,), jnp.float32(amp))

    placed = {}
    for key, value in {**consts, "amp": amp}.items():
        if key == "basis":
            spec = P(None, axis_name)
        elif key == "amp":
            spec = P(axis_name)
        else:
            spec = P()
        placed[key] = jax.device_put(value, NamedSharding(mesh, spec))
    return placed


def run_sharded_compressed_gs(config, state, consts, mesh, n_iterations,
                              axis_name="pixels"):
    """
    Run ``n_iterations`` of compressed GS with the pixel axis sharded
    over ``mesh``. ``state.psi`` is placed along the axis; ``consts``
    should come from :meth:`shard_compressed_consts`.

    Returns ``(state, stats)`` like
    :meth:`slmsuite_tpu.ops.compressed.run_compressed_gs`.
    """
    run = _compiled_sharded_run(config, int(n_iterations), mesh, axis_name)

    placed_state = _comp.CompressedGSState(
        psi=jax.device_put(state.psi, NamedSharding(mesh, P(axis_name))),
        weights=jax.device_put(state.weights, NamedSharding(mesh, P())),
        phase_ff=jax.device_put(state.phase_ff, NamedSharding(mesh, P())),
        fixed_phase=jax.device_put(state.fixed_phase, NamedSharding(mesh, P())),
        unfixed_streak=jax.device_put(state.unfixed_streak, NamedSharding(mesh, P())),
        iteration=jax.device_put(state.iteration, NamedSharding(mesh, P())),
    )
    return run(placed_state, consts)
