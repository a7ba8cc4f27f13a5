r"""
Distributed 2D FFT: row/column decomposition over a mesh axis.

For fields too large for one card's memory (or to cut per-card time),
the 2D FFT splits as: local 1D FFTs along the unsharded axis, a global
transpose (``all_to_all`` over NVLink between the cards), local 1D FFTs
along the other axis, and a transpose back. This is the standard "pencil" decomposition,
expressed with ``shard_map`` so XLA schedules the collectives.

The sequence-parallel analog for holography (SURVEY.md section 5): the
long axis of computational k-space shards over the ``"space"`` mesh axis.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map


def _local_fft_rows(x, inverse):
    """Local 1D ortho FFT along the last axis: the four-step matmul
    formulation on the ``"matmul"`` FFT tier (any balanced-splittable
    size), ``jnp.fft`` otherwise."""
    from slmsuite_tpu.ops import fft as _fft

    n = x.shape[-1]
    if _fft.get_fft_backend() == "matmul" and n >= 4 and _fft._split_ok(n):
        re, im = _fft._fft_last_axis(x.real, x.imag, n, inverse)
        scale = 1.0 / jnp.sqrt(jnp.float32(n))
        return ((re + 1j * im) * scale).astype(jnp.complex64)
    fn = jnp.fft.ifft if inverse else jnp.fft.fft
    return fn(x, axis=-1, norm="ortho")


def _transpose_global(x_local, axis_name):
    """
    Per-device block (H/D, W) -> (W/D, H): exchange column chunks over the
    mesh axis, then transpose locally.
    """
    # (H/D, W) -> tiled all_to_all splits W over the axis and concats
    # the received chunks along rows -> (H, W/D).
    exchanged = jax.lax.all_to_all(
        x_local, axis_name, split_axis=1, concat_axis=0, tiled=True
    )
    return jnp.swapaxes(exchanged, 0, 1)  # (W/D, H)


def _fft2_sharded(x_local, axis_name, inverse):
    """Per-device body: rows-local FFT, global transpose, FFT, transpose back."""
    x_local = _local_fft_rows(x_local, inverse)          # FFT along W
    x_local = _transpose_global(x_local, axis_name)      # (W/D, H)
    x_local = _local_fft_rows(x_local, inverse)          # FFT along H
    x_local = _transpose_global(x_local, axis_name)      # (H/D, W)
    return x_local


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name", "inverse"))
def _distributed_fft2(x, mesh, axis_name, inverse):
    spec = P(axis_name, None)
    fn = shard_map(
        functools.partial(_fft2_sharded, axis_name=axis_name, inverse=inverse),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    sharding = NamedSharding(mesh, spec)
    return fn(jax.device_put(x, sharding))


def _check_divisible(x, mesh, axis_name):
    n_dev = mesh.shape[axis_name]
    H, W = x.shape[-2:]
    if H % n_dev or W % n_dev:
        raise ValueError(
            f"distributed_fft2 requires both dimensions of {(H, W)} "
            f"divisible by the mesh axis '{axis_name}' ({n_dev} devices) "
            f"- the pencil transpose exchanges equal column chunks."
        )


def distributed_fft2(x, mesh, axis_name="space"):
    """
    Orthonormal 2D FFT of ``x`` (rows sharded over ``axis_name``).
    Requires both dimensions divisible by the mesh axis size (validated
    here - violations otherwise surface as cryptic shard_map errors).
    """
    _check_divisible(x, mesh, axis_name)
    return _distributed_fft2(x, mesh, axis_name, False)


def distributed_ifft2(x, mesh, axis_name="space"):
    """Inverse of :meth:`distributed_fft2`."""
    _check_divisible(x, mesh, axis_name)
    return _distributed_fft2(x, mesh, axis_name, True)
