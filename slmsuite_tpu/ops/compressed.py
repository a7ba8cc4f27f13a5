r"""
Compressed (grid-free) spot transforms and the compressed GS engine.

The jnp twins of the reference's custom CUDA kernels
(``cuda.cu:95-288``: ``compressed_farfield2nearfield`` /
``compressed_nearfield2farfield``). The transform pair is

.. math::
    \text{nf}[p] = \sum_n \text{ff}[n]\,
        e^{i \sum_d B[d,p]\, c[d,n]} / \sqrt{P}
    \qquad
    \text{ff}[n] = \sum_p \overline{K}[n,p]\, \text{nf}[p]

where :math:`B` is the Zernike basis stack evaluated once on the scaled
SLM grid and :math:`c` are per-spot Zernike coefficients. The phase
matrix :math:`B^T c` is a float32 matmul; the kernel is never
materialized globally — a ``lax.scan`` over pixel tiles bounds memory,
mirroring the reference's ``N_BATCH_MAX`` batching (``_spots.py:175``).
The fused kernels of :mod:`slmsuite_tpu.ops.pallas_compressed` keep the
phase tile in registers instead (GPU only).
"""

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slmsuite_tpu.ops.stats import calculate_stats
from slmsuite_tpu.ops.weights import update_weights_generic

#: Pixel-tile length for the scan (flattened SLM pixels per step).
PIXEL_TILE = 8192


def build_zernike_basis(indices, slm, dtype=np.float32):
    """
    Evaluate the Zernike basis stack ``(D, H*W)`` on the SLM's scaled grid
    (host-side, once per hologram). ``indices`` are ANSI (with ``-1`` the
    vortex special case); scaling comes from the SLM's measured source
    (``get_source_zernike_scaling``), matching the reference
    (``_spots.py:595-636``).
    """
    from slmsuite_tpu.holography.toolbox import _process_grid
    from slmsuite_tpu.holography.toolbox.phase import zernike_aperture, zernike_sum

    indices = np.ravel(indices)
    x_grid, y_grid = _process_grid(slm)
    x_scale, y_scale = zernike_aperture(slm, aperture=None)

    basis = zernike_sum(
        (np.asarray(x_grid) * x_scale, np.asarray(y_grid) * y_scale),
        indices,
        np.eye(len(indices)),
        aperture=1,
        use_mask=False,
    )
    return np.asarray(basis, dtype=dtype).reshape(len(indices), -1)


def _pad_to(x, size, axis):
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


@functools.partial(jax.jit, static_argnames=("n_spots",))
def farfield_to_nearfield(ff_re, ff_im, coeffs, basis, n_spots):
    """
    Expand ``(N,)`` spot amplitudes into the ``(P,)`` complex nearfield
    (returned as a re/im pair). ``coeffs (D, N)``, ``basis (D, P)``.
    """
    D, P = basis.shape
    n_tiles = -(-P // PIXEL_TILE)
    P_pad = n_tiles * PIXEL_TILE

    basis_tiles = _pad_to(basis, P_pad, 1).reshape(D, n_tiles, PIXEL_TILE)
    basis_tiles = jnp.moveaxis(basis_tiles, 1, 0)  # (tiles, D, T)

    scale = 1.0 / np.sqrt(P)

    def tile_fn(_, basis_tile):
        # (N, D) @ (D, T) -> phases, then sincos + matvec.
        phases = jnp.einsum(
            "dn,dt->nt", coeffs, basis_tile,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        cos = jnp.cos(phases)
        sin = jnp.sin(phases)
        re = ff_re @ cos - ff_im @ sin
        im = ff_re @ sin + ff_im @ cos
        return None, (re * scale, im * scale)

    _, (nf_re, nf_im) = jax.lax.scan(tile_fn, None, basis_tiles)
    return nf_re.reshape(-1)[:P], nf_im.reshape(-1)[:P]


@functools.partial(jax.jit, static_argnames=("n_spots",))
def nearfield_to_farfield(nf_re, nf_im, coeffs, basis, n_spots):
    """
    Conjugate-overlap reduction of the ``(P,)`` nearfield onto ``(N,)``
    spot amplitudes (normalized to unit norm, as the reference's kernels).
    """
    ff_re, ff_im = nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis, n_spots)
    norm = jnp.sqrt(jnp.sum(jnp.square(ff_re) + jnp.square(ff_im)))
    return ff_re / norm, ff_im / norm


def nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis, n_spots):
    """
    Unnormalized overlap reduction — the pixel-sharded engine psums these
    partial sums across devices *before* normalizing.
    """
    D, P = basis.shape
    n_tiles = -(-P // PIXEL_TILE)
    P_pad = n_tiles * PIXEL_TILE

    basis_tiles = jnp.moveaxis(
        _pad_to(basis, P_pad, 1).reshape(D, n_tiles, PIXEL_TILE), 1, 0
    )
    nf_re_t = _pad_to(nf_re, P_pad, 0).reshape(n_tiles, PIXEL_TILE)
    nf_im_t = _pad_to(nf_im, P_pad, 0).reshape(n_tiles, PIXEL_TILE)

    scale = 1.0 / np.sqrt(P)

    def tile_fn(carry, tile):
        acc_re, acc_im = carry
        basis_tile, re_t, im_t = tile
        phases = jnp.einsum(
            "dn,dt->nt", coeffs, basis_tile,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        cos = jnp.cos(phases)
        sin = jnp.sin(phases)
        # conj(kernel) * nf summed over the tile's pixels.
        acc_re = acc_re + cos @ re_t + sin @ im_t
        acc_im = acc_im + cos @ im_t - sin @ re_t
        return (acc_re, acc_im), None

    init = (jnp.zeros(coeffs.shape[1], jnp.float32), jnp.zeros(coeffs.shape[1], jnp.float32))
    (ff_re, ff_im), _ = jax.lax.scan(tile_fn, init, (basis_tiles, nf_re_t, nf_im_t))

    return ff_re * scale, ff_im * scale


@jax.jit
def build_kernel_cache(coeffs, basis):
    """
    Materialize the constant transform kernel as pixel-tiled cos/sin
    stacks ``(n_tiles, N, PIXEL_TILE)`` — the analog of the reference's
    cached cupy kernel batches (``_spots.py:595-636``, ``N_BATCH_MAX``
    cache). The kernel phases ``B^T c`` are loop INVARIANT: caching
    trades the per-iteration sincos recompute (~2 x N x P
    transcendentals) for a bandwidth-bound stream of the tiles. Built
    with the identical einsum/sincos the jnp recompute path runs
    (bit-for-bit match there).
    """
    D, P = basis.shape
    n_tiles = -(-P // PIXEL_TILE)
    P_pad = n_tiles * PIXEL_TILE
    basis_tiles = jnp.moveaxis(
        _pad_to(basis, P_pad, 1).reshape(D, n_tiles, PIXEL_TILE), 1, 0
    )

    def tile_fn(_, basis_tile):
        phases = jnp.einsum(
            "dn,dt->nt", coeffs, basis_tile,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return None, (jnp.cos(phases), jnp.sin(phases))

    _, (kc, ks) = jax.lax.scan(tile_fn, None, basis_tiles)
    return kc, ks


def kernel_cache_bytes(n_spots, n_pixels):
    """Device-memory footprint of :func:`build_kernel_cache` for a shape."""
    n_tiles = -(-n_pixels // PIXEL_TILE)
    return 2 * 4 * n_spots * n_tiles * PIXEL_TILE


#: Share of the device's memory limit the kernel cache may take by default.
CACHE_MEMORY_SHARE = 0.25


def cache_budget_mb():
    """Memory budget (MB) of :func:`build_kernel_cache`: the
    ``SLMSUITE_TPU_COMPRESSED_CACHE_MB`` environment override (``0``
    disables the cache), else :data:`CACHE_MEMORY_SHARE` of the default
    device's ``memory_stats()["bytes_limit"]``, else 0 where the device
    reports no limit."""
    import os

    override = os.environ.get("SLMSUITE_TPU_COMPRESSED_CACHE_MB")
    if override is not None:
        return float(override)
    stats = jax.local_devices()[0].memory_stats() or {}
    return CACHE_MEMORY_SHARE * stats.get("bytes_limit", 0) / 1e6


def farfield_to_nearfield_cached(ff_re, ff_im, kc, ks, n_pixels):
    """Cached-kernel twin of :func:`farfield_to_nearfield`."""
    scale = 1.0 / np.sqrt(n_pixels)

    def tile_fn(_, tile):
        cos, sin = tile
        re = ff_re @ cos - ff_im @ sin
        im = ff_re @ sin + ff_im @ cos
        return None, (re * scale, im * scale)

    _, (nf_re, nf_im) = jax.lax.scan(tile_fn, None, (kc, ks))
    return nf_re.reshape(-1)[:n_pixels], nf_im.reshape(-1)[:n_pixels]


def nearfield_to_farfield_cached(nf_re, nf_im, kc, ks, n_pixels):
    """Cached-kernel twin of :func:`nearfield_to_farfield` (normalized)."""
    n_tiles, N, T = kc.shape
    P_pad = n_tiles * T
    nf_re_t = _pad_to(nf_re, P_pad, 0).reshape(n_tiles, T)
    nf_im_t = _pad_to(nf_im, P_pad, 0).reshape(n_tiles, T)
    scale = 1.0 / np.sqrt(n_pixels)

    def tile_fn(carry, tile):
        acc_re, acc_im = carry
        cos, sin, re_t, im_t = tile
        acc_re = acc_re + cos @ re_t + sin @ im_t
        acc_im = acc_im + cos @ im_t - sin @ re_t
        return (acc_re, acc_im), None

    init = (jnp.zeros(N, jnp.float32), jnp.zeros(N, jnp.float32))
    (ff_re, ff_im), _ = jax.lax.scan(
        tile_fn, init, (kc, ks, nf_re_t, nf_im_t)
    )
    ff_re = ff_re * scale
    ff_im = ff_im * scale
    norm = jnp.sqrt(jnp.sum(jnp.square(ff_re) + jnp.square(ff_im)))
    return ff_re / norm, ff_im / norm


def _amp_replace(re, im, amp, valid, scalar_amp):
    """Amplitude replacement (``amp * nf/|nf|``) shared by every fused
    round trip, so the numeric conventions live in one place:

    - zero field -> unit real (the ``atan2(0, 0) = 0`` convention);
    - ``valid`` masks padded pixels to zero (their synthesized field is
      a nonzero spot sum the replacement would rescale into garbage);
    - pre-guarded ``rsqrt`` (checkify-safe: ``rsqrt(0) = inf`` would
      place a transient ``0 * inf`` NaN in the untaken where-branch).

    Returns the ``(ur, ui)`` replaced nearfield pair.
    """
    mag2 = re * re + im * im
    safe = jax.lax.rsqrt(jnp.where(mag2 > 0, mag2, 1.0))
    if scalar_amp:
        inv = valid * safe
        return (
            jnp.where(mag2 > 0, re * inv, valid),
            jnp.where(mag2 > 0, im * inv, 0.0),
        )
    inv = valid * amp * safe
    return (
        jnp.where(mag2 > 0, re * inv, valid * amp),
        jnp.where(mag2 > 0, im * inv, 0.0),
    )


def fused_iteration_cached(ff_re, ff_im, kc, ks, amp, n_spots, n_pixels):
    """Cached-kernel twin of :func:`_fused_iteration_jnp`: identical
    round-trip body, with the per-tile cos/sin read from the cache
    instead of recomputed. One pass over the cache per iteration."""
    n_tiles, N, T = kc.shape
    P_pad = n_tiles * T

    scalar_amp = jnp.ndim(amp) == 0
    if scalar_amp:
        amp_tiles = jnp.zeros((n_tiles, 1), jnp.float32)  # unused
    else:
        amp_tiles = _pad_to(amp, P_pad, 0).reshape(n_tiles, T)
    valid_tiles = (
        jnp.arange(P_pad).reshape(n_tiles, T) < n_pixels
    ).astype(jnp.float32)

    def tile_fn(carry, tile):
        acc_re, acc_im = carry
        cos, sin, amp_tile, valid = tile
        re = ff_re @ cos - ff_im @ sin
        im = ff_re @ sin + ff_im @ cos
        ur, ui = _amp_replace(
            re, im, None if scalar_amp else amp_tile, valid, scalar_amp
        )
        acc_re = acc_re + cos @ ur + sin @ ui
        acc_im = acc_im + cos @ ui - sin @ ur
        return (acc_re, acc_im), None

    init = (jnp.zeros(N, jnp.float32), jnp.zeros(N, jnp.float32))
    (fr, fi), _ = jax.lax.scan(
        tile_fn, init, (kc, ks, amp_tiles, valid_tiles)
    )
    return fr[:n_spots], fi[:n_spots]


def _fused_iteration_jnp(ff_re, ff_im, coeffs, basis, amp, n_spots):
    """One transform round trip with amplitude replacement, sharing a
    single phase/sincos evaluation per pixel tile (jnp twin of
    :meth:`pallas_compressed.fused_iteration`). Returns the unnormalized
    next-farfield pair."""
    D, P = basis.shape
    n_tiles = -(-P // PIXEL_TILE)
    P_pad = n_tiles * PIXEL_TILE

    basis_tiles = jnp.moveaxis(
        _pad_to(basis, P_pad, 1).reshape(D, n_tiles, PIXEL_TILE), 1, 0
    )
    scalar_amp = jnp.ndim(amp) == 0
    if scalar_amp:
        amp_tiles = jnp.zeros((n_tiles, 1), jnp.float32)  # unused
    else:
        amp_tiles = _pad_to(amp, P_pad, 0).reshape(n_tiles, PIXEL_TILE)

    # Padded pixels must contribute NOTHING to the reduction: their
    # synthesized nearfield is a nonzero spot sum that the amplitude
    # replacement would otherwise rescale into garbage.
    valid_tiles = (
        jnp.arange(P_pad).reshape(n_tiles, PIXEL_TILE) < P
    ).astype(jnp.float32)

    def tile_fn(carry, tile):
        acc_re, acc_im = carry
        basis_tile, amp_tile, valid = tile
        phases = jnp.einsum(
            "dn,dt->nt", coeffs, basis_tile,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        cos = jnp.cos(phases)
        sin = jnp.sin(phases)
        re = ff_re @ cos - ff_im @ sin
        im = ff_re @ sin + ff_im @ cos
        ur, ui = _amp_replace(
            re, im, None if scalar_amp else amp_tile, valid, scalar_amp
        )
        acc_re = acc_re + cos @ ur + sin @ ui
        acc_im = acc_im + cos @ ui - sin @ ur
        return (acc_re, acc_im), None

    N = coeffs.shape[1]
    init = (jnp.zeros(N, jnp.float32), jnp.zeros(N, jnp.float32))
    (fr, fi), _ = jax.lax.scan(
        tile_fn, init, (basis_tiles, amp_tiles, valid_tiles)
    )
    return fr[:n_spots], fi[:n_spots]



def apply_compressed_mraf_mix(ffp_re, ffp_im, ff_re, ff_im, consts,
                              zero_re=None, zero_im=None):
    """Per-spot MRAF constraint mix (reference ``_hologram.py:1644-1654``
    vector semantics): signal spots take the amplitude constraint
    (``ffp_*``), noise (nan ``spot_amp``) spots keep the unit-norm
    transform's farfield (``ff_*``, scaled by ``consts["mraf_k"]``), and
    null (zero) spots take ``zero_*`` — the evolving ``zero_factor``
    weights when provided (host loop), else hard zero."""
    sig = consts["signal_mask"]
    noi = consts["noise_mask"]
    kept_re = consts["mraf_k"] * ff_re
    kept_im = consts["mraf_k"] * ff_im
    zr = 0.0 if zero_re is None else zero_re
    zi = 0.0 if zero_im is None else zero_im
    return (
        jnp.where(sig, ffp_re, jnp.where(noi, kept_re, zr)),
        jnp.where(sig, ffp_im, jnp.where(noi, kept_im, zi)),
    )


def fused_iteration(ff_re, ff_im, coeffs, basis, amp, n_spots, use_pallas):
    """Dispatch the fused round trip: the Triton-route kernels when
    ``use_pallas``, the jnp twin otherwise."""
    if use_pallas:
        from slmsuite_tpu.ops import pallas_compressed as _pc

        return _pc.fused_iteration(ff_re, ff_im, coeffs, basis, amp, n_spots)
    return _fused_iteration_jnp(ff_re, ff_im, coeffs, basis, amp, n_spots)


# --------------------------------------------------------------------------
# Compressed GS engine.
# --------------------------------------------------------------------------


class CompressedGSState(NamedTuple):
    """Scan carry for compressed-spot GS (all real-valued leaves)."""

    psi: jnp.ndarray            # (P,) nearfield phase (flattened)
    weights: jnp.ndarray        # (N,) spot weights
    phase_ff: jnp.ndarray       # (N,) stored farfield phase
    fixed_phase: jnp.ndarray    # bool
    unfixed_streak: jnp.ndarray  # int32
    iteration: jnp.ndarray      # int32


@dataclasses.dataclass(frozen=True)
class CompressedGSConfig:
    """Static configuration for the compressed engine."""

    method: str
    n_pixels: int
    n_spots: int
    stat_groups: tuple = ()
    kim_efficiency_trigger: bool = False
    use_pallas: bool = False
    #: Per-spot MRAF (reference: nan ``spot_amp`` entries are noise
    #: spots with amplitude freedom, zeros are null spots — the
    #: constraint keeps the raw farfield at noise spots, optionally
    #: scaled by ``consts["mraf_k"]``, and zeroes null spots).
    mraf: bool = False
    #: Stream the precomputed cos/sin kernel tiles from device memory
    #: (``consts["kc_tiles"]/["ks_tiles"]``, :func:`build_kernel_cache`)
    #: instead of recomputing the sincos every iteration. Enabled by the
    #: hologram when the cache fits its memory budget; bit-identical to
    #: the jnp recompute path.
    kernel_cache: bool = False

    @property
    def is_wgs(self):
        return self.method.startswith("WGS")

    @property
    def is_kim(self):
        return "Kim" in self.method


def _get_transforms(config):
    if config.use_pallas:
        from slmsuite_tpu.ops.pallas_compressed import (
            farfield_to_nearfield as f2n,
            nearfield_to_farfield as n2f,
        )

        return f2n, n2f
    return farfield_to_nearfield, nearfield_to_farfield


def make_compressed_gs_step(config: CompressedGSConfig, transforms=None):
    """
    Pure per-iteration step: ``step(state, consts) -> (state, stats)``.
    ``transforms`` overrides the ``(f2n, n2f)`` pair — used by the
    pixel-sharded engine (:mod:`slmsuite_tpu.parallel.compressed`) to
    inject collective-aware variants.
    """
    f2n, n2f = _get_transforms(config) if transforms is None else transforms

    def step(state, consts):
        amp = consts["amp"]  # (P,) or scalar
        nf_re = amp * jnp.cos(state.psi)
        nf_im = amp * jnp.sin(state.psi)

        ff_re, ff_im = n2f(nf_re, nf_im, consts["coeffs"], consts["basis"], config.n_spots)
        amp_ff = jnp.sqrt(jnp.square(ff_re) + jnp.square(ff_im))
        theta = jnp.arctan2(ff_im, ff_re)

        stats_rows = []
        if "computational_spot" in config.stat_groups:
            stats_rows.append(
                calculate_stats(
                    amp_ff,
                    consts["target"],
                    mask=consts["stat_mask"],
                    efficiency_compensation=False,
                )
            )

        weights = state.weights
        if config.is_wgs:
            updated = update_weights_generic(
                weights,
                amp_ff,
                consts["target"],
                config.method,
                consts["feedback_exponent"],
                consts["feedback_factor"],
            )
            weights = jnp.where(state.iteration > 0, updated, weights)

        was_not_fixed = jnp.logical_not(state.fixed_phase)
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                # The trigger needs the current efficiency even when no
                # stat group is tracked (fix_phase_efficiency set alone
                # used to IndexError here at trace time).
                if stats_rows:
                    eff = stats_rows[-1][0]
                else:
                    eff = calculate_stats(
                        amp_ff,
                        consts["target"],
                        mask=consts["stat_mask"],
                        efficiency_compensation=False,
                    )[0]
                fixed = jnp.logical_or(
                    fixed, eff > consts["fix_phase_efficiency"]
                )
            streak = jnp.where(was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak)
            fixed = jnp.logical_or(
                fixed,
                jnp.logical_and(
                    jnp.logical_and(
                        was_not_fixed,
                        state.iteration >= consts["fix_phase_iteration"] - 1,
                    ),
                    streak >= consts["fix_phase_iteration"],
                ),
            )
            fixed = jnp.logical_and(fixed, state.iteration > 0)
            phase_ff = jnp.where(was_not_fixed, theta, state.phase_ff)
        else:
            fixed = jnp.zeros((), bool)
            streak = state.unfixed_streak
            phase_ff = theta

        ffp_re = weights * jnp.cos(phase_ff)
        ffp_im = weights * jnp.sin(phase_ff)
        if config.mraf:
            ffp_re, ffp_im = apply_compressed_mraf_mix(
                ffp_re, ffp_im, ff_re, ff_im, consts
            )

        nfp_re, nfp_im = f2n(ffp_re, ffp_im, consts["coeffs"], consts["basis"], config.n_spots)
        psi = jnp.arctan2(nfp_im, nfp_re)

        new_state = CompressedGSState(
            psi=psi,
            weights=weights,
            phase_ff=phase_ff,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
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


def make_compressed_carry_step(config: CompressedGSConfig):
    """
    Carry-mode per-iteration step for the scanned engine: ``state.psi``
    carries ``(raw_ff_re, raw_ff_im, ffp_re, ffp_im)`` — the
    unnormalized farfield entering this iteration plus the previous
    constrained farfield (for the exit transform). The whole epilogue
    is O(N) XLA; the O(N*P) transform round trip is ONE fused kernel
    (:meth:`fused_iteration`) sharing a single phase/sincos evaluation,
    vs two for the psi-carried step — the loop's dominant cost halves.
    """

    def step(state, consts):
        raw_re, raw_im, _, _ = state.psi
        norm = jnp.sqrt(jnp.sum(jnp.square(raw_re) + jnp.square(raw_im)))
        ff_re = raw_re / norm
        ff_im = raw_im / norm
        amp_ff = jnp.sqrt(jnp.square(ff_re) + jnp.square(ff_im))
        theta = jnp.arctan2(ff_im, ff_re)

        stats_rows = []
        if "computational_spot" in config.stat_groups:
            stats_rows.append(
                calculate_stats(
                    amp_ff,
                    consts["target"],
                    mask=consts["stat_mask"],
                    efficiency_compensation=False,
                )
            )

        weights = state.weights
        if config.is_wgs:
            updated = update_weights_generic(
                weights,
                amp_ff,
                consts["target"],
                config.method,
                consts["feedback_exponent"],
                consts["feedback_factor"],
            )
            weights = jnp.where(state.iteration > 0, updated, weights)

        was_not_fixed = jnp.logical_not(state.fixed_phase)
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                # The trigger needs the current efficiency even when no
                # stat group is tracked (fix_phase_efficiency set alone
                # used to IndexError here at trace time).
                if stats_rows:
                    eff = stats_rows[-1][0]
                else:
                    eff = calculate_stats(
                        amp_ff,
                        consts["target"],
                        mask=consts["stat_mask"],
                        efficiency_compensation=False,
                    )[0]
                fixed = jnp.logical_or(
                    fixed, eff > consts["fix_phase_efficiency"]
                )
            streak = jnp.where(was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak)
            fixed = jnp.logical_or(
                fixed,
                jnp.logical_and(
                    jnp.logical_and(
                        was_not_fixed,
                        state.iteration >= consts["fix_phase_iteration"] - 1,
                    ),
                    streak >= consts["fix_phase_iteration"],
                ),
            )
            fixed = jnp.logical_and(fixed, state.iteration > 0)
            phase_ff = jnp.where(was_not_fixed, theta, state.phase_ff)
        else:
            fixed = jnp.zeros((), bool)
            streak = state.unfixed_streak
            phase_ff = theta

        ffp_re = weights * jnp.cos(phase_ff)
        ffp_im = weights * jnp.sin(phase_ff)
        if config.mraf:
            # The carry holds the raw farfield; the mix consumes the
            # NORMALIZED values (raw/||raw||) matching the reference's
            # unit-norm transform convention — self-limiting.
            ffp_re, ffp_im = apply_compressed_mraf_mix(
                ffp_re, ffp_im, ff_re, ff_im, consts
            )

        if config.kernel_cache:
            next_re, next_im = fused_iteration_cached(
                ffp_re, ffp_im, consts["kc_tiles"], consts["ks_tiles"],
                consts["amp"], config.n_spots, config.n_pixels,
            )
        else:
            next_re, next_im = fused_iteration(
                ffp_re, ffp_im, consts["coeffs"], consts["basis"],
                consts["amp"], config.n_spots, config.use_pallas,
            )

        new_state = CompressedGSState(
            psi=(next_re, next_im, ffp_re, ffp_im),
            weights=weights,
            phase_ff=phase_ff,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
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


@functools.lru_cache(maxsize=32)
def _compiled_run(config, n_iterations):
    step = make_compressed_carry_step(config)
    f2n, n2f = _get_transforms(config)

    def run(state, consts):
        # Entry: psi -> farfield carry (the step divides by the carry's
        # norm, so the loop is scale-free; the MRAF noise-keep uses the
        # normalized values to match the reference's unit-norm
        # transform convention).
        amp = consts["amp"]
        nf_re = amp * jnp.cos(state.psi)
        nf_im = amp * jnp.sin(state.psi)
        if config.kernel_cache:
            ff0_re, ff0_im = nearfield_to_farfield_cached(
                nf_re, nf_im, consts["kc_tiles"], consts["ks_tiles"],
                config.n_pixels,
            )
        else:
            ff0_re, ff0_im = n2f(
                nf_re, nf_im, consts["coeffs"], consts["basis"],
                config.n_spots,
            )
        state = state._replace(psi=(ff0_re, ff0_im, ff0_re, ff0_im))

        def body(carry, _):
            return step(carry, consts)

        final, stats = jax.lax.scan(body, state, None, length=n_iterations)

        # Exit: the last constrained farfield -> nearfield phase.
        _, _, ffp_re, ffp_im = final.psi
        if config.kernel_cache:
            nfp_re, nfp_im = farfield_to_nearfield_cached(
                ffp_re, ffp_im, consts["kc_tiles"], consts["ks_tiles"],
                config.n_pixels,
            )
        else:
            nfp_re, nfp_im = f2n(
                ffp_re, ffp_im, consts["coeffs"], consts["basis"],
                config.n_spots,
            )
        final = final._replace(psi=jnp.arctan2(nfp_im, nfp_re))
        return final, stats

    return jax.jit(run, donate_argnums=(0,))


def run_compressed_gs(config, state, consts, n_iterations):
    """Run ``n_iterations`` of compressed-spot GS; returns ``(state, stats)``."""
    if int(n_iterations) == 0:
        return state, jnp.zeros(
            (0, len(config.stat_groups) + 1, 4), jnp.float32
        )
    return _compiled_run(config, int(n_iterations))(state, consts)
