r"""
2D FFT tiers for the propagation pair.

Two tiers compute the same orthonormal transform:

- ``"xla"``: ``jnp.fft.fft2`` — cuFFT on a GPU, XLA's own FFT on the
  CPU. Any size.
- ``"matmul"``: the four-step (Bailey) algorithm, which writes each 1D
  FFT of length :math:`N = N_1 N_2` as two dense DFT matmuls plus a
  twiddle multiply:

.. math::
    X[k_1 + k_2 N_1] = \sum_{n_2} \omega_{N_2}^{n_2 k_2}
        \left[ \omega_N^{n_2 k_1}
        \sum_{n_1} \omega_{N_1}^{n_1 k_1} x[n_1 N_2 + n_2] \right]

  which costs :math:`N(N_1 + N_2)` complex MACs instead of :math:`N^2`
  and runs as batched matmuls. Complex arithmetic is decomposed into
  real matmuls with ``preferred_element_type=float32`` at the precision
  set by :meth:`set_fft_precision`: ``"HIGHEST"`` (true float32, the
  default) or ``"DEFAULT"`` (TF32 on a GPU's tensor cores). Sizes with
  no balanced factorization fall back to ``"xla"``.

The default tier per platform is :data:`_DEFAULT_BACKEND` (see
:meth:`get_fft_backend`); :meth:`set_fft_backend` overrides it.
Used by :mod:`slmsuite_tpu.ops.propagation`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fft2", "ifft2", "set_fft_backend", "get_fft_backend"]

# --------------------------------------------------------------------------
# Backend selection.
# --------------------------------------------------------------------------

_BACKEND = None  # lazy: the platform default on first use

#: Default FFT tier per platform (:func:`slmsuite_tpu.ops.platform.accelerator`);
#: platforms not listed take ``"xla"``. None is listed: through
#: ``SpotHologram.optimize("WGS-Kim")`` on an H100 (400 W limit), cuFFT
#: took 0.30 ms per iteration at 2048^2 and 0.086 ms at 1024^2, the
#: four-step tier 0.84-1.22 ms and 0.14-0.36 ms (TF32 or float32,
#: scrambled or natural).
_DEFAULT_BACKEND = {}


def get_fft_backend():
    """Current 2D-FFT backend: ``"xla"`` (``jnp.fft``) or ``"matmul"``
    (einsum four-step)."""
    global _BACKEND
    if _BACKEND is None:
        from slmsuite_tpu.ops.platform import accelerator

        _BACKEND = _DEFAULT_BACKEND.get(accelerator(), "xla")
    return _BACKEND


def set_fft_backend(backend):
    """Override the FFT backend (``"matmul"`` or ``"xla"``). A change
    clears JAX's compiled-program caches, so programs compiled for the
    other tier retrace on their next call."""
    global _BACKEND
    if backend not in ("matmul", "xla"):
        raise ValueError(f"Unknown FFT backend '{backend}'.")
    if backend != _BACKEND:
        jax.clear_caches()
    _BACKEND = backend


# --------------------------------------------------------------------------
# Plan construction (host-side, cached; becomes jit constants).
# --------------------------------------------------------------------------


def _split(n):
    """Balanced factorization ``n = n1 * n2`` with ``n1 >= n2``.

    Power-of-two sizes keep the historical split (``n1 = 2^ceil(log/2)``,
    the layout every committed plan/kernel was validated on). Other
    composite sizes take the divisor pair closest to ``sqrt(n)`` — the
    four-step algebra is factorization-generic, so 1536 (48x32),
    1920 (48x40), 3072 (64x48), ... ride the same matmul path. Sizes with
    no balanced factorization (primes and near-primes, where one factor
    would exceed 16x the other) raise — callers fall back to the XLA
    FFT, which handles any size.
    """
    n = int(n)
    if n >= 4 and n & (n - 1) == 0:
        log = int(np.log2(n))
        n1 = 2 ** ((log + 1) // 2)
        return n1, n // n1
    for n2 in range(int(np.sqrt(n)), 1, -1):
        if n % n2 == 0:
            n1 = n // n2
            if n1 <= 16 * n2:
                return n1, n2
            break
    raise ValueError(
        f"matmul FFT requires a balanced factorization; got {n}."
    )


@functools.lru_cache(maxsize=256)
def _split_ok(n):
    """Whether length ``n`` has a balanced four-step factorization."""
    try:
        _split(n)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=32)
def _plan(n, inverse):
    """DFT factor matrices and twiddles for length ``n`` (numpy complex64)."""
    sign = 2j * np.pi * (1 if inverse else -1)
    n1, n2 = _split(n)

    k1 = np.arange(n1)
    k2 = np.arange(n2)
    # W1[k1, n1'] contracts the stride-n2 sub-series.
    w1 = np.exp(sign * np.outer(k1, k1) / n1).astype(np.complex64)
    # Twiddle[k1, n2'].
    tw = np.exp(sign * np.outer(k1, k2) / n).astype(np.complex64)
    # W2[n2', k2] contracts the remainder.
    w2 = np.exp(sign * np.outer(k2, k2) / n2).astype(np.complex64)
    return n1, n2, w1, tw, w2


#: Matmul precision of the four-step stages (read at trace time, so a
#: change applies to programs traced afterwards; the engine keys its
#: compiled runs on ``GSConfig.kernel_precision`` and pins this value
#: around each run). ``"HIGHEST"`` is true float32; ``"DEFAULT"`` lets a
#: GPU run float32 matmuls in TF32 (about three decimal digits per
#: product). The ``"xla"`` tier ignores it.
_PRECISION = "HIGHEST"


def set_fft_precision(precision):
    """Set the four-step matmul precision: ``"HIGHEST"`` (default),
    ``"HIGH"``, or ``"DEFAULT"`` (TF32 on a GPU)."""
    global _PRECISION
    if precision not in ("HIGH", "HIGHEST", "DEFAULT"):
        raise ValueError(f"Unknown precision '{precision}'.")
    _PRECISION = precision


def _cmatmul(ar, ai, br, bi, subscript):
    """
    Complex einsum via four real f32 matmuls.

    Stacking the data re/im into one batched operand (2 matmuls) costs
    +30% bytes in XLA's cost analysis (the stack materializes a copy
    while XLA already fuses the four-einsum reads).
    """
    kwargs = dict(
        precision=getattr(jax.lax.Precision, _PRECISION),
        preferred_element_type=jnp.float32,
    )
    rr = jnp.einsum(subscript, ar, br, **kwargs)
    ri = jnp.einsum(subscript, ar, bi, **kwargs)
    ir = jnp.einsum(subscript, ai, br, **kwargs)
    ii = jnp.einsum(subscript, ai, bi, **kwargs)
    return rr - ii, ri + ir


def _fft_last_axis(xr, xi, n, inverse):
    """
    Four-step FFT along the last axis of an (..., n) real/imag pair.
    Returns the transformed (real, imag) pair, unnormalized.
    """
    n1, n2, w1, tw, w2 = _plan(n, inverse)
    batch = xr.shape[:-1]

    xr = xr.reshape(batch + (n1, n2))
    xi = xi.reshape(batch + (n1, n2))

    # Stage 1: contract n1 (the stride-n2 sub-series) with DFT_n1.
    ar, ai = _cmatmul(w1.real, w1.imag, xr, xi, "ka,...an->...kn")

    # Stage 2: twiddle.
    ar, ai = ar * tw.real - ai * tw.imag, ar * tw.imag + ai * tw.real

    # Stage 3: contract n2 with DFT_n2.
    br, bi = _cmatmul(ar, ai, w2.real, w2.imag, "...kn,nm->...km")

    # Output index k = k1 + k2 * n1 -> transpose (k2, k1) then ravel.
    br = jnp.swapaxes(br, -1, -2).reshape(batch + (n,))
    bi = jnp.swapaxes(bi, -1, -2).reshape(batch + (n,))
    return br, bi


def _fft2_pair(xr, xi, inverse, norm):
    """2D FFT on a real/imag pair of shape (..., H, W)."""
    H, W = xr.shape[-2:]

    xr, xi = _fft_last_axis(xr, xi, W, inverse)
    xr = jnp.swapaxes(xr, -1, -2)
    xi = jnp.swapaxes(xi, -1, -2)
    xr, xi = _fft_last_axis(xr, xi, H, inverse)
    xr = jnp.swapaxes(xr, -1, -2)
    xi = jnp.swapaxes(xi, -1, -2)

    if norm == "ortho":
        scale = 1.0 / np.sqrt(H * W)
    elif inverse:
        scale = 1.0 / (H * W)
    else:
        scale = None
    if scale is not None:
        xr = xr * scale
        xi = xi * scale
    return xr, xi


def _matmul_shape(shape):
    """Whether the trailing 2D shape rides the four-step matmul path."""
    H, W = shape[-2:]
    return H >= 4 and W >= 4 and _split_ok(H) and _split_ok(W)


def fft2(x, norm="ortho"):
    """
    2D FFT over the last two axes: ``jnp.fft.fft2`` (``"xla"`` backend,
    any size) or the four-step matmul algorithm (``"matmul"``, any size
    with a balanced factorization — all powers of two, plus 1536, 1920,
    3072, ...; unbalanced sizes such as primes fall back to ``"xla"``).
    Complex in/out; call inside jit.
    """
    if get_fft_backend() == "xla" or not _matmul_shape(x.shape):
        return jnp.fft.fft2(x, norm=norm)
    xr, xi = _fft2_pair(x.real, x.imag, inverse=False, norm=norm)
    return (xr + 1j * xi).astype(jnp.complex64)


def ifft2(x, norm="ortho"):
    """Inverse 2D FFT over the last two axes (see :meth:`fft2`)."""
    if get_fft_backend() == "xla" or not _matmul_shape(x.shape):
        return jnp.fft.ifft2(x, norm=norm)
    xr, xi = _fft2_pair(x.real, x.imag, inverse=True, norm=norm)
    return (xr + 1j * xi).astype(jnp.complex64)


# --------------------------------------------------------------------------
# Scrambled-layout 2D FFT: transpose-free hot loop.
#
# The four-step FFT naturally produces output index k = k1 + k2*n1 at
# array position (k1, k2); restoring natural order costs a full
# transpose+copy per axis. A GS/WGS loop never needs natural order
# inside the iteration: the farfield constraint is elementwise and the
# statistics are sums, so the loop can run entirely in the scrambled
# basis — targets/weights/masks are permuted ONCE on the host with
# :meth:`scramble_permutation`, and the matching inverse consumes the
# scrambled layout directly and emits the natural nearfield (the
# conjugate four-step with factor roles exchanged — no transpose on
# either side). This removes ~4 full-array copies per iteration from a
# bandwidth-bound loop.
# --------------------------------------------------------------------------


def scramble_permutation(n):
    """
    Permutation ``perm`` (length ``n``) with ``perm[pos] = natural_index``:
    scrambled position ``pos = k1 * n2 + k2`` holds natural frequency
    ``k = k1 + k2 * n1``. ``natural[k] == scrambled.ravel()[pos]`` i.e.
    ``scrambled_array = natural_array[perm]``.
    """
    n1, n2 = _split(n)
    k1 = np.arange(n1).reshape(-1, 1)
    k2 = np.arange(n2).reshape(1, -1)
    return (k1 + k2 * n1).ravel()


def scramble_permutation_2d(shape):
    """Row/column permutations for a 2D scrambled farfield ``(H, W)``."""
    return scramble_permutation(shape[0]), scramble_permutation(shape[1])


def _fft_last_axis_scrambled(xr, xi, n):
    """Forward four-step along the last axis; output left in (k1, k2) order."""
    n1, n2, w1, tw, w2 = _plan(n, False)
    batch = xr.shape[:-1]
    xr = xr.reshape(batch + (n1, n2))
    xi = xi.reshape(batch + (n1, n2))
    ar, ai = _cmatmul(w1.real, w1.imag, xr, xi, "ka,...an->...kn")
    ar, ai = ar * tw.real - ai * tw.imag, ar * tw.imag + ai * tw.real
    br, bi = _cmatmul(ar, ai, w2.real, w2.imag, "...kn,nm->...km")
    return br.reshape(batch + (n,)), bi.reshape(batch + (n,))  # (k1, k2) flat.


def _ifft_last_axis_scrambled(xr, xi, n):
    """
    Inverse four-step along the last axis *consuming* (k1, k2) order and
    emitting natural order:

    .. math::
        x[m_1 n_2 + m_2] = \\sum_{k_1} \\bar W_1[m_1, k_1]\\,
            \\bar{tw}[k_1, m_2] \\sum_{k_2} S[k_1, k_2] \\bar W_2[k_2, m_2]
    """
    n1, n2, w1, tw, w2 = _plan(n, True)  # Conjugate (inverse-sign) matrices.
    batch = xr.shape[:-1]
    xr = xr.reshape(batch + (n1, n2))
    xi = xi.reshape(batch + (n1, n2))
    ar, ai = _cmatmul(xr, xi, w2.real, w2.imag, "...kn,nm->...km")  # (k1, m2)
    ar, ai = ar * tw.real - ai * tw.imag, ar * tw.imag + ai * tw.real
    br, bi = _cmatmul(w1.real, w1.imag, ar, ai, "mk,...kn->...mn")  # (m1, m2)
    return br.reshape(batch + (n,)), bi.reshape(batch + (n,))


def _fft_first_axis_scrambled(xr, xi, n):
    """Forward four-step along axis 0 of an (n, W)-shaped pair, no transpose."""
    n1, n2, w1, tw, w2 = _plan(n, False)
    rest = xr.shape[1:]
    xr = xr.reshape((n1, n2) + rest)
    xi = xi.reshape((n1, n2) + rest)
    ar, ai = _cmatmul(w1.real, w1.imag, xr, xi, "ka,an...->kn...")
    twr = tw.real.reshape(tw.shape + (1,) * len(rest))
    twi = tw.imag.reshape(tw.shape + (1,) * len(rest))
    ar, ai = ar * twr - ai * twi, ar * twi + ai * twr
    br, bi = _cmatmul(ar, ai, w2.real, w2.imag, "kn...,nm->km...")
    return br.reshape((n,) + rest), bi.reshape((n,) + rest)


def _ifft_first_axis_scrambled(xr, xi, n):
    """Inverse four-step along axis 0 consuming (k1, k2), emitting natural."""
    n1, n2, w1, tw, w2 = _plan(n, True)
    rest = xr.shape[1:]
    xr = xr.reshape((n1, n2) + rest)
    xi = xi.reshape((n1, n2) + rest)
    ar, ai = _cmatmul(xr, xi, w2.real, w2.imag, "kn...,nm->km...")
    twr = tw.real.reshape(tw.shape + (1,) * len(rest))
    twi = tw.imag.reshape(tw.shape + (1,) * len(rest))
    ar, ai = ar * twr - ai * twi, ar * twi + ai * twr
    br, bi = _cmatmul(w1.real, w1.imag, ar, ai, "mk,kn...->mn...")
    return br.reshape((n,) + rest), bi.reshape((n,) + rest)


def fft2_scrambled_pair(xr, xi):
    """
    Forward 2D FFT (ortho) of a natural-order real/imag pair; the result
    rows/cols are in the scrambled order of :meth:`scramble_permutation_2d`.
    """
    H, W = xr.shape[-2:]
    xr, xi = _fft_last_axis_scrambled(xr, xi, W)
    xr, xi = _fft_first_axis_scrambled(xr, xi, H)
    scale = 1.0 / np.sqrt(H * W)
    return xr * scale, xi * scale


def ifft2_scrambled_pair(xr, xi):
    """
    Inverse 2D FFT (ortho) consuming the scrambled layout produced by
    :meth:`fft2_scrambled_pair`; output is in natural order.
    """
    H, W = xr.shape[-2:]
    xr, xi = _ifft_last_axis_scrambled(xr, xi, W)
    xr, xi = _ifft_first_axis_scrambled(xr, xi, H)
    scale = 1.0 / np.sqrt(H * W)
    return xr * scale, xi * scale


# --------------------------------------------------------------------------
# Scrambled-layout compositions used by the engines.
# --------------------------------------------------------------------------


def fft2_scrambled_polar(xr, xi):
    """Scrambled forward fft2 returning ``(amplitude, phase)``."""
    re, im = fft2_scrambled_pair(xr, xi)
    return jnp.sqrt(jnp.square(re) + jnp.square(im)), jnp.arctan2(im, re)


def fft2_scrambled_polar_from_phase(psi, amp):
    """Scrambled forward polar FFT of ``amp * exp(i psi)``."""
    return fft2_scrambled_polar(amp * jnp.cos(psi), amp * jnp.sin(psi))


def ifft2_scrambled_phase(xr, xi):
    """Scrambled inverse FFT returning only the result's phase (the GS
    psi update)."""
    re, im = ifft2_scrambled_pair(xr, xi)
    return jnp.arctan2(im, re)


def wexp_ifft2_scrambled(weights, phase):
    """Complex ``ifft2_scrambled(weights * e^{i phase})`` (ortho) as a
    re/im pair (the multiplane backward needs the per-plane complex
    contribution for the weighted sum)."""
    return ifft2_scrambled_pair(
        weights * jnp.cos(phase), weights * jnp.sin(phase)
    )


def wexp_ifft2_scrambled_phase(weights, phase):
    """``arg(ifft2_scrambled(weights * e^{i phase}))`` — the backward
    half of the non-carry full-fuse-geometry WGS/GS step."""
    re, im = wexp_ifft2_scrambled(weights, phase)
    return jnp.arctan2(im, re)


# --------------------------------------------------------------------------
# Carry-mode WGS step: the loop carries the ROWS-TRANSFORMED field pair
# (gr, gi) instead of psi, merging the inverse-rows phase extraction and
# the next iteration's nearfield synthesis into one round trip with a
# single normalization (amp * Z/|Z|); the Kim phase store rides as a
# unit-phasor pair, so no transcendental (atan2/sincos) runs inside the
# loop: the farfield direction is F * rsqrt(|F|^2). Both use
# deferred-by-one weight normalization and the Parseval feedback norm.
# psi and the phase_ff angle exist only at the entry/exit boundaries.
#
# Layout of the carry: last (W) axis four-step-scrambled, first (H) axis
# natural.
# --------------------------------------------------------------------------

_WGS_NEG_FILL = -3.0e38


def _wgs_stats(f, target, mask, scalars, norm_sq, stats_on):
    """Stats partials (sums, maxs) shared by the carry steps."""
    neg = jnp.float32(_WGS_NEG_FILL)
    if stats_on:
        fsq = jnp.square(f)
        tsq = jnp.square(target)
        overlap = jnp.sum(target * f)
        err_full = tsq * scalars["inv_tsum"] - fsq * scalars["inv_fsum"]
        err = err_full * mask
        on = mask > 0
        u = fsq / jnp.where(on, tsq, 1.0)
        sums = jnp.stack(
            [overlap, jnp.sum(err), jnp.sum(jnp.square(err)), norm_sq]
        )
        maxs = jnp.stack(
            [
                jnp.max(jnp.where(on, err_full, neg)),
                jnp.max(jnp.where(on, u, neg)),
                jnp.max(jnp.where(on, -err_full, neg)),
                jnp.max(jnp.where(on, -u, neg)),
            ]
        )
    else:
        zero = jnp.float32(0.0)
        sums = jnp.stack([zero, zero, zero, norm_sq])
        maxs = jnp.full((4,), neg)
    return sums, maxs


def _wgs_correction(f, target, scalars, rule):
    """Elementwise WGS weight correction factor of the carry steps."""
    p = scalars["feedback_exponent"]
    if rule in ("leonardo", "kim"):
        on = target != 0
        c = f / jnp.where(on, target, 1.0)
        c = jnp.where(on & (c > 0) & jnp.isfinite(c), c, 1.0)
        c = jnp.exp(-p * jnp.log(c))
    elif rule == "wu":
        c = jnp.exp(p * (target - p * f * scalars["inv_fnorm"]))
    elif rule == "tanh":
        c = 1.0 + scalars["feedback_factor"] * jnp.tanh(
            p * (target - p * f * scalars["inv_fnorm"])
        )
    else:
        raise ValueError(f"Unfusable rule '{rule}'.")
    return jnp.where(jnp.isinf(c), 1.0, c)


def wgs_carry_entry(psi, amp):
    """psi (natural, unbounded range) -> rows-scrambled carry of
    ``e^{i psi}`` (a scalar amp folds into the step's post scale) or
    ``amp * e^{i psi}`` (array amp). Unnormalized: the step folds the
    1/sqrt(HW) scale into its post scale."""
    c, s = jnp.cos(psi), jnp.sin(psi)
    if jnp.ndim(amp) != 0:
        c, s = amp * c, amp * s
    return _fft_last_axis_scrambled(c, s, psi.shape[-1])


def wgs_carry_exit(gr, gi):
    """Rows-scrambled carry -> psi (normalization drops out of atan2)."""
    zr, zi = _ifft_last_axis_scrambled(gr, gi, gr.shape[-1])
    return jnp.arctan2(zi, zr)


def wgs_carry_step(gr, gi, amp, weights, phase_ff, target, mask, scalars,
                   *, rule, kim, stats_on):
    """
    One complete WGS iteration on the rows-transformed carry: forward
    column pass, weight update, Kim select and amplitude constraint,
    inverse column and row passes, nearfield amplitude replacement, and
    the next forward row pass. The Kim phase store rides as a unit-phasor
    pair ``phase_ff = (pffr, pffi)`` (:meth:`wgs_phasor_entry`), so the
    step evaluates no transcendental.

    ``scalars`` holds dynamic jnp scalars: ``inv_prev_norm``,
    ``apply_update``, ``use_theta`` (Kim), ``feedback_exponent``,
    ``feedback_factor``, ``inv_fnorm``, ``inv_tsum``, ``inv_fsum``.
    ``rule`` is static: "leonardo" | "kim" | "wu" | "tanh".

    Returns ``(gr_out, gi_out, weights_out, phase_ff_out | None, sums,
    maxs)`` with sums = [overlap, err_sum, err_sq_sum, norm_sq] and
    maxs = [err_max, u_max, -err_min, -u_min].
    """
    H, W = gr.shape
    scalar_amp = jnp.ndim(amp) == 0
    post = jnp.float32(1.0 / np.sqrt(H * W)) * (amp if scalar_amp else 1.0)

    # Forward cols pass completes the 2D transform (x 1/sqrt(HW) since
    # the carry is unnormalized).
    fr, fi = _fft_first_axis_scrambled(gr, gi, H)
    f2 = jnp.square(fr) + jnp.square(fi)
    f = jnp.sqrt(f2) * post

    c = _wgs_correction(f, target, scalars, rule)
    uw = weights * c
    uw = jnp.where(jnp.isnan(uw), jnp.float32(1e-4), uw)
    wout = jnp.where(
        scalars["apply_update"] > 0, uw * scalars["inv_prev_norm"], weights
    )

    # Farfield direction without transcendentals (phasor mode).
    # Pre-guarded rsqrt: rsqrt(0) = inf would make the untaken
    # where-branch compute 0 * inf = nan, which checkify flags.
    invb = jax.lax.rsqrt(jnp.where(f2 > 0, f2, 1.0))
    er = jnp.where(f2 > 0, fr * invb, 1.0)
    ei = jnp.where(f2 > 0, fi * invb, 0.0)
    if kim:
        use_theta = scalars["use_theta"] > 0
        cphi = jnp.where(use_theta, er, phase_ff[0])
        sphi = jnp.where(use_theta, ei, phase_ff[1])
        pff_out = (cphi, sphi)
    else:
        cphi, sphi = er, ei
        pff_out = None
    re = wout * cphi
    im = wout * sphi

    norm_sq = jnp.sum(jnp.square(wout))
    sums, maxs = _wgs_stats(f, target, mask, scalars, norm_sq, stats_on)

    # Inverse both axes (unnormalized), replace the nearfield amplitude,
    # re-transform the rows axis.
    hr, hi = _ifft_first_axis_scrambled(re, im, H)
    zr, zi = _ifft_last_axis_scrambled(hr, hi, W)
    mag2 = jnp.square(zr) + jnp.square(zi)
    safe = jax.lax.rsqrt(jnp.where(mag2 > 0, mag2, 1.0))  # checkify-safe
    if scalar_amp:
        ur = jnp.where(mag2 > 0, zr * safe, 1.0)
        ui = jnp.where(mag2 > 0, zi * safe, 0.0)
    else:
        inv = amp * safe
        ur = jnp.where(mag2 > 0, zr * inv, amp)
        ui = jnp.where(mag2 > 0, zi * inv, 0.0)
    gr2, gi2 = _fft_last_axis_scrambled(ur, ui, W)
    return gr2, gi2, wout, pff_out, sums, maxs


def mraf_carry_step(gr, gi, amp, weights, phase_ff, target, mask, mcode,
                    zw, scalars, *, rule, kim, stats_on, zero):
    """
    One complete MRAF WGS iteration on the rows-transformed carry (see
    :meth:`wgs_carry_step`), with one exact weight-norm reduction
    between the forward and inverse column passes. ``mcode`` is the
    farfield region code plane (1 = signal, 2 = noise, 0 = zero);
    ``zero=True`` folds the evolving zero-region weights ``zw`` into the
    mix.

    Returns ``(gr', gi', uw, phase_ff_out | None, zw_out | None, sums,
    maxs)`` — ``uw`` unnormalized with its norm in ``sums[3]``.
    """
    H, W = gr.shape
    scalar_amp = jnp.ndim(amp) == 0
    post = jnp.float32(1.0 / np.sqrt(H * W)) * (amp if scalar_amp else 1.0)

    br, bi = _fft_first_axis_scrambled(gr, gi, H)
    fr = br * post
    fi = bi * post
    f2 = jnp.square(fr) + jnp.square(fi)
    f = jnp.sqrt(f2)

    uw = weights * _wgs_correction(f, target, scalars, rule)
    uw = jnp.where(jnp.isnan(uw), jnp.float32(1e-4), uw)
    uw = jnp.where(
        scalars["apply_update"] > 0, uw * scalars["inv_prev_norm"], weights
    )
    norm_sq = jnp.sum(jnp.square(uw))
    inv_norm = jax.lax.rsqrt(norm_sq)

    invf = jax.lax.rsqrt(jnp.where(f2 > 0, f2, 1.0))  # checkify-safe
    er = jnp.where(f2 > 0, fr * invf, 1.0)
    ei = jnp.where(f2 > 0, fi * invf, 0.0)
    if kim:
        use_theta = scalars["use_theta"] > 0
        cphi = jnp.where(use_theta, er, phase_ff[0])
        sphi = jnp.where(use_theta, ei, phase_ff[1])
        pff_out = (cphi, sphi)
    else:
        pff_out = None
        cphi, sphi = er, ei

    k = scalars["mraf_factor"]
    wn = uw * inv_norm
    sig = mcode == 1.0
    noi = mcode == 2.0
    re = jnp.where(sig, wn * cphi, jnp.where(noi, k * fr, 0.0))
    im = jnp.where(sig, wn * sphi, jnp.where(noi, k * fi, 0.0))
    if zero:
        zf = scalars["zero_factor"]
        zmask = mcode == 0.0
        zwr = jnp.where(zmask, zw[0] - zf * f * fr, zw[0])
        zwi = jnp.where(zmask, zw[1] - zf * f * fi, zw[1])
        zw_out = jnp.stack([zwr, zwi])
        re = jnp.where(zmask, zwr, re)
        im = jnp.where(zmask, zwi, im)
    else:
        zw_out = None

    hr, hi = _ifft_first_axis_scrambled(re, im, H)
    zr, zi = _ifft_last_axis_scrambled(hr, hi, W)
    mag2 = jnp.square(zr) + jnp.square(zi)
    safe = jax.lax.rsqrt(jnp.where(mag2 > 0, mag2, 1.0))  # checkify-safe
    if scalar_amp:
        ur = jnp.where(mag2 > 0, zr * safe, 1.0)
        ui = jnp.where(mag2 > 0, zi * safe, 0.0)
    else:
        inv = amp * safe
        ur = jnp.where(mag2 > 0, zr * inv, amp)
        ui = jnp.where(mag2 > 0, zi * inv, 0.0)
    gr2, gi2 = _fft_last_axis_scrambled(ur, ui, W)

    sums, maxs = _wgs_stats(f, target, mask, scalars, norm_sq, stats_on)
    return gr2, gi2, uw, pff_out, zw_out, sums, maxs


def wgs_phasor_entry(phase_ff):
    """Kim phase-store angle plane -> unit-phasor pair (scan entry; the
    one place cos/sin of the stored phase is ever evaluated)."""
    return jnp.cos(phase_ff), jnp.sin(phase_ff)


def wgs_phasor_exit(pffr, pffi):
    """Unit-phasor pair -> angle plane (scan exit)."""
    return jnp.arctan2(pffi, pffr)
