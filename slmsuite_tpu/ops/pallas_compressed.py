r"""
Fused Pallas kernels (Triton route) for the compressed Zernike spot
transforms.

The jnp path (:mod:`slmsuite_tpu.ops.compressed`) writes each
``(spots x pixel-tile)`` phase block, and its cos/sin, to device memory
and reads them back for the spot/pixel reductions. These kernels keep
the phase tile in registers: per pass the device-memory traffic is the
basis stack, the coefficients, the nearfield and the ``(N,)`` farfield.
This is the design of the reference's ``cuda.cu`` ``compressed_*``
kernels (``cuda.cu:95-288``).

The work is FMA- and sin/cos-bound: the phase synthesis contracts only
D ~ 3-6 Zernike terms, so it runs as D broadcast FMAs per element
instead of a matmul.

- :func:`farfield_to_nearfield`: one program per pixel block; a loop
  over spot blocks inside the program accumulates ``(S, T)`` tiles in
  registers and sums over spots once, after the loop.
- :func:`nearfield_to_farfield_raw`: a grid of (pixel group, spot
  block) programs; each loops over the pixel blocks of its group and
  writes a ``(S,)`` partial sum per spot, and XLA adds the partials of
  all groups (a second pass instead of atomics, so results are
  deterministic).

Every ``pl.pallas_call`` names ``backend="triton"``. ``interpret=True``
runs the same kernels on the CPU; the package never sets it, the tests
do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: Block sizes (powers of two, as Triton requires), chosen by a sweep on
#: an H100 at 1024^2 pixels x 256 spots: spots per block and pixels per
#: block of both kernels, pixel blocks each n2f program reduces, and
#: warps per program. Smaller tiles won over larger ones, which spill.
SPOT_BLOCK = 16
PIXEL_BLOCK = 128
N2F_GROUP = 8
NUM_WARPS = 4


def _next_pow2(n):
    return 1 << max(0, int(n - 1).bit_length())


def _spot_block(n_spots, spot_block):
    """Spot block for ``n_spots``: the configured block, or the next
    power of two of a smaller spot count."""
    return min(spot_block, _next_pow2(n_spots))


def _pad_axis(x, size, axis):
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def _phase_tile(coeffs_ref, s0, basis_rows, n_dims, n_spots_pad, spot_block):
    """``(S, T)`` phase tile ``sum_d c[d, s] * B[d, p]`` as D broadcast
    FMAs; ``basis_rows`` are the D ``(T,)`` basis rows already loaded."""
    phase = None
    for d in range(n_dims):
        c = plt.load(coeffs_ref.at[pl.ds(d * n_spots_pad + s0, spot_block)])
        term = c[:, None] * basis_rows[d][None, :]
        phase = term if phase is None else phase + term
    return phase


# Three-part Cody-Waite split of pi/2 (the first two parts have short
# mantissas, so q * part is exact for |q| < 2^15) and the minimax sin/cos
# polynomials on [-pi/4, pi/4] (Cephes sinf/cosf).
_PIO2 = (1.5703125, 4.837512969970703e-4, 7.549789954891882e-8)
_SIN = (-1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4)
_COS = (4.166664568298827e-2, -1.388731625493765e-3, 2.443315711809948e-5)


def _sincos(x):
    """``(cos x, sin x)`` from one shared quadrant reduction and two
    minimax polynomials (about 1e-7 absolute error for ``|x| < 1e4``).
    In the same H100 sweep this ran each kernel about 27% faster than
    ``jnp.cos``/``jnp.sin``, which lower to two libdevice calls with a
    reduction each."""
    q = jnp.floor(x * (2 / np.pi) + 0.5)
    r = ((x - q * _PIO2[0]) - q * _PIO2[1]) - q * _PIO2[2]
    r2 = r * r
    s = r + r * r2 * (_SIN[0] + r2 * (_SIN[1] + r2 * _SIN[2]))
    c = 1.0 - 0.5 * r2 + r2 * r2 * (_COS[0] + r2 * (_COS[1] + r2 * _COS[2]))
    quadrant = q - 4.0 * jnp.floor(q * 0.25)  # 0, 1, 2 or 3
    odd = (quadrant == 1.0) | (quadrant == 3.0)
    sin = jnp.where(odd, c, s)
    cos = jnp.where(odd, s, c)
    sin = jnp.where(quadrant >= 2.0, -sin, sin)
    cos = jnp.where((quadrant == 1.0) | (quadrant == 2.0), -cos, cos)
    return cos, sin


def _load_basis_rows(basis_ref, p0, valid, n_dims, n_pixels, pixel_block):
    return [
        plt.load(
            basis_ref.at[pl.ds(d * n_pixels + p0, pixel_block)],
            mask=valid, other=0.0,
        )
        for d in range(n_dims)
    ]


def _f2n_kernel(coeffs_ref, ffr_ref, ffi_ref, basis_ref, outr_ref, outi_ref,
                *, n_dims, n_pixels, n_spots_pad, spot_block, pixel_block):
    """One pixel block of ``nf[p] = sum_s ff[s] e^{i phase[s, p]}``. The
    loop over spot blocks accumulates whole ``(S, T)`` tiles; the sum
    over the spot axis runs once, after it."""
    p0 = pl.program_id(0) * pixel_block
    valid = p0 + jnp.arange(pixel_block) < n_pixels
    rows = _load_basis_rows(basis_ref, p0, valid, n_dims, n_pixels, pixel_block)

    def body(i, acc):
        re, im = acc
        s0 = i * spot_block
        phase = _phase_tile(coeffs_ref, s0, rows, n_dims, n_spots_pad, spot_block)
        cos, sin = _sincos(phase)
        fr = plt.load(ffr_ref.at[pl.ds(s0, spot_block)])[:, None]
        fi = plt.load(ffi_ref.at[pl.ds(s0, spot_block)])[:, None]
        return re + (fr * cos - fi * sin), im + (fr * sin + fi * cos)

    zero = jnp.zeros((spot_block, pixel_block), jnp.float32)
    re, im = jax.lax.fori_loop(0, n_spots_pad // spot_block, body, (zero, zero))
    plt.store(outr_ref.at[pl.ds(p0, pixel_block)], jnp.sum(re, axis=0), mask=valid)
    plt.store(outi_ref.at[pl.ds(p0, pixel_block)], jnp.sum(im, axis=0), mask=valid)


def _n2f_kernel(coeffs_ref, nfr_ref, nfi_ref, basis_ref, outr_ref, outi_ref,
                *, n_dims, n_pixels, n_spots_pad, spot_block, pixel_block,
                group):
    """One (pixel group, spot block) partial of
    ``ff[s] = sum_p conj(e^{i phase[s, p]}) nf[p]``, accumulated as
    ``(S, T)`` tiles and summed over pixels once at the end."""
    g = pl.program_id(0)
    s0 = pl.program_id(1) * spot_block

    def body(k, acc):
        re, im = acc
        p0 = (g * group + k) * pixel_block
        valid = p0 + jnp.arange(pixel_block) < n_pixels
        rows = _load_basis_rows(
            basis_ref, p0, valid, n_dims, n_pixels, pixel_block
        )
        phase = _phase_tile(coeffs_ref, s0, rows, n_dims, n_spots_pad, spot_block)
        cos, sin = _sincos(phase)
        # Masked pixels load a zero field, so they add nothing.
        nr = plt.load(nfr_ref.at[pl.ds(p0, pixel_block)], mask=valid, other=0.0)
        ni = plt.load(nfi_ref.at[pl.ds(p0, pixel_block)], mask=valid, other=0.0)
        nr, ni = nr[None, :], ni[None, :]
        return re + (cos * nr + sin * ni), im + (cos * ni - sin * nr)

    zero = jnp.zeros((spot_block, pixel_block), jnp.float32)
    re, im = jax.lax.fori_loop(0, group, body, (zero, zero))
    out = pl.ds(g * n_spots_pad + s0, spot_block)
    plt.store(outr_ref.at[out], jnp.sum(re, axis=1))
    plt.store(outi_ref.at[out], jnp.sum(im, axis=1))


def _flat_operands(coeffs, basis, n_spots, spot_block):
    """Zero-pad the spot axis to a whole number of blocks (zero
    coefficients and a zero farfield make pad spots contribute nothing)
    and flatten the stacks so every kernel load is a 1D slice."""
    n_spots_pad = -(-n_spots // spot_block) * spot_block
    coeffs = _pad_axis(coeffs.astype(jnp.float32), n_spots_pad, 1)
    return coeffs.reshape(-1), basis.astype(jnp.float32).reshape(-1), n_spots_pad


@functools.partial(
    jax.jit,
    static_argnames=("n_spots", "spot_block", "pixel_block", "num_warps",
                     "interpret"),
)
def farfield_to_nearfield_raw(ff_re, ff_im, coeffs, basis, n_spots, *,
                              spot_block=SPOT_BLOCK, pixel_block=PIXEL_BLOCK,
                              num_warps=NUM_WARPS, interpret=False):
    """Unscaled expansion ``sum_s ff[s] e^{i phase[s, p]}`` of the
    ``(N,)`` farfield onto the ``(P,)`` nearfield (re/im pair)."""
    D, P = basis.shape
    S = _spot_block(n_spots, spot_block)
    coeffs_f, basis_f, n_spots_pad = _flat_operands(coeffs, basis, n_spots, S)
    ffr = _pad_axis(ff_re.astype(jnp.float32), n_spots_pad, 0)
    ffi = _pad_axis(ff_im.astype(jnp.float32), n_spots_pad, 0)
    kernel = functools.partial(
        _f2n_kernel, n_dims=D, n_pixels=P, n_spots_pad=n_spots_pad,
        spot_block=S, pixel_block=pixel_block,
    )
    out = jax.ShapeDtypeStruct((P,), jnp.float32)
    return pl.pallas_call(
        kernel,
        out_shape=(out, out),
        grid=(pl.cdiv(P, pixel_block),),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="compressed_f2n",
    )(coeffs_f, ffr, ffi, basis_f)


@functools.partial(
    jax.jit,
    static_argnames=("n_spots", "spot_block", "pixel_block", "group",
                     "num_warps", "interpret"),
)
def nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis, n_spots, *,
                              spot_block=SPOT_BLOCK, pixel_block=PIXEL_BLOCK,
                              group=N2F_GROUP, num_warps=NUM_WARPS,
                              interpret=False):
    """Unscaled conjugate-overlap reduction of the ``(P,)`` nearfield
    onto ``(N,)`` spot amplitudes (re/im pair)."""
    D, P = basis.shape
    S = _spot_block(n_spots, spot_block)
    coeffs_f, basis_f, n_spots_pad = _flat_operands(coeffs, basis, n_spots, S)
    n_groups = pl.cdiv(pl.cdiv(P, pixel_block), group)
    kernel = functools.partial(
        _n2f_kernel, n_dims=D, n_pixels=P, n_spots_pad=n_spots_pad,
        spot_block=S, pixel_block=pixel_block, group=group,
    )
    out = jax.ShapeDtypeStruct((n_groups * n_spots_pad,), jnp.float32)
    part_r, part_i = pl.pallas_call(
        kernel,
        out_shape=(out, out),
        grid=(n_groups, n_spots_pad // S),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="compressed_n2f",
    )(coeffs_f, nf_re.astype(jnp.float32), nf_im.astype(jnp.float32), basis_f)
    ff_re = part_r.reshape(n_groups, n_spots_pad).sum(axis=0)[:n_spots]
    ff_im = part_i.reshape(n_groups, n_spots_pad).sum(axis=0)[:n_spots]
    return ff_re, ff_im


def farfield_to_nearfield(ff_re, ff_im, coeffs, basis, n_spots,
                          interpret=False):
    """Kernel twin of :meth:`ops.compressed.farfield_to_nearfield`."""
    scale = 1.0 / np.sqrt(basis.shape[1])
    re, im = farfield_to_nearfield_raw(
        ff_re, ff_im, coeffs, basis, n_spots, interpret=interpret
    )
    return re * scale, im * scale


def nearfield_to_farfield(nf_re, nf_im, coeffs, basis, n_spots,
                          interpret=False):
    """Kernel twin of :meth:`ops.compressed.nearfield_to_farfield`
    (normalized to unit norm)."""
    ff_re, ff_im = nearfield_to_farfield_raw(
        nf_re, nf_im, coeffs, basis, n_spots, interpret=interpret
    )
    norm = jnp.sqrt(jnp.sum(jnp.square(ff_re) + jnp.square(ff_im)))
    return ff_re / norm, ff_im / norm


def fused_iteration(ff_re, ff_im, coeffs, basis, amp, n_spots,
                    interpret=False):
    """
    One compressed transform round trip ``ff' -> nf -> amp*nf/|nf| ->
    ff_next`` through the two kernels, with the amplitude replacement in
    between. ``amp`` is a scalar or a flattened ``(P,)`` source
    amplitude. Returns the UNNORMALIZED next-farfield pair (the caller's
    epilogue normalizes, so the kernels' scales drop out).
    """
    from slmsuite_tpu.ops.compressed import _amp_replace

    re, im = farfield_to_nearfield_raw(
        ff_re, ff_im, coeffs, basis, n_spots, interpret=interpret
    )
    scalar_amp = jnp.ndim(amp) == 0
    ur, ui = _amp_replace(re, im, None if scalar_amp else amp, 1.0, scalar_amp)
    return nearfield_to_farfield_raw(
        ur, ui, coeffs, basis, n_spots, interpret=interpret
    )
