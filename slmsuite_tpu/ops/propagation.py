r"""
Shift-free centered Fourier propagation.

The reference computes the centered transform as
``fftshift(fft2(fftshift(x)))`` (``_hologram.py:1038-1073``) — four full
memory reorderings per GS iteration on top of the FFTs. The loop is
bound by device-memory bandwidth, so we eliminate them algebraically.

**The identity.** For even dimensions, with :math:`C_{ij} = (-1)^{i+j}`
(the checkerboard) and :math:`s = (-1)^{(H+W)/2}`:

.. math::
    \text{fftshift}(\text{fft2}(\text{fftshift}(x)))
    \;=\; s \, C \odot \text{fft2}(C \odot x)

elementwise — no reordering. The same identity holds for the inverse.

**The fold.** Running the GS loop through this identity, every
checkerboard cancels:

- Farfield: the amplitude constraint only uses ``angle(FF)`` and
  multiplies by real weights, so ``|fft2(C ⊙ NF)|`` *is* the
  centered-layout farfield amplitude, and centered-layout weights/target
  apply directly to ``fft2`` output.
- Nearfield: carrying the *folded phase* :math:`\psi = \phi + \pi(i+j)`
  on the SLM window absorbs the input checkerboard, and the output
  checkerboard is reabsorbed on the next iteration.

The steady-state iteration is exactly::

    G    = fft2(Z)                       # centered-layout |G|, no shifts
    G'   = weights * exp(1j * theta)     # theta = angle(G) or fixed
    Z'   = ifft2(G')
    psi' = angle(Z'[window])             # refold amplitude next iteration

Only the user-facing conversions (:meth:`fold_phase` /
:meth:`unfold_phase`) and the complex farfield view apply the
:math:`\pm\pi` checkerboard and global sign.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pad_window_slices(shape, slm_shape):
    """
    Centered-pad window indices: returns ``(y0, y1, x0, x1)`` such that the
    ``slm_shape`` window sits centered in a ``shape`` canvas (floor-biased,
    matching reference ``toolbox.unpad``).
    """
    dh = (shape[0] - slm_shape[0]) / 2.0
    dw = (shape[1] - slm_shape[1]) / 2.0
    if dh < 0 or dw < 0:
        raise ValueError(f"slm_shape {slm_shape} larger than canvas {shape}")
    y0 = int(np.floor(dh))
    x0 = int(np.floor(dw))
    return (y0, y0 + slm_shape[0], x0, x0 + slm_shape[1])


def checkerboard(slm_shape, window_offset=(0, 0), dtype=np.float32):
    r"""
    The fold phase :math:`\pi \cdot ((i + j + o_y + o_x) \bmod 2)` on the SLM
    window, where the offset accounts for the window position in the canvas.
    Host-side (numpy): used only at user boundaries. Cached per
    shape/offset (host-in-the-loop paths fold every iteration) and
    returned read-only.
    """
    return _checkerboard_cached(
        tuple(int(v) for v in slm_shape),
        (int(window_offset[0]), int(window_offset[1])),
        np.dtype(dtype).str,
    )


@functools.lru_cache(maxsize=16)
def _checkerboard_cached(slm_shape, window_offset, dtype_str):
    parity = (window_offset[0] + window_offset[1]) % 2
    row = np.arange(slm_shape[1], dtype=np.int64)
    col = np.arange(slm_shape[0], dtype=np.int64)
    board = (np.pi * ((col[:, None] + row[None, :] + parity) % 2)).astype(
        np.dtype(dtype_str)
    )
    board.setflags(write=False)
    return board


def fold_phase(phase, shape):
    """User phase -> internal folded phase ``psi`` (adds the checkerboard pi's)."""
    phase = np.asarray(phase)
    y0, _, x0, _ = pad_window_slices(shape, phase.shape)
    return phase + checkerboard(phase.shape, (y0, x0), dtype=phase.dtype)


def unfold_phase(psi, shape):
    """Internal folded phase -> user phase (subtracts the checkerboard pi's)."""
    psi = np.asarray(psi)
    y0, _, x0, _ = pad_window_slices(shape, psi.shape)
    return psi - checkerboard(psi.shape, (y0, x0), dtype=psi.dtype)


def build_folded_nearfield(psi, amp, shape, kernel=None):
    """
    Scatter ``amp * exp(1j * (psi + kernel))`` into the center window of a
    zeros canvas of ``shape``. Pure/jit-friendly; XLA fuses the complex
    exponential into the pad write.
    """
    total = psi if kernel is None else psi + kernel
    window = amp * jnp.exp(1j * total).astype(jnp.complex64)

    y0, _, x0, _ = pad_window_slices(shape, psi.shape)
    canvas = jnp.zeros(shape, dtype=jnp.complex64)
    return jax.lax.dynamic_update_slice(canvas, window, (y0, x0))


def nearfield_to_farfield(folded_nearfield):
    """
    Forward propagation: orthonormal 2D FFT of the folded nearfield canvas
    (tier chosen by :mod:`slmsuite_tpu.ops.fft`).
    """
    from slmsuite_tpu.ops import fft as _fft

    return _fft.fft2(folded_nearfield, norm="ortho")


def farfield_to_nearfield(farfield):
    """Inverse propagation: orthonormal 2D IFFT."""
    from slmsuite_tpu.ops import fft as _fft

    return _fft.ifft2(farfield, norm="ortho")


def extract_folded_phase(folded_nearfield, slm_shape, kernel=None):
    """
    Pull the folded phase ``psi`` back out of the canvas window
    (minus the propagation ``kernel`` if present).
    """
    shape = folded_nearfield.shape
    y0, _, x0, _ = pad_window_slices(shape, slm_shape)
    window = jax.lax.dynamic_slice(folded_nearfield, (y0, x0), slm_shape)
    psi = jnp.arctan2(window.imag, window.real)
    if kernel is not None:
        psi = psi - kernel
    return psi


def farfield_sign(shape):
    """The global sign ``s = (-1)^((H+W)/2)`` of the folded basis (even dims)."""
    return -1.0 if ((shape[0] + shape[1]) // 2) % 2 else 1.0


def unfold_farfield(farfield_folded):
    """
    Convert the fft-output-layout complex farfield ``G = fft2(Z)`` into the
    true centered-layout complex farfield ``s * C ⊙ G``. Amplitudes are
    unchanged; only the phase pattern differs. Trace-time or host-side;
    for a device array outside jit use :meth:`unfold_farfield_device`.
    """
    H, W = farfield_folded.shape[-2:]
    xp = jnp if isinstance(farfield_folded, jnp.ndarray) else np
    iy = xp.arange(H).reshape(-1, 1)
    ix = xp.arange(W).reshape(1, -1)
    cb = 1.0 - 2.0 * ((iy + ix) % 2)
    return farfield_sign((H, W)) * cb * farfield_folded


unfold_farfield_device = jax.jit(unfold_farfield)


@functools.partial(jax.jit, static_argnames=("shape", "slm_shape"))
def compute_farfield(psi, amp, shape, slm_shape, kernel=None):
    """
    One-shot jitted forward propagation used by ``get_farfield`` and the
    simulated camera: folded phase + amplitude -> centered-layout complex
    farfield (device array; use :meth:`to_numpy_complex` before host use).
    """
    del slm_shape  # implied by psi; kept in signature for cache keying
    nearfield = build_folded_nearfield(psi, amp, shape, kernel)
    return unfold_farfield(nearfield_to_farfield(nearfield))


# --- Host-transfer helpers: complex arrays cross the host boundary as
# --- real pairs (split/combine).


@jax.jit
def _split_complex(z):
    return z.real, z.imag


def to_numpy_complex(z):
    """Fetch a device complex array as numpy via a real/imag split."""
    if isinstance(z, np.ndarray):
        return z
    re, im = _split_complex(z)
    return np.asarray(re) + 1j * np.asarray(im)


@functools.partial(jax.jit, static_argnames=("shape",))
def forward_fields(psi, amp, shape, kernel=None):
    """
    Jitted forward propagation for host-in-the-loop paths: returns the
    device complex farfield plus real (amp_ff, theta) for safe host fetch.
    """
    nearfield = build_folded_nearfield(psi, amp, shape, kernel)
    farfield = nearfield_to_farfield(nearfield)
    return farfield, jnp.abs(farfield), jnp.arctan2(farfield.imag, farfield.real)
