"""
Native (C) runtime components, loaded via ctypes.

The device compute path is jax/XLA/Pallas; these C kernels cover host-side
hot loops around it — the frame-rate SLM write-path conversion
(:mod:`phase2gray`) and the TI PLM electrode packing (:mod:`plm_pack`).
Compiled on demand with the system compiler and cached next to the
source; everything degrades gracefully to numpy if no compiler is
available.
"""

import ctypes
import os
import subprocess
import sysconfig
import warnings

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIBS = {}


def _build_library(stem):
    """Compile ``<stem>.c`` to a shared library (mtime-cached)."""
    source = os.path.join(_HERE, stem + ".c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    target = os.path.join(_HERE, "_" + stem + suffix)

    if os.path.exists(target) and os.path.getmtime(target) >= os.path.getmtime(source):
        return target

    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O3", "-shared", "-fPIC", "-o", target, source, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    return target


def _get_library(stem, declare):
    """Load (building if needed) a native library, or None. ``declare``
    receives the loaded CDLL to set up prototypes (called once)."""
    if stem in _LIBS:
        return _LIBS[stem]
    try:
        lib = ctypes.CDLL(_build_library(stem))
        declare(lib)
    except Exception as err:
        warnings.warn(f"Native {stem} unavailable ({err}); using numpy.")
        lib = None
    _LIBS[stem] = lib
    return lib


def _declare_phase2gray(lib):
    for name, phase_t, disp_t in [
        ("phase2gray_u8", ctypes.c_double, ctypes.c_uint8),
        ("phase2gray_u16", ctypes.c_double, ctypes.c_uint16),
        ("phase2gray_f32_u8", ctypes.c_float, ctypes.c_uint8),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(phase_t),
            ctypes.POINTER(disp_t),
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        fn.restype = None


def _declare_plm_pack(lib):
    lib.plm_electrode_map.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # display
        ctypes.POINTER(ctypes.c_uint8),  # out
        ctypes.c_size_t, ctypes.c_size_t,  # h, w
        ctypes.POINTER(ctypes.c_uint8),  # lut[256]
        ctypes.POINTER(ctypes.c_uint8),  # layout[4]
        ctypes.c_int, ctypes.c_int,      # flips
    ]
    lib.plm_electrode_map.restype = None
    lib.plm_bitpack8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    lib.plm_bitpack8.restype = None


def _u8ptr(array):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def phase2gray_native(phase, out, bitresolution):
    """
    Single-pass ``phase`` (radians) -> integer ``out`` conversion for
    power-of-two ``bitresolution`` and ``phase_scaling == 1``.

    Returns ``True`` on success, ``False`` if the native path is
    unavailable or unsupported for these dtypes (caller falls back).
    """
    lib = _get_library("phase2gray", _declare_phase2gray)
    if lib is None:
        return False
    if bitresolution & (bitresolution - 1):
        return False
    if not (phase.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
        return False

    n = phase.size
    if phase.dtype == np.float64 and out.dtype == np.uint8:
        lib.phase2gray_u8(
            phase.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _u8ptr(out), n, bitresolution,
        )
    elif phase.dtype == np.float64 and out.dtype == np.uint16:
        lib.phase2gray_u16(
            phase.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            n, bitresolution,
        )
    elif phase.dtype == np.float32 and out.dtype == np.uint8:
        lib.phase2gray_f32_u8(
            phase.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _u8ptr(out), n, bitresolution,
        )
    else:
        return False
    return True


def plm_electrode_map_native(display, out, lut, layout, flip_y, flip_x):
    """
    Fused PLM packing: 8-bit gray ``display`` (H, W) through the
    gray->code ``lut`` onto the (2H, 2W) binary electrode bitmap ``out``
    in one pass (LUT gather + bit spread + scan flips). Returns ``True``
    on success; ``False`` means fall back to numpy.
    """
    lib = _get_library("plm_pack", _declare_plm_pack)
    if lib is None:
        return False
    if display.dtype != np.uint8 or out.dtype != np.uint8:
        return False
    if not (display.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
        return False
    h, w = display.shape
    if out.shape != (2 * h, 2 * w):
        return False
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    layout = np.ascontiguousarray(np.asarray(layout).ravel(), dtype=np.uint8)
    if lut.size != 256 or layout.size != 4:
        return False
    lib.plm_electrode_map(
        _u8ptr(display), _u8ptr(out), h, w, _u8ptr(lut), _u8ptr(layout),
        int(flip_y), int(flip_x),
    )
    return True


def plm_bitpack8_native(maps, out):
    """
    Pack 8 stacked binary bitmaps (8, H, W) into one uint8 frame (LSB of
    bitmap k -> bit k). Returns ``True`` on success.
    """
    lib = _get_library("plm_pack", _declare_plm_pack)
    if lib is None:
        return False
    if maps.dtype != np.uint8 or out.dtype != np.uint8:
        return False
    if maps.ndim != 3 or maps.shape[0] != 8 or maps.shape[1:] != out.shape:
        return False
    if not (maps.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
        return False
    lib.plm_bitpack8(_u8ptr(maps), _u8ptr(out), out.size)
    return True
