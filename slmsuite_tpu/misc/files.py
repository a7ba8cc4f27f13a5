"""
File helpers: auto-numbered save paths and dict <-> HDF5 round-trips.

Parity: reference ``slmsuite/holography/analysis/files.py:68-286`` (the
reference also re-exports these from ``slmsuite/misc/files.py``; here the
canonical home is ``slmsuite_tpu.misc.files`` with a re-export from
``slmsuite_tpu.holography.analysis.files``).
"""

import os
import re
import warnings

import numpy as np

__all__ = [
    "generate_path",
    "latest_path",
    "save_image",
    "load_h5",
    "save_h5",
    "read_h5",
    "write_h5",
]


def _scan_numeric_ids(path, name, extension=None, kind="file", digit_count=5):
    """Return the largest numeric id among ``path/name_#####[.ext]`` entries, or -1."""
    if not os.path.isdir(path):
        return -1

    pattern = re.escape(name) + r"_(\d{" + str(int(digit_count)) + r"})"
    if kind == "file" and extension is not None:
        pattern += re.escape("." + extension)
    pattern += r"$"
    regex = re.compile(pattern)

    best = -1
    for entry in os.listdir(path):
        full = os.path.join(path, entry)
        if kind == "dir" and not os.path.isdir(full):
            continue
        if kind == "file" and not os.path.isfile(full):
            continue
        match = regex.match(entry)
        if match:
            best = max(best, int(match.group(1)))
    return best


def generate_path(path, name, extension=None, kind="file", digit_count=5, path_count=1):
    """
    Generate (and for directories, create) a fresh auto-numbered path like
    ``path/name_00001.extension``, one greater than the largest existing id.

    Parameters
    ----------
    path : str
        Parent directory (created if missing).
    name : str
        Base name; should not contain underscores.
    extension : str OR None
        File extension without the dot.
    kind : {"file", "dir"}
        Whether to produce a file path or create a directory.
    digit_count : int
        Zero-padding width of the numeric id.
    path_count : int
        Number of consecutive paths to return (files only). When 1, a single
        string is returned; otherwise a list.

    Returns
    -------
    str OR list of str
    """
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)

    start = _scan_numeric_ids(path, name, extension, kind, digit_count) + 1

    def build(numeric_id):
        stem = "{}_{:0{}d}".format(name, numeric_id, int(digit_count))
        if kind == "file" and extension is not None:
            stem += "." + extension
        return os.path.join(path, stem)

    if kind == "dir":
        result = build(start)
        os.makedirs(result)
        return result

    if path_count == 1:
        return build(start)
    return [build(start + i) for i in range(path_count)]


def latest_path(path, name, extension=None, kind="file", digit_count=5):
    """
    Return the existing auto-numbered path with the greatest id, or ``None``.
    See :meth:`generate_path` for parameters.
    """
    best = _scan_numeric_ids(os.path.abspath(path), name, extension, kind, digit_count)
    if best < 0:
        return None
    stem = "{}_{:0{}d}".format(name, best, int(digit_count))
    if kind == "file" and extension is not None:
        stem += "." + extension
    return os.path.join(os.path.abspath(path), stem)


def load_h5(file_path, decode_bytes=True):
    """
    Load an HDF5 file into a (possibly nested) dictionary.

    Parameters
    ----------
    file_path : str
        Path of the file to read.
    decode_bytes : bool
        Decode ``bytes`` scalars/arrays back into ``str``.

    Returns
    -------
    dict
    """
    import h5py

    def visit(group):
        out = {}
        for key, item in group.items():
            if isinstance(item, h5py.Group):
                out[key] = visit(item)
                continue
            value = item[()]
            if decode_bytes:
                if isinstance(value, bytes):
                    value = value.decode()
                elif (
                    isinstance(value, np.ndarray)
                    and value.size > 0
                    and isinstance(value.reshape(-1)[0], bytes)
                ):
                    value = np.vectorize(bytes.decode)(value)
            out[key] = value
        return out

    with h5py.File(file_path, "r") as handle:
        return visit(handle)


def save_h5(file_path, data, mode="w"):
    """
    Save a (possibly nested) dictionary into an HDF5 file.

    Supported leaf types: uniform numeric/string arrays, scalars, ``str``
    (stored as utf-8 bytes), and ``None`` (stored as ``False``).

    Parameters
    ----------
    file_path : str
        Path of the file to write.
    data : dict
        Data to store; nested dicts become HDF5 groups.
    mode : str
        h5py file mode (default overwrite).
    """
    import h5py

    def visit(group, mapping):
        for key, value in mapping.items():
            if isinstance(value, dict):
                visit(group.create_group(key), value)
            elif isinstance(value, str):
                group[key] = value.encode("utf-8")
            elif value is None:
                group[key] = False
            else:
                try:
                    array = np.asarray(value)
                except Exception as err:
                    raise ValueError(
                        "save_h5() requires uniform array-like leaves; "
                        f"could not convert key '{key}': {err}"
                    )
                if array.dtype.kind == "U":
                    array = np.vectorize(str.encode)(array)
                if array.dtype == object:
                    raise ValueError(
                        f"save_h5() does not support object arrays (key '{key}'); "
                        "arrays must be uniform."
                    )
                group[key] = array

    with h5py.File(file_path, mode) as handle:
        visit(handle, data)


def read_h5(file_path, decode_bytes=True):
    """Backwards-compatible alias of :meth:`load_h5`."""
    return load_h5(file_path, decode_bytes)


def write_h5(file_path, data, mode="w"):
    """Backwards-compatible alias of :meth:`save_h5`."""
    return save_h5(file_path, data, mode)


# ----------------------------------------------------------------------
# Image export (ref analysis/files.py:287-463).
# ----------------------------------------------------------------------

def _load_image(path, shape, target_shape=None, angle=0, shift=(-225, -170)):
    """
    Load a grayscale image as a padded amplitude target (example helper).

    The image is dark-majority-normalized (inverted if mostly bright),
    optionally rotated and zoomed to ``target_shape``, square-rooted into
    amplitude, padded to ``shape``, and rolled by ``shift``.
    """
    import cv2
    from scipy import ndimage

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"Image not found at path '{path}'.")

    if np.mean(img) > 255 / 2:
        img = 255 - img
    if angle != 0:
        img = ndimage.rotate(img, angle)
    if target_shape is not None:
        zoom = min(
            target_shape[0] / img.shape[0], target_shape[1] / img.shape[1]
        )
        img = ndimage.zoom(img, zoom)

    from slmsuite_tpu.holography.toolbox import pad

    target = pad(np.sqrt(np.clip(img, 0, None)), shape)
    return np.roll(target, shift, axis=(0, 1))


def _gray2rgb(images, cmap=False, lut=None, normalize=True, border=None):
    """
    Convert a stack of grayscale images to ``(N, h, w, 4)`` RGBA uint8
    via a matplotlib colormap. ``np.nan`` pixels become transparent;
    ``border`` paints the one-pixel frame with the given color.
    """
    import matplotlib as mpl

    images = np.array(images, copy=True)
    if images.ndim == 2:
        images = images[None]
    elif images.ndim >= 3 and images.shape[-1] in (3, 4):
        return images  # Already color.
    elif images.ndim > 3:
        raise RuntimeError(f"Images shape {images.shape} could not be parsed.")

    isfloat = np.issubdtype(images.dtype, np.floating)
    if cmap == "default":
        cmap = True
    if cmap == "grayscale":
        cmap = False
    if not isinstance(cmap, str) and not hasattr(cmap, "N"):
        if cmap is True:
            cmap = mpl.rcParams["image.cmap"]
        elif lut is None or lut > 256:
            lut = 256  # Grayscale output is 8-bit.

    if lut is None:
        lut = mpl.rcParams["image.lut"] - 1 if isfloat else np.nanmax(images)
    lut = float(lut)

    nanmask = np.isnan(images) if isfloat else None
    if nanmask is not None and nanmask.any():
        images = np.where(nanmask, 0, images)
    else:
        nanmask = None

    scale = (lut - 1) / max(float(np.max(images)), 1e-30) if normalize else (
        (lut - 1) if isfloat else 1.0
    )
    indexed = np.clip(np.rint(images * scale), 0, int(lut)).astype(int)

    if isinstance(cmap, str) or hasattr(cmap, "N"):
        import matplotlib.pyplot as plt

        colormap = plt.get_cmap(cmap, int(lut) + 1) if isinstance(cmap, str) else cmap
        colors = getattr(colormap, "colors", None)
        if colors is None:
            colors = colormap(np.arange(colormap.N))
        rgba = (255 * np.asarray(colors)[indexed]).astype(np.uint8)
    else:
        gray = np.clip(indexed * (255 / lut), 0, 255).astype(np.uint8)
        rgba = np.stack(
            [gray, gray, gray, np.full_like(gray, 255)], axis=-1
        )
    if nanmask is not None:
        rgba[nanmask, 3] = 0

    if border is not None:
        border = [border] if np.isscalar(border) else list(border)
        n = len(border)
        rgba[:, 0, :, :n] = border
        rgba[:, -1, :, :n] = border
        rgba[:, :, 0, :n] = border
        rgba[:, :, -1, :n] = border
    return rgba


def save_image(
    file_path, images, cmap=False, lut=None, normalize=True, border=None, **kwargs
):
    """
    Save grayscale image(s) through :mod:`imageio` with matplotlib
    colormapping; a stack becomes a video/animation (e.g. ``.gif``).
    ``.gif`` files are size-optimized if :mod:`pygifsicle` is installed.
    """
    rgba = _gray2rgb(images, cmap=cmap, lut=lut, normalize=normalize, border=border)

    try:
        from imageio import imsave, mimsave
    except ImportError:
        raise ValueError("imageio is required for save_image().")

    if rgba.shape[0] == 1:
        imsave(file_path, rgba[0], **kwargs)
    else:
        mimsave(file_path, rgba, **kwargs)

    if file_path.rsplit(".", 1)[-1] == "gif":
        try:
            from pygifsicle import optimize

            optimize(file_path)
        except ImportError:
            pass
        except Exception as err:
            warnings.warn(f"pygifsicle optimization failed: {err}")
