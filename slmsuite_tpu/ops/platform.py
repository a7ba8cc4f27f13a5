"""
The one place that names the accelerator.

Every choice of kernel, FFT tier or default that depends on the machine
goes through :func:`accelerator`. Code compares its result with the
platforms it has a path for (``"gpu"``); any other platform, known or
not, gets the plain XLA path: no kernel, no assumed peak, no assumed
memory size.
"""

import jax


def accelerator():
    """Name of the default JAX backend: ``"cpu"``, ``"gpu"``, or the
    backend's own name for a platform this package has no path for."""
    return jax.default_backend()
