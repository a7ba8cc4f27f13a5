"""
slmsuite-tpu: spatial light modulator control and computational
holography, built on JAX / XLA / Pallas.

Capability parity target: ``slmsuite`` v0.4.1 (see SURVEY.md at the repo
root for the component inventory this package rebuilds on JAX).
"""

__version__ = "0.1.0"

# Convenience namespace imports (kept lazy-light: these pull in jax).
from slmsuite_tpu import misc  # noqa: F401
