r"""
Iterative phase-retrieval holography on JAX accelerators.

Class hierarchy (parity: reference ``algorithms/__init__.py:39-59``):

- :class:`Hologram` — core DFT GS/WGS/CG phase retrieval.
- :class:`FeedbackHologram` — adds camera-in-the-loop feedback.
- :class:`SpotHologram` — DFT-based optical focus arrays.
- :class:`CompressedSpotHologram` — grid-free (Zernike-basis) spot arrays.
- :class:`MultiplaneHologram` — several holograms sharing one nearfield.
- :func:`optimize_batch` — K *independent* holograms advanced in
  lockstep through one vmapped device program (beyond the reference).
"""

from slmsuite_tpu.holography.algorithms._header import (  # noqa: F401
    ALGORITHM_DEFAULTS,
    ALGORITHM_INDEX,
    FEEDBACK_OPTIONS,
)
from slmsuite_tpu.holography.algorithms._hologram import Hologram  # noqa: F401

__all__ = [
    "ALGORITHM_DEFAULTS",
    "ALGORITHM_INDEX",
    "FEEDBACK_OPTIONS",
    "Hologram",
]

try:  # Subclasses land as their modules are built.
    from slmsuite_tpu.holography.algorithms._feedback import FeedbackHologram  # noqa: F401

    __all__.append("FeedbackHologram")
except ImportError:
    pass

try:
    from slmsuite_tpu.holography.algorithms._spots import (  # noqa: F401
        CompressedSpotHologram,
        SpotHologram,
    )

    __all__ += ["SpotHologram", "CompressedSpotHologram"]
except ImportError:
    pass

try:
    from slmsuite_tpu.holography.algorithms._multiplane import MultiplaneHologram  # noqa: F401

    __all__.append("MultiplaneHologram")
except ImportError:
    pass

from slmsuite_tpu.holography.algorithms._batch import optimize_batch  # noqa: F401

__all__.append("optimize_batch")
