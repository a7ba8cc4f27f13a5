"""
Compute primitives (jit/Pallas): the shift-free centered-FFT pair, WGS
weight-update rules, device-side statistics, the scanned GS engine, and
compressed Zernike spot transforms.
"""

from slmsuite_tpu.ops.propagation import (  # noqa: F401
    build_folded_nearfield,
    extract_folded_phase,
    farfield_to_nearfield,
    fold_phase,
    nearfield_to_farfield,
    pad_window_slices,
    unfold_phase,
)
from slmsuite_tpu.ops.weights import ALGORITHM_INDEX, update_weights_generic  # noqa: F401
from slmsuite_tpu.ops.stats import calculate_stats, calculate_stats_numpy  # noqa: F401
