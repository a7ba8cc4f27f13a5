"""
Multi-chip scale-out: device meshes, a distributed 2D FFT (all_to_all
transposes between the cards), and sharded batched hologram optimization.

The reference is single-device (SURVEY.md section 2.7); here the batch/
plane axis of holography shards over a ``"data"`` mesh axis and very
large fields decompose row/column-wise over a ``"space"`` axis.
"""

from slmsuite_tpu.parallel.mesh import make_mesh  # noqa: F401
from slmsuite_tpu.parallel.fft2d import distributed_fft2, distributed_ifft2  # noqa: F401
from slmsuite_tpu.parallel.multiplane import (  # noqa: F401
    make_batched_gs_step,
    run_batched_gs,
)
from slmsuite_tpu.parallel.plane import run_sharded_plane_gs  # noqa: F401
