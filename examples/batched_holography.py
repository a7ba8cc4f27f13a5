"""
Batched holography: many independent holograms in one device program.

A feature beyond the reference: a movie of tweezer-rearrangement
frames (or a parameter scan) optimizes as ONE vmapped scan —
:func:`~slmsuite_tpu.holography.algorithms.optimize_batch` — instead of
K sequential ``optimize`` calls. Over a multi-chip mesh the batch axis
shards with zero collectives.
"""

import time

import numpy as np

from _rig import save_figure

from slmsuite_tpu.holography.algorithms import Hologram, optimize_batch


def frame_target(shape, t, n_spots=5, seed=0):
    """Spot array rotating with frame index ``t`` (a tweezer movie)."""
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.15, 0.35, n_spots) * shape[0]
    phases = rng.uniform(0, 2 * np.pi, n_spots)
    target = np.zeros(shape, np.float32)
    for r, p0 in zip(radii, phases):
        y = int(shape[0] / 2 + r * np.sin(p0 + 0.15 * t))
        x = int(shape[1] / 2 + r * np.cos(p0 + 0.15 * t))
        target[y, x] = 1.0
    return target / np.sqrt((target**2).sum())


def main():
    shape = (256, 256)
    n_frames = 8

    # --- Build the movie frames (independent holograms). -------------------
    rng = np.random.default_rng(1)
    phase0 = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    frames = []
    for t in range(n_frames):
        h = Hologram(frame_target(shape, t), slm_shape=shape)
        h.reset_phase(phase0)  # Warm start all frames identically.
        frames.append(h)

    # --- One vmapped program advances every frame. --------------------------
    t0 = time.perf_counter()
    optimize_batch(
        frames, "WGS-Kim", maxiter=20, verbose=False,
        stat_groups=["computational"],
    )
    t_batch = time.perf_counter() - t0
    effs = [
        h.stats["stats"]["computational"]["efficiency"][-1] for h in frames
    ]
    print(f"  {n_frames} frames x 20 iters in {t_batch:.2f}s "
          f"(efficiency {min(effs):.3f}-{max(effs):.3f})")

    # --- Compare against the sequential loop. --------------------------------
    solo = Hologram(frame_target(shape, 0), slm_shape=shape)
    solo.reset_phase(phase0)
    t0 = time.perf_counter()
    solo.optimize("WGS-Kim", maxiter=20, verbose=False,
                  stat_groups=["computational"])
    t_solo = time.perf_counter() - t0
    print(f"  sequential single frame: {t_solo:.2f}s "
          f"(batch amortizes dispatch {n_frames * t_solo / t_batch:.1f}x)")

    frames[0].plot_farfield(title="Frame 0")
    save_figure("batched_frame0.png")
    frames[-1].plot_farfield(title=f"Frame {n_frames - 1}")
    save_figure("batched_frame_last.png")

    # On a multi-chip slice, shard the batch (no collectives):
    #   from slmsuite_tpu.parallel import make_mesh
    #   optimize_batch(frames, "WGS-Kim", maxiter=20,
    #                  mesh=make_mesh(axis_names=("data",)))


if __name__ == "__main__":
    main()
