"""
Multi-chip scale-out walkthrough (runs hardware-free on virtual devices).

Demonstrates the three mesh-sharded optimization paths through the
PUBLIC hologram classes — users never import ``slmsuite_tpu.parallel``
directly (though its engines are what runs underneath):

1. ``MultiplaneHologram.optimize(mesh=...)`` — planes data-parallel
   over a ``data`` axis (one psum of weighted nearfields per iteration).
2. ``CompressedSpotHologram.optimize(mesh=...)`` — the pixel axis
   sharded over the mesh (one (N,) psum per transform direction).
3. ``Hologram.optimize(mesh=...)`` — the full farfield plane row-sharded
   (giant-k-space holography; pencil FFT with ``all_to_all`` between
   the cards).

On a host with several GPUs just build the mesh from ``jax.devices()``. This
script self-provisions 8 VIRTUAL CPU devices so it runs anywhere —
shardings, collectives, and convergence are identical; only speed
differs. Mirrors what ``__graft_entry__.dryrun_multichip`` validates.
"""

import os

# Provision 8 virtual CPU devices BEFORE jax initializes (no-op if the
# environment already provides enough real devices).
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import numpy as np  # noqa: E402

from slmsuite_tpu.parallel import make_mesh  # noqa: E402


def multiplane_over_mesh(mesh):
    """Planes data-parallel: 8 focal planes across the devices."""
    from slmsuite_tpu.holography.algorithms import (
        Hologram,
        MultiplaneHologram,
    )

    N = 64
    children = []
    for b in range(8):
        target = np.zeros((N, N), np.float32)
        target[16 + (3 * b) % 32, 20 + (5 * b) % 24] = 1.0
        children.append(Hologram(target, slm_shape=(N, N)))
    np.random.seed(0)
    mp = MultiplaneHologram(children)
    mp.optimize(
        "WGS-Leonardo", maxiter=20, verbose=False, mesh=mesh,
        stat_groups=["computational"],
    )
    eff = [
        h.stats["stats"]["computational"]["efficiency"][-1] for h in children
    ]
    print(f"  multiplane over {mesh.shape}: mean plane efficiency "
          f"{np.mean(eff):.3f}")


def compressed_over_mesh(mesh):
    """Pixel-sharded grid-free 3D spots."""
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import CompressedSpotHologram

    slm = SimulatedSLM(resolution=(128, 128), pitch_um=(8, 8), wav_um=0.78)
    kx, ky = np.meshgrid(np.linspace(-8e-3, 8e-3, 4), np.linspace(-8e-3, 8e-3, 4))
    spots = np.vstack([
        kx.ravel(), ky.ravel(),
        np.random.default_rng(0).uniform(-2e-6, 2e-6, kx.size),
    ])
    np.random.seed(0)
    holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=slm)
    holo.optimize(
        "WGS-Kim", maxiter=20, verbose=False, mesh=mesh,
        stat_groups=["computational_spot"],
    )
    u = holo.stats["stats"]["computational_spot"]["uniformity"][-1]
    print(f"  compressed spots over {mesh.shape}: uniformity {u:.4f}")


def plane_over_mesh(mesh):
    """Row-sharded full-plane WGS (farfields beyond one chip)."""
    from slmsuite_tpu.holography.algorithms import Hologram

    N = 64
    target = np.zeros((N, N), np.float32)
    target[N // 2, N // 4] = target[N // 4, N // 2] = 1.0
    np.random.seed(0)
    holo = Hologram(target, slm_shape=(N, N))
    holo.optimize(
        "WGS-Leonardo", maxiter=20, verbose=False, mesh=mesh,
        stat_groups=["computational"],
    )
    eff = holo.stats["stats"]["computational"]["efficiency"][-1]
    print(f"  row-sharded plane over {mesh.shape}: efficiency {eff:.3f}")


def main():
    print(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}")

    print("1. Batched multiplane (data axis)")
    multiplane_over_mesh(make_mesh(axis_names=("data",)))

    print("2. Pixel-sharded compressed spots (pixels axis)")
    compressed_over_mesh(make_mesh(axis_names=("pixels",)))

    print("3. Row-sharded giant farfield (rows axis)")
    plane_over_mesh(make_mesh(axis_names=("rows",)))

    print("done")


if __name__ == "__main__":
    main()
