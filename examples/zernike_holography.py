"""
Zernike (grid-free) holography: 3D focus arrays with per-spot aberrations.

:class:`CompressedSpotHologram` represents each spot by its Zernike
coefficients — lateral position (tilt), depth (focus), and arbitrary
aberration terms — with no DFT grid at all. The near<->far transform is
a matmul kernel contraction; gradient (CG) polish runs through it
with ``jax.grad``. (Reference example: ``zernike_holography`` notebook.)
"""

import numpy as np

from _rig import make_rig

from slmsuite_tpu.holography.algorithms import CompressedSpotHologram


def main():
    fs = make_rig()

    # --- 1. A 3D spot lattice: (kx, ky, focal power). ---------------------
    print("3D spot lattice via WGS-Kim")
    kx, ky = np.meshgrid((-6e-3, 0, 6e-3), (-6e-3, 0, 6e-3))
    focus = np.linspace(-4e-6, 4e-6, kx.size)  # Different depth per spot.
    spots = np.vstack([kx.ravel(), ky.ravel(), focus])

    holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=fs)
    holo.optimize("WGS-Kim", maxiter=20, verbose=False)
    cv = np.std(holo.amp_ff) / np.mean(holo.amp_ff)
    print(f"  {len(holo)} spots, amplitude CV {cv:.4f}")

    # --- 2. Custom basis: add astigmatism + coma per spot. ----------------
    print("Custom Zernike basis (tilt + focus + astig + coma)")
    basis = [2, 1, 4, 3, 8]  # ANSI: x-tilt, y-tilt, focus, astig, coma.
    rng = np.random.default_rng(0)
    spots5 = np.vstack([
        rng.uniform(-5e-3, 5e-3, (2, 6)),     # Lateral.
        np.zeros((1, 6)),                     # Focus.
        rng.uniform(-0.3, 0.3, (2, 6)),       # Astigmatism, coma (rad).
    ])
    holo5 = CompressedSpotHologram(spots5, basis=basis, cameraslm=fs)
    holo5.optimize("WGS-Kim", maxiter=15, verbose=False)
    print(f"  converged, efficiency-normalized amps: "
          f"{np.array2string(holo5.amp_ff / np.max(holo5.amp_ff), precision=2)}")

    # --- 3. Gradient polish through the Zernike kernel. -------------------
    print("CG polish")
    holo.optimize("CG", maxiter=30, verbose=False,
                  optimizer_kwargs={"learning_rate": 0.2})
    print(f"  final loss {holo.flags['loss_result']:.2e}")


if __name__ == "__main__":
    main()
