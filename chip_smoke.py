#!/usr/bin/env python
"""
Smoke test of the package on one NVIDIA GPU.

Runs the public entry points once at full size, in one process, and
checks each result against a plain reference written here (independent
of ``slmsuite_tpu.ops``):

(a) device: fails unless JAX's default device is a GPU; prints the card
    (``nvidia-smi`` name and power limit), the JAX version and
    ``XLA_FLAGS``.
(b) spot-array WGS-Kim, 2048^2 with 32x32 spots (the README quick start).
(c) MRAF ring image, 2048^2 (``models.image_mraf``).
(d) compressed 3D spots, 1024^2 SLM with 256 spots, ``cuda=True``.
(e) closed camera loop on the simulated rig.
(f) the tests marked ``gpu``, in this process.

``--multichip`` runs only the four mesh paths of
``__graft_entry__.run_multichip_paths`` over four GPUs at real sizes,
each checked against its single-device run.

Usage::

    python chip_smoke.py              # one GPU, phases (a)-(f)
    python chip_smoke.py --multichip  # four GPUs, mesh paths only

Every phase prints its measured error beside its tolerance. Any failure
exits non-zero. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Gates of phase (b)/(c). cuFFT computes the loop in float32, the
#: reference in float32 (jnp) and float64 (numpy).
FIRST_ITER_RTOL = 1e-5   # rel. L2 of the farfield amplitude, iteration 1
EFFICIENCY_ATOL = 5e-3   # final efficiency, library vs reference
UNIFORMITY_ATOL = 1e-3   # final uniformity, library vs reference
#: Gate of phase (d): one transform pair vs the dense reference kernel.
COMPRESSED_RTOL = 1e-4
#: Final compressed spot amplitudes (unit max), kernels vs jnp path: the
#: two sum in different orders, and 20 WGS iterations amplify the
#: float32 rounding.
COMPRESSED_AMP_ATOL = 2e-3


class SmokeFailure(AssertionError):
    pass


def check(name, err, tol, note=""):
    """Print ``err`` beside ``tol``; raise when it is not within."""
    ok = bool(np.isfinite(err) and err <= tol)
    print(f"  {name}: {err:.3e} (tolerance {tol:.1e}{', ' + note if note else ''})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{name}: {err:.3e} > {tol:.1e}")


def rel_l2(a, b):
    """Relative L2 error of ``a`` against ``b`` (real or complex)."""
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------------------
# Plain references: centered orthonormal FFTs, no folding, no scan.
# --------------------------------------------------------------------------


def _xp(use_numpy):
    if use_numpy:
        return np
    import jax.numpy as jnp

    return jnp


def reference_farfield(phase, amp, use_numpy=False):
    """``fftshift(fft2(amp e^{i phase}))`` (orthonormal). With
    ``use_numpy`` in float64."""
    xp = _xp(use_numpy)
    dtype = np.complex128 if use_numpy else np.complex64
    near = (amp * xp.exp(1j * xp.asarray(phase))).astype(dtype)
    return xp.fft.fftshift(xp.fft.fft2(near, norm="ortho"))


def reference_backward(farfield, use_numpy=False):
    """Phase of ``ifft2(ifftshift(farfield))``."""
    xp = _xp(use_numpy)
    near = xp.fft.ifft2(xp.fft.ifftshift(farfield), norm="ortho")
    return xp.angle(near)


def reference_stats(amp_ff, target, mask):
    """``(efficiency, uniformity)`` of a farfield amplitude against a
    target: the overlap efficiency ``(sum t f)^2 / (sum f^2 sum t^2)``
    and ``1 - (max - min) / (max + min)`` of ``f^2 / t^2`` over
    ``mask``."""
    f = np.asarray(amp_ff, np.float64)
    t = np.nan_to_num(np.asarray(target, np.float64))
    mask = np.asarray(mask, bool)
    efficiency = np.sum(t * f) ** 2 / (np.sum(f * f) * np.sum(t * t))
    ratio = (f[mask] / t[mask]) ** 2
    uniformity = 1 - (ratio.max() - ratio.min()) / (ratio.max() + ratio.min())
    return float(efficiency), float(uniformity)


def reference_wgs(phase0, amp, target, n_iterations, method="WGS-Kim",
                  feedback_exponent=0.8, fix_phase_iteration=10,
                  mraf_factor=None, use_numpy=False):
    """
    Plain WGS loop on the centered farfield. ``target`` may hold NaN
    (MRAF noise region: the free farfield scaled by ``mraf_factor``);
    zero-target pixels outside it are zeroed when ``mraf_factor`` is
    set. Leonardo/Kim weights ``w <- w (t/f)^p`` renormalized, from the
    second iteration on; Kim fixes the farfield phase after
    ``fix_phase_iteration`` iterations. Returns the final phase and the
    per-iteration ``(efficiency, uniformity)`` of the forward farfield.
    """
    xp = _xp(use_numpy)
    noise = np.isnan(target)
    clean = np.nan_to_num(target)
    signal = clean > 0
    weights = xp.asarray(clean)
    phase = xp.asarray(phase0)
    phase_ff = None
    stats = []
    for k in range(n_iterations):
        farfield = reference_farfield(phase, amp, use_numpy)
        amp_ff = xp.abs(farfield)
        stats.append(reference_stats(np.asarray(amp_ff), clean, signal))
        if k > 0:
            ratio = xp.where(signal, clean / xp.where(signal, amp_ff, 1.0), 1.0)
            weights = weights * ratio ** feedback_exponent
            weights = weights / xp.sqrt(xp.sum(weights * weights))
        theta = xp.angle(farfield)
        fixed = method == "WGS-Kim" and k >= fix_phase_iteration
        phase_ff = phase_ff if fixed else theta
        new_ff = weights * xp.exp(1j * phase_ff)
        if mraf_factor is not None:
            new_ff = xp.where(
                signal, new_ff, xp.where(noise, mraf_factor * farfield, 0.0)
            )
        phase = reference_backward(new_ff, use_numpy)
    return np.asarray(phase), stats


def reference_compressed_kernel(coeffs, basis):
    """Dense ``(N, P)`` transform kernel ``exp(i c^T B)`` at HIGHEST
    precision (2 GB at 256 spots x 1024^2 pixels)."""
    import jax
    import jax.numpy as jnp

    phase = jnp.einsum(
        "dn,dp->np", coeffs, basis, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.exp(1j * phase).astype(jnp.complex64)


def reference_compressed_pair(kernel, ff, nf):
    """Dense twins of the compressed transforms: ``nf = K^T ff / sqrt(P)``
    and the unit-normalized ``ff = conj(K) nf``."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    P = kernel.shape[1]
    near = jnp.matmul(ff, kernel, precision=hi) / np.sqrt(P)
    far = jnp.matmul(jnp.conj(kernel), nf, precision=hi)
    return near, far / jnp.linalg.norm(far)


# --------------------------------------------------------------------------
# Phases.
# --------------------------------------------------------------------------


def phase_device(n_devices):
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's default device is {dev.platform}")
    if len(devices) < n_devices:
        raise SmokeFailure(f"{n_devices} GPUs needed, {len(devices)} found")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"(a) device: {dev.device_kind} x{len(devices)}, jax {jax.__version__}")
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  nvidia-smi: {card}")
    from slmsuite_tpu.ops import fft

    print(f"  fft backend: {fft.get_fft_backend()}")
    return dev


def phase_spot_wgs(N=2048, maxiter=50, n_side=32, pitch=30, seed=1):
    """README quick start vs :func:`reference_wgs` from the same phase."""
    import jax

    from slmsuite_tpu.holography.algorithms import SpotHologram

    print(f"(b) spot-array WGS-Kim {N}^2, {n_side}x{n_side} spots, "
          f"{maxiter} iterations")
    phase0 = np.random.default_rng(seed).uniform(
        -np.pi, np.pi, (N, N)
    ).astype(np.float32)

    def run(n):
        holo = SpotHologram.make_rectangular_array(
            (N, N), array_shape=(n_side, n_side), array_pitch=(pitch, pitch),
            basis="knm",
        )
        holo.reset_phase(phase0)
        t0 = time.perf_counter()
        holo.optimize("WGS-Kim", maxiter=n, verbose=False,
                      stat_groups=["computational"])
        return holo, time.perf_counter() - t0

    holo, _ = run(1)
    target = np.asarray(holo.target)
    amp = float(holo.amp)
    with jax.default_matmul_precision("highest"):
        ref1, _ = reference_wgs(phase0, amp, target, 1, use_numpy=True)
    ff64 = np.abs(reference_farfield(ref1, amp, use_numpy=True))
    check("iteration-1 farfield amplitude vs float64 numpy (rel. L2)",
          rel_l2(holo.amp_ff, ff64), FIRST_ITER_RTOL, "float32 cuFFT")

    holo, seconds = run(maxiter)
    stats = holo.stats["stats"]["computational"]
    with jax.default_matmul_precision("highest"):
        _, ref_stats = reference_wgs(phase0, amp, target, maxiter)
    eff, unif = float(stats["efficiency"][-1]), float(stats["uniformity"][-1])
    print(f"  library: efficiency {eff:.5f}, uniformity {unif:.5f} "
          f"({seconds:.2f} s incl. compile)")
    print(f"  reference: efficiency {ref_stats[-1][0]:.5f}, "
          f"uniformity {ref_stats[-1][1]:.5f}")
    check("final efficiency vs reference", abs(eff - ref_stats[-1][0]),
          EFFICIENCY_ATOL)
    check("final uniformity vs reference", abs(unif - ref_stats[-1][1]),
          UNIFORMITY_ATOL)


def phase_mraf(N=2048, n_iterations=10):
    """``models.image_mraf`` vs :func:`reference_wgs` with MRAF."""
    import jax

    from slmsuite_tpu.models import image_mraf
    from slmsuite_tpu.ops.propagation import unfold_phase

    print(f"(c) MRAF ring image {N}^2 (WGS-Leonardo), {n_iterations} iterations")
    model = image_mraf(N=N, mraf_factor=0.5)
    phase0 = unfold_phase(np.asarray(model.phase0), (N, N))
    amp = float(model.consts["amp"])

    _, stats = model.run(n_iterations)
    stats = np.asarray(stats)[:, 0, :2]
    with jax.default_matmul_precision("highest"):
        _, ref_stats = reference_wgs(
            phase0, amp, model.target, n_iterations, method="WGS-Leonardo",
            mraf_factor=0.5,
        )
    ref_stats = np.asarray(ref_stats)
    print(f"  library: efficiency {stats[-1, 0]:.5f}, uniformity {stats[-1, 1]:.5f}")
    print(f"  reference: efficiency {ref_stats[-1, 0]:.5f}, "
          f"uniformity {ref_stats[-1, 1]:.5f}")
    check("efficiency vs reference (max over iterations)",
          float(np.abs(stats[:, 0] - ref_stats[:, 0]).max()), EFFICIENCY_ATOL)
    check("uniformity vs reference (max over iterations)",
          float(np.abs(stats[:, 1] - ref_stats[:, 1]).max()), UNIFORMITY_ATOL)


def compressed_spots(n_side=16, seed=0):
    """3D spot vectors (kx, ky, focus) of bench config 5."""
    rng = np.random.default_rng(seed)
    kx, ky = np.meshgrid(
        np.linspace(-8e-3, 8e-3, n_side), np.linspace(-8e-3, 8e-3, n_side)
    )
    focus = rng.uniform(-2e-6, 2e-6, kx.size)
    return np.vstack([kx.ravel(), ky.ravel(), focus])


def phase_compressed(res=1024, n_side=16, maxiter=20):
    """CompressedSpotHologram with the fused kernels vs the dense kernel
    (one transform pair) and vs the jnp path (final amplitudes)."""
    import jax.numpy as jnp

    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import CompressedSpotHologram
    from slmsuite_tpu.ops import compressed as C
    from slmsuite_tpu.ops import pallas_compressed as PC

    n_spots = n_side * n_side
    print(f"(d) compressed 3D spots: {res}^2 SLM, {n_spots} spots, "
          f"{maxiter} iterations, cuda=True")
    slm = SimulatedSLM(resolution=(res, res), pitch_um=(8, 8), wav_um=0.78)
    spots = compressed_spots(n_side)
    holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=slm, cuda=True)
    if not holo._use_kernels():
        raise SmokeFailure("cuda=True did not select the fused kernels")

    consts = holo._compressed_consts()
    coeffs, basis = consts["coeffs"], consts["basis"]
    rng = np.random.default_rng(3)
    P = basis.shape[1]
    ff = rng.normal(size=(2, n_spots)).astype(np.float32)
    nf = rng.normal(size=(2, P)).astype(np.float32)
    kernel = reference_compressed_kernel(coeffs, basis)
    want_near, want_far = reference_compressed_pair(
        kernel, jnp.asarray(ff[0] + 1j * ff[1]), jnp.asarray(nf[0] + 1j * nf[1])
    )
    want_near, want_far = np.asarray(want_near), np.asarray(want_far)
    del kernel
    for name, mod in (("fused kernels", PC), ("jnp path", C)):
        nr, ni = mod.farfield_to_nearfield(ff[0], ff[1], coeffs, basis, n_spots)
        fr, fi = mod.nearfield_to_farfield(nf[0], nf[1], coeffs, basis, n_spots)
        near = np.asarray(nr) + 1j * np.asarray(ni)
        far = np.asarray(fr) + 1j * np.asarray(fi)
        check(f"{name}: farfield->nearfield vs dense kernel (rel. L2)",
              rel_l2(near, want_near), COMPRESSED_RTOL)
        check(f"{name}: nearfield->farfield vs dense kernel (rel. L2)",
              rel_l2(far, want_far), COMPRESSED_RTOL)

    phase0 = np.random.default_rng(11).uniform(
        -np.pi, np.pi, (res, res)
    ).astype(np.float32)
    amps = {}
    for cuda in (True, False):
        h = CompressedSpotHologram(spots, basis="kxy", cameraslm=slm, cuda=cuda)
        h.reset_phase(phase0)
        t0 = time.perf_counter()
        h.optimize("WGS-Kim", maxiter=maxiter, verbose=False)
        a = np.asarray(h.amp_ff, np.float64)
        amps[cuda] = a / a.max()
        print(f"  cuda={cuda}: amplitude cv {a.std() / a.mean():.4f} "
              f"({time.perf_counter() - t0:.2f} s incl. compile)")
    check("final spot amplitudes, kernels vs jnp path (max abs, unit max)",
          float(np.abs(amps[True] - amps[False]).max()), COMPRESSED_AMP_ATOL)


def phase_camera_loop(iterations=10):
    """Experimental-feedback WGS on the simulated rig (bench config 4)."""
    from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_tpu.hardware.cameraslms import FourierSLM
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import SpotHologram

    print(f"(e) camera loop: experimental-feedback WGS-Kim, {iterations} iterations")
    slm = SimulatedSLM(resolution=(512, 512), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * 512 * slm.pitch[0], wy=0.35 * 512 * slm.pitch[1],
    )
    cam = SimulatedCamera(
        slm, resolution=(512, 512), pitch_um=(5.5, 5.5),
        M=np.array([[8.0e3, 200.0], [-200.0, 8.0e3]]),
        b=np.array([[256.0], [256.0]]),
    )
    cam.set_exposure(1.0)
    fs = FourierSLM(cam, slm)
    fs.fourier_calibrate(array_shape=5, array_pitch=16, verbose=False)
    spot_ij = np.array([[160.0, 256, 352, 256], [256.0, 160, 256, 352]])
    holo = SpotHologram((1024, 1024), spot_ij, basis="ij", cameraslm=fs)
    holo.optimize(
        "WGS-Kim", maxiter=iterations, verbose=False,
        feedback="experimental_spot", stat_groups=["experimental_spot"],
    )
    unif = np.asarray(holo.stats["stats"]["experimental_spot"]["uniformity"])
    # The first entry precedes any camera frame and is NaN.
    measured = unif[1:]
    print(f"  measured uniformity: first {measured[0]:.4f}, last {measured[-1]:.4f}")
    if not (np.all(np.isfinite(measured)) and measured[-1] > measured[0]):
        raise SmokeFailure(f"camera feedback did not improve uniformity: {unif}")


class _Outcomes:
    """pytest plugin that counts test outcomes."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests():
    """The ``gpu``-marked tests, in this process (a second JAX process
    could not get the card's memory)."""
    import pytest

    print("(f) tests marked gpu")
    os.environ["SLMSUITE_TPU_TEST_PLATFORM"] = "gpu"
    outcomes = _Outcomes()
    rc = pytest.main(
        [os.path.join(ROOT, "tests", "test_gpu_kernels.py"), "-m", "gpu",
         "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        plugins=[outcomes],
    )
    print(f"  outcomes: {outcomes.counts}")
    if rc != 0 or outcomes.counts.get("passed", 0) == 0 or set(outcomes.counts) != {"passed"}:
        raise SmokeFailure(f"gpu tests: exit {rc}, {outcomes.counts}")


def phase_multichip(devices):
    """The four mesh paths at real sizes, each vs its single-device run."""
    sys.path.insert(0, ROOT)
    import __graft_entry__

    print(f"(g) mesh paths over {len(devices)} GPUs")
    errors = __graft_entry__.run_multichip_paths(
        devices, plane_side=2048, n_planes=8,
        compressed_pixels=1024 * 1024, compressed_spots=256,
        pencil_side=4096, batch_side=2048,
    )
    for name, (err, tol) in errors.items():
        check(name, err, tol, "max |mesh - single device|")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--multichip", action="store_true",
        help="run only the mesh paths, over four GPUs",
    )
    args = parser.parse_args(argv)

    from slmsuite_tpu.misc.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    n_devices = 4 if args.multichip else 1
    dev = phase_device(n_devices)
    if args.multichip:
        import jax

        phase_multichip(jax.devices()[:n_devices])
    else:
        for phase in (phase_spot_wgs, phase_mraf, phase_compressed,
                      phase_camera_loop, phase_gpu_tests):
            t0 = time.perf_counter()
            phase()
            print(f"  phase time {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_devices},
    }))


if __name__ == "__main__":
    main()
