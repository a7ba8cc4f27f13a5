"""
Kernels and FFT tiers compiled for a GPU, checked against their plain
twins on the card.

The default suite runs on the CPU, where the fused compressed kernels run
only in interpret mode (``tests/holography/test_spots_multiplane.py``).
These tests compile them for the card. They skip without a GPU and run
in ``python chip_smoke.py`` (phase f), in that process: a second JAX
process could not get the card's memory.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("no GPU: run through chip_smoke.py on the card")
    return jax


@pytest.mark.parametrize("n_spots", [1, 7, 64, 300])
def test_compressed_kernels_match_jnp(gpu, n_spots):
    """Both fused kernels against the jnp transforms at a pixel count
    that is no multiple of the block."""
    import jax.numpy as jnp

    from slmsuite_tpu.ops import compressed as C
    from slmsuite_tpu.ops import pallas_compressed as PC

    rng = np.random.default_rng(n_spots)
    D, P = 4, 300 * 301
    basis = jnp.asarray(rng.normal(size=(D, P)).astype(np.float32))
    coeffs = jnp.asarray((rng.normal(size=(D, n_spots)) * 3).astype(np.float32))
    ffr, ffi = (jnp.asarray(rng.normal(size=n_spots).astype(np.float32)) for _ in "ri")
    nfr, nfi = (jnp.asarray(rng.normal(size=P).astype(np.float32)) for _ in "ri")

    def rel(got, want):
        got = np.asarray(got[0]) + 1j * np.asarray(got[1])
        want = np.asarray(want[0]) + 1j * np.asarray(want[1])
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    assert rel(
        PC.farfield_to_nearfield(ffr, ffi, coeffs, basis, n_spots),
        C.farfield_to_nearfield(ffr, ffi, coeffs, basis, n_spots),
    ) < 1e-5
    assert rel(
        PC.nearfield_to_farfield(nfr, nfi, coeffs, basis, n_spots),
        C.nearfield_to_farfield(nfr, nfi, coeffs, basis, n_spots),
    ) < 1e-5


def test_compressed_fused_iteration_matches_jnp(gpu):
    """The kernel round trip with amplitude replacement against the jnp
    twin (directions after unit normalization)."""
    import jax.numpy as jnp

    from slmsuite_tpu.ops import compressed as C
    from slmsuite_tpu.ops import pallas_compressed as PC

    rng = np.random.default_rng(6)
    D, P, N = 4, 96 * 96, 40
    basis = jnp.asarray(rng.normal(size=(D, P)).astype(np.float32) * 2)
    coeffs = jnp.asarray((rng.normal(size=(D, N)) * 4).astype(np.float32))
    ffr, ffi = (jnp.asarray(rng.normal(size=N).astype(np.float32)) for _ in "ri")
    amp = jnp.asarray((0.5 + rng.uniform(0, 1, P)).astype(np.float32))

    def unit(a, b):
        n = np.sqrt(float(jnp.sum(a * a + b * b)))
        return np.asarray(a) / n, np.asarray(b) / n

    got = unit(*PC.fused_iteration(ffr, ffi, coeffs, basis, amp, N))
    ref = unit(*C._fused_iteration_jnp(ffr, ffi, coeffs, basis, amp, N))
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=2e-5)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_fft2_tiers_match_numpy(gpu, backend, monkeypatch):
    """Both FFT tiers against a float64 numpy FFT at 1024^2 (the matmul
    tier at HIGHEST precision: true float32 on the card)."""
    import jax
    import jax.numpy as jnp

    from slmsuite_tpu.ops import fft as F

    monkeypatch.setattr(F, "_BACKEND", backend)
    monkeypatch.setattr(F, "_PRECISION", "HIGHEST")
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1024, 1024)) + 1j * rng.normal(size=(1024, 1024)))
    got = np.asarray(jax.jit(F.fft2)(jnp.asarray(x.astype(np.complex64))))
    want = np.fft.fft2(x, norm="ortho")
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_scrambled_loop_matches_natural(gpu, monkeypatch):
    """Within the four-step tier, the scrambled (transpose-free) WGS loop
    that "auto" selects on a GPU tracks the natural engine."""
    from slmsuite_tpu.models import spot_array_wgs
    from slmsuite_tpu.ops import engine as E
    from slmsuite_tpu.ops import fft as F

    monkeypatch.setattr(F, "_BACKEND", "matmul")
    monkeypatch.setattr(F, "_PRECISION", "HIGHEST")
    E._compiled_run.cache_clear()  # programs compiled for another tier
    gpu.clear_caches()
    model = spot_array_wgs(N=256, n_side=8, spacing_div=24)
    out = {}
    for mode in (False, "auto"):
        monkeypatch.setattr(E, "_SCRAMBLED_MODE", mode)
        state, stats = E.run_gs(model.config, model.init_state(), model.consts, 8)
        out[mode] = (np.asarray(state.psi), np.asarray(stats))
    diff = np.angle(np.exp(1j * (out["auto"][0] - out[False][0])))
    assert np.percentile(np.abs(diff), 99) < 5e-3
    np.testing.assert_allclose(out["auto"][1], out[False][1], atol=1e-3)
    E._compiled_run.cache_clear()
    gpu.clear_caches()
