"""
The fused compressed-transform kernels (Triton route) in interpret mode
on the CPU, against the jnp transforms and a dense ``exp(i c^T B)``
reference: spot counts that are and are not block multiples, pixel
counts with a tail, and both directions.
"""

import numpy as np
import pytest

D = 4


def _case(n_spots, n_pixels, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + n_spots + n_pixels)
    basis = jnp.asarray(rng.normal(size=(D, n_pixels)).astype(np.float32))
    coeffs = jnp.asarray((rng.normal(size=(D, n_spots)) * 3).astype(np.float32))
    ff = rng.normal(size=(2, n_spots)).astype(np.float32)
    nf = rng.normal(size=(2, n_pixels)).astype(np.float32)
    return basis, coeffs, ff, nf


def _dense(basis, coeffs):
    phase = np.asarray(coeffs, np.float64).T @ np.asarray(basis, np.float64)
    return np.exp(1j * phase)


def _rel(got, want):
    got = np.asarray(got[0]) + 1j * np.asarray(got[1])
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("n_pixels", [1000, 2048 + 77])
@pytest.mark.parametrize("n_spots", [1, 7, 64, 300])
@pytest.mark.parametrize("direction", ["f2n", "n2f"])
def test_kernel_matches_dense_and_jnp(direction, n_spots, n_pixels):
    from slmsuite_tpu.ops import compressed as C
    from slmsuite_tpu.ops import pallas_compressed as PC

    basis, coeffs, ff, nf = _case(n_spots, n_pixels)
    kernel = _dense(basis, coeffs)
    if direction == "f2n":
        want = (ff[0] + 1j * ff[1]) @ kernel / np.sqrt(n_pixels)
        got = PC.farfield_to_nearfield(
            ff[0], ff[1], coeffs, basis, n_spots, interpret=True
        )
        twin = C.farfield_to_nearfield(ff[0], ff[1], coeffs, basis, n_spots)
    else:
        want = np.conj(kernel) @ (nf[0] + 1j * nf[1])
        want = want / np.linalg.norm(want)
        got = PC.nearfield_to_farfield(
            nf[0], nf[1], coeffs, basis, n_spots, interpret=True
        )
        twin = C.nearfield_to_farfield(nf[0], nf[1], coeffs, basis, n_spots)
    assert got[0].shape == want.shape
    assert _rel(got, want) < 1e-5
    assert _rel(twin, want) < 1e-5


@pytest.mark.parametrize(
    "spot_block, pixel_block, group", [(16, 64, 1), (32, 128, 3), (64, 256, 16)]
)
def test_block_shapes_agree(spot_block, pixel_block, group):
    """Block sizes and n2f group sizes change the summation order only."""
    from slmsuite_tpu.ops import pallas_compressed as PC

    basis, coeffs, ff, nf = _case(45, 3001)
    kw = dict(spot_block=spot_block, pixel_block=pixel_block, interpret=True)
    ref_f2n = PC.farfield_to_nearfield_raw(ff[0], ff[1], coeffs, basis, 45,
                                           interpret=True)
    got = PC.farfield_to_nearfield_raw(ff[0], ff[1], coeffs, basis, 45, **kw)
    np.testing.assert_allclose(got[0], ref_f2n[0], rtol=1e-4, atol=1e-4)
    ref_n2f = PC.nearfield_to_farfield_raw(nf[0], nf[1], coeffs, basis, 45,
                                           interpret=True)
    got = PC.nearfield_to_farfield_raw(nf[0], nf[1], coeffs, basis, 45,
                                       group=group, **kw)
    np.testing.assert_allclose(got[1], ref_n2f[1], rtol=1e-4, atol=1e-3)


def test_sincos_over_unbounded_phase():
    """Warm starts and 3D spots reach thousands of radians; the minimax
    pair keeps the float32 noise floor there."""
    import jax.numpy as jnp

    from slmsuite_tpu.ops import pallas_compressed as PC

    x = np.concatenate([
        np.linspace(-1e4, 1e4, 200_001), np.linspace(-10, 10, 20_001)
    ]).astype(np.float32)
    cos, sin = PC._sincos(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(cos), np.cos(x.astype(np.float64)), atol=2e-7)
    np.testing.assert_allclose(np.asarray(sin), np.sin(x.astype(np.float64)), atol=2e-7)


def test_spot_block_shrinks_to_spot_count():
    from slmsuite_tpu.ops import pallas_compressed as PC

    assert PC._spot_block(1, 32) == 1
    assert PC._spot_block(7, 32) == 8
    assert PC._spot_block(300, 32) == 32


def test_fused_iteration_kernel_matches_jnp():
    """The round trip with amplitude replacement (scalar and plane
    amplitude) against the jnp twin, after unit normalization."""
    import jax.numpy as jnp

    from slmsuite_tpu.ops import compressed as C
    from slmsuite_tpu.ops import pallas_compressed as PC

    basis, coeffs, ff, _ = _case(21, 2500)
    plane = jnp.asarray(
        (0.5 + np.random.default_rng(4).uniform(0, 1, 2500)).astype(np.float32)
    )

    def unit(a, b):
        n = np.sqrt(float(jnp.sum(a * a + b * b)))
        return np.asarray(a) / n, np.asarray(b) / n

    for amp in (jnp.float32(1.0), plane):
        got = unit(*PC.fused_iteration(ff[0], ff[1], coeffs, basis, amp, 21,
                                       interpret=True))
        want = unit(*C._fused_iteration_jnp(ff[0], ff[1], coeffs, basis, amp, 21))
        np.testing.assert_allclose(got[0], want[0], atol=2e-5)
        np.testing.assert_allclose(got[1], want[1], atol=2e-5)


def test_pallas_calls_name_the_triton_route():
    """Every kernel is lowered through Triton, never the default route."""
    import inspect

    from slmsuite_tpu.ops import pallas_compressed as PC

    source = inspect.getsource(PC)
    assert source.count("pl.pallas_call(") == source.count('backend="triton",') == 2
