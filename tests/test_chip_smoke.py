"""
The plain references of ``chip_smoke.py`` at 128^2 on the CPU: they must
agree with numpy and with the package before the card trusts them as
the yardstick.
"""

import numpy as np
import pytest

import chip_smoke as S


def test_reference_farfield_matches_numpy_float64():
    rng = np.random.default_rng(0)
    phase = rng.uniform(-np.pi, np.pi, (128, 128)).astype(np.float32)
    got = np.asarray(S.reference_farfield(phase, 1 / 128))
    want = S.reference_farfield(phase.astype(np.float64), 1 / 128, use_numpy=True)
    assert S.rel_l2(got, want) < 1e-6
    # Round trip: the backward phase of the forward field is the input.
    back = S.reference_backward(want, use_numpy=True)
    assert np.abs(np.angle(np.exp(1j * (back - phase)))).max() < 1e-5


def test_reference_stats_definitions():
    target = np.zeros((4, 4))
    target[1, 1] = target[2, 2] = 1.0
    amp = target * np.array([[1.0]])
    eff, unif = S.reference_stats(amp, target, target > 0)
    assert eff == pytest.approx(1.0) and unif == pytest.approx(1.0)
    amp = amp.copy()
    amp[2, 2] = np.sqrt(3.0)  # spot powers 1 and 3
    amp[0, 0] = 1.0  # stray light
    eff, unif = S.reference_stats(amp, target, target > 0)
    assert unif == pytest.approx(1 - 2 / 4)
    assert eff == pytest.approx((1 + np.sqrt(3)) ** 2 / (5 * 2))


def test_spot_wgs_phase_agrees_with_package(capsys):
    S.phase_spot_wgs(N=128, maxiter=14, n_side=4, pitch=12)
    out = capsys.readouterr().out
    assert out.count(" ok") == 3


def test_mraf_phase_agrees_with_package(capsys):
    S.phase_mraf(N=128, n_iterations=4)
    assert capsys.readouterr().out.count(" ok") == 2


def test_reference_compressed_pair_matches_jnp_path():
    import jax.numpy as jnp

    from slmsuite_tpu.ops import compressed as C

    rng = np.random.default_rng(2)
    D, P, N = 3, 128 * 128, 9
    basis = jnp.asarray(rng.normal(size=(D, P)).astype(np.float32))
    coeffs = jnp.asarray((rng.normal(size=(D, N)) * 4).astype(np.float32))
    ff = rng.normal(size=(2, N)).astype(np.float32)
    nf = rng.normal(size=(2, P)).astype(np.float32)
    near, far = S.reference_compressed_pair(
        S.reference_compressed_kernel(coeffs, basis),
        jnp.asarray(ff[0] + 1j * ff[1]), jnp.asarray(nf[0] + 1j * nf[1]),
    )
    nr, ni = C.farfield_to_nearfield(ff[0], ff[1], coeffs, basis, N)
    fr, fi = C.nearfield_to_farfield(nf[0], nf[1], coeffs, basis, N)
    assert S.rel_l2(np.asarray(nr) + 1j * np.asarray(ni), near) < S.COMPRESSED_RTOL
    assert S.rel_l2(np.asarray(fr) + 1j * np.asarray(fi), far) < S.COMPRESSED_RTOL


@pytest.mark.parametrize("err, ok", [(1e-6, True), (1e-3, False), (np.nan, False)])
def test_check_gates(err, ok, capsys):
    if ok:
        S.check("x", err, 1e-5)
    else:
        with pytest.raises(S.SmokeFailure):
            S.check("x", err, 1e-5)
    assert ("ok" if ok else "FAIL") in capsys.readouterr().out


def test_refuses_without_gpu():
    """On the CPU the device phase fails before any result is printed."""
    with pytest.raises(S.SmokeFailure, match="no GPU"):
        S.phase_device(1)
