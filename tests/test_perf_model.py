"""
Deterministic performance-regression guards.

XLA's cost analysis (``bytes accessed``) is hardware-independent, so
these bounds hold on the CPU CI exactly as on a GPU for the einsum/jnp
tiers — a silent traffic regression (an extra materialized plane, a
lost fusion) fails here without any timing flakiness. The fused
compressed kernels are opaque custom calls to cost analysis and are not
bounded here.
"""

import numpy as np
import pytest

# The shared `rng` fixture comes from tests/conftest.py (seeded from
# SESSION_SEED); the traffic bounds below are seed-independent.


def test_einsum_fft2_traffic_bound(rng):
    """The scrambled einsum fft2 must stay within its engineered traffic
    envelope (measured 71.4 MB at 512^2; bound with 25% headroom)."""
    import jax.numpy as jnp

    from slmsuite_tpu.misc.profile import bytes_accessed
    from slmsuite_tpu.ops import fft as F

    N = 512
    xr = jnp.asarray(rng.standard_normal((N, N)).astype(np.float32))
    xi = jnp.asarray(rng.standard_normal((N, N)).astype(np.float32))
    b = bytes_accessed(lambda a, c: F.fft2_scrambled_pair(a, c), xr, xi)
    if b is None:
        pytest.skip("backend reports no cost analysis")
    assert b < 90e6, f"fft2_scrambled_pair traffic regressed: {b/1e6:.1f} MB"


def test_natural_step_traffic_bound(rng):
    """The natural (non-fused) WGS step's jnp graph must stay within its
    envelope (measured 76.5 tiles at 256^2; bound at 95 tiles)."""
    import jax.numpy as jnp

    from slmsuite_tpu.misc.profile import bytes_accessed
    from slmsuite_tpu.ops.engine import GSConfig, init_gs_state, make_gs_step
    from slmsuite_tpu.ops.propagation import fold_phase

    shape = (256, 256)
    target = np.zeros(shape, np.float32)
    target[::16, ::16] = 1
    target /= np.sqrt((target**2).sum())
    config = GSConfig(
        method="WGS-Kim", shape=shape, slm_shape=shape,
        stat_groups=("computational",),
    )
    consts = {
        "amp": jnp.float32(1 / 256),
        "target": jnp.asarray(target),
        "stat_mask": jnp.asarray(target != 0),
        "feedback_exponent": jnp.float32(0.8),
        "feedback_factor": jnp.float32(0.1),
        "fix_phase_iteration": jnp.int32(10),
        "fix_phase_efficiency": jnp.float32(np.nan),
    }
    step = make_gs_step(config)
    state = init_gs_state(
        config,
        fold_phase(
            rng.uniform(-np.pi, np.pi, shape).astype(np.float32), shape
        ),
        target.copy(),
    )
    b = bytes_accessed(lambda s, c: step(s, c), state, consts)
    if b is None:
        pytest.skip("backend reports no cost analysis")
    tile = shape[0] * shape[1] * 4
    assert b < 95 * tile, f"natural step traffic regressed: {b/tile:.1f} tiles"


def test_headline_config_is_fused():
    """The benchmarked headline configuration must keep taking the
    fully-fused path (a gate regression would silently run 2x slower)."""
    from slmsuite_tpu.ops import engine as E

    config = E.GSConfig(
        method="WGS-Kim", shape=(2048, 2048), slm_shape=(2048, 2048),
        stat_groups=("computational",), scrambled=True,
    )
    assert E._fused_active(config)

    mraf = E.GSConfig(
        method="WGS-Leonardo", shape=(2048, 2048), slm_shape=(2048, 2048),
        stat_groups=("computational",), mraf=True, mraf_factor=True,
        scrambled=True,
    )
    assert E._mraf_fused_active(mraf)
