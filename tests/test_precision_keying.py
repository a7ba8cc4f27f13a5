"""
The four-step ("matmul") FFT tier's contraction precision must be honored
per COMPILED RUN, not per process: the stage einsums read the
``ops.fft._PRECISION`` module global at trace time, so the engine keys
its compiled runs on ``GSConfig.kernel_precision`` and pins the global
around each run. On a GPU ``"DEFAULT"`` runs the stage matmuls in TF32
and ``"HIGHEST"`` in true float32; the ``"xla"`` tier ignores the knob.

Reference analog: the reference exposes a single device-wide precision
(cupy f32); the per-run precision knob is this package's own, so these
are original-contract tests.
"""

import numpy as np
import pytest

from slmsuite_tpu.ops import fft as F


@pytest.fixture(autouse=True)
def _restore_fft_globals():
    prior = (F._PRECISION, F._BACKEND)
    yield
    F._PRECISION, F._BACKEND = prior


def _dot_precisions(fn, *args):
    """Precisions of every dot in the jaxpr of ``fn(*args)``."""
    import jax

    jaxpr = jax.make_jaxpr(fn)(*args)
    return {
        str(eqn.params["precision"])
        for eqn in jaxpr.jaxpr.eqns
        if eqn.primitive.name == "dot_general"
    }


def test_precision_keyed_jit_traces_once_per_precision():
    """The engine compiles one program per ``kernel_precision`` (the
    field is part of the compiled-run cache key), and each program's
    stage matmuls carry its own precision."""
    import dataclasses

    from slmsuite_tpu.models import spot_array_wgs
    from slmsuite_tpu.ops import engine as E

    m = spot_array_wgs(N=64, n_side=2, spacing_div=8)
    configs = {
        p: dataclasses.replace(m.config, kernel_precision=p)
        for p in ("HIGHEST", "DEFAULT")
    }
    runs = {p: E._compiled_run(c, 2) for p, c in configs.items()}
    assert runs["HIGHEST"] is not runs["DEFAULT"]
    assert E._compiled_run(configs["HIGHEST"], 2) is runs["HIGHEST"]

    import jax.numpy as jnp

    x = jnp.ones((64, 64), jnp.complex64)
    F.set_fft_backend("matmul")
    seen = {}
    for p in ("HIGHEST", "DEFAULT"):
        F.set_fft_precision(p)
        seen[p] = _dot_precisions(lambda a: F.fft2(a), x)
    assert all(p in str(seen[p]) for p in seen), seen


def test_entry_points_retrace_on_precision_change(monkeypatch):
    """The FFT entry points pick up a precision change on the next
    trace: ``_cmatmul`` sees the live global at each trace, in call
    order — not the first-seen global twice."""
    import jax
    import jax.numpy as jnp

    seen = []
    orig = F._cmatmul

    def spy(*args, **kwargs):
        seen.append(F._PRECISION)
        return orig(*args, **kwargs)

    monkeypatch.setattr(F, "_cmatmul", spy)
    F.set_fft_backend("matmul")

    rng = np.random.default_rng(0)
    x = jnp.asarray(
        (rng.standard_normal((256, 256)) + 0j).astype(np.complex64)
    )

    F.set_fft_precision("DEFAULT")
    r1 = jax.jit(lambda a: F.fft2(a))(x)
    assert seen and set(seen) == {"DEFAULT"}

    seen.clear()
    F.set_fft_precision("HIGHEST")
    r2 = jax.jit(lambda a: F.fft2(a))(x)
    assert seen and set(seen) == {"HIGHEST"}

    # Same math on the CPU (float32 either way) regardless of the flag.
    np.testing.assert_allclose(
        np.asarray(r1), np.asarray(r2), rtol=1e-5, atol=1e-5
    )


def test_engine_pin_restores_global_and_batch_path_pins():
    """run_gs_batch honors config.kernel_precision (the compiled batch
    run is wrapped with the precision pin) and restores the global."""
    import dataclasses

    import jax.numpy as jnp
    import jax.tree_util as jtu

    from slmsuite_tpu.models import spot_array_wgs
    from slmsuite_tpu.ops.engine import run_gs_batch

    m = spot_array_wgs(N=64, n_side=2, spacing_div=8)
    config = dataclasses.replace(m.config, kernel_precision="DEFAULT")
    states = jtu.tree_map(
        lambda *xs: jnp.stack(xs), m.init_state(), m.init_state()
    )
    consts = jtu.tree_map(lambda x: jnp.stack([x, x]), m.consts)

    prior = F._PRECISION
    recorded = []
    orig_set = F.set_fft_precision

    def spy_set(p):
        recorded.append(p)
        return orig_set(p)

    F.set_fft_precision = spy_set
    try:
        run_gs_batch(config, states, consts, 2)
    finally:
        F.set_fft_precision = orig_set
    assert "DEFAULT" in recorded  # the pin engaged
    assert F._PRECISION == prior  # and restored the global
