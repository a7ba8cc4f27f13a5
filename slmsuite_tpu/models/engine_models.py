"""
Single-chip flagship models over the scanned engine.

Ref workload provenance: the reference benchmarks GS/WGS spot arrays at
1024² with pytest-benchmark (``tests/holography/test_algorithms.py:121-145``)
and demonstrates MRAF image targets in its docs; these builders are the
Engine-level equivalents used by ``bench.py`` and
``__graft_entry__``.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass
class EngineModel:
    """A ready-to-run engine workload: config + consts + initial state.

    ``step`` is the pure jittable per-iteration function (state, consts)
    -> (state, stats) — the unit the driver compile-checks; ``run(n)``
    executes ``n`` iterations through :meth:`slmsuite_tpu.ops.engine.run_gs`
    (scrambled promotion, donation, chunking) from a FRESH initial state.
    """

    config: object
    consts: dict
    target: np.ndarray
    phase0: np.ndarray  # folded initial phase

    def init_state(self):
        from slmsuite_tpu.ops.engine import init_gs_state

        return init_gs_state(
            self.config, self.phase0, np.nan_to_num(self.target).copy()
        )

    @property
    def step(self):
        from slmsuite_tpu.ops.engine import make_gs_step

        return make_gs_step(self.config)

    def run(self, n_iterations):
        from slmsuite_tpu.ops.engine import run_gs

        return run_gs(self.config, self.init_state(), self.consts, n_iterations)


def spot_array_target(N, n_side, spacing_div):
    """(N, N) target with an ``n_side`` × ``n_side`` centered spot grid
    spaced ``N // spacing_div`` pixels apart, unit power."""
    target = np.zeros((N, N), dtype=np.float32)
    idx = (
        (np.arange(n_side) - (n_side - 1) / 2) * (N // spacing_div) + N / 2
    ).astype(int)
    xs, ys = np.meshgrid(idx, idx)
    target[ys.ravel(), xs.ravel()] = 1.0
    return target / np.sqrt((target**2).sum())


def _base_consts(N, target):
    import jax.numpy as jnp

    clean = np.nan_to_num(target)
    return {
        "amp": jnp.float32(1.0 / N),
        "target": jnp.asarray(clean),
        "stat_mask": jnp.asarray(clean != 0),
        "feedback_exponent": jnp.float32(0.8),
        "feedback_factor": jnp.float32(0.1),
        "fix_phase_iteration": jnp.int32(10),
        "fix_phase_efficiency": jnp.float32(np.nan),
    }


def spot_array_wgs(N=2048, n_side=32, spacing_div=70, method="WGS-Kim",
                   stats=True, seed=0):
    """The headline model: ``N``² SLM, ``n_side``² spot array, WGS."""
    from slmsuite_tpu.ops.engine import GSConfig
    from slmsuite_tpu.ops.propagation import fold_phase

    target = spot_array_target(N, n_side, spacing_div)
    rng = np.random.default_rng(seed)
    phase0 = fold_phase(
        rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N)
    )
    config = GSConfig(
        method=method, shape=(N, N), slm_shape=(N, N),
        stat_groups=("computational",) if stats else (),
    )
    return EngineModel(config, _base_consts(N, target), target, phase0)


def image_mraf(N=2048, method="WGS-Leonardo", mraf_factor=0.5, stats=True,
               seed=0):
    """MRAF flagship: ring image target, amplitude-free noise region
    outside ``N/4`` radius, zero region inside."""
    import jax.numpy as jnp

    from slmsuite_tpu.ops.engine import GSConfig
    from slmsuite_tpu.ops.propagation import fold_phase

    yy, xx = np.meshgrid(
        *(np.arange(N) - N / 2 for _ in range(2)), indexing="ij"
    )
    radius = np.sqrt(xx**2 + yy**2)
    target = np.where(
        np.abs(radius - N / 8) < N / 80, 1.0, 0.0
    ).astype(np.float32)
    target /= np.sqrt(np.nansum(target**2))
    target[radius > N / 4] = np.nan  # Noise region: amplitude freedom.

    rng = np.random.default_rng(seed)
    phase0 = fold_phase(
        rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N)
    )
    config = GSConfig(
        method=method, shape=(N, N), slm_shape=(N, N),
        stat_groups=("computational",) if stats else (),
        mraf=True, mraf_factor=mraf_factor is not None,
    )
    consts = _base_consts(N, target)
    nan_mask = np.isnan(target)
    clean = np.nan_to_num(target)
    consts["signal_mask"] = jnp.asarray(~nan_mask & (clean > 0))
    consts["noise_mask"] = jnp.asarray(nan_mask)
    consts["zero_mask"] = jnp.asarray(~nan_mask & (clean == 0))
    consts["mraf_factor"] = jnp.float32(
        mraf_factor if mraf_factor is not None else 1.0
    )
    return EngineModel(config, consts, target, phase0)
