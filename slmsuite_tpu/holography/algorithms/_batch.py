"""
Batched optimization of independent holograms.

Beyond the reference (which optimizes one hologram per call): stack K
*independent* :class:`~slmsuite_tpu.holography.algorithms.Hologram`
instances — frames of a tweezer-rearrangement movie, a parameter scan,
per-wavelength variants — and advance them in lockstep through ONE
compiled program (``vmap`` over the batch). On one chip this amortizes
dispatch and keeps the device busy at small shapes; over a
``jax.sharding.Mesh`` the batch axis shards with no collectives at all
(embarrassingly parallel, unlike
:class:`~slmsuite_tpu.holography.algorithms.MultiplaneHologram`, whose
planes share one phase and psum their nearfields).

Contrast ref ``_hologram.py:1076+`` (single-instance ``optimize``);
per-instance results land back on each hologram exactly as if it had
been optimized alone.
"""

import numpy as np

from slmsuite_tpu.ops import engine as _engine


def optimize_batch(
    holograms,
    method="GS",
    maxiter=20,
    verbose=True,
    stat_groups=[],
    mesh=None,
    axis_name="data",
    **kwargs,
):
    """
    Optimize K independent holograms in one vmapped device program.

    All holograms must be homogeneous: the same class, farfield/SLM
    shapes, and (after flag parsing) the same engine configuration —
    targets, initial phases, amplitudes, and weights are free to differ.
    Fully-computational feedback only (no camera loops).

    Parameters
    ----------
    holograms : list of Hologram
        The instances to optimize. Results are written back to each
        (phase, farfield, weights, stats) as if optimized individually.
    method, maxiter, verbose, stat_groups, **kwargs
        As :meth:`~slmsuite_tpu.holography.algorithms.Hologram.optimize`.
    mesh : jax.sharding.Mesh OR None
        Shard the batch over ``axis_name``; the batch size must divide
        the mesh. No collectives are emitted.
    axis_name : str
        Mesh axis to shard over.

    Returns
    -------
    list of Hologram
        The same instances, advanced ``maxiter`` iterations.
    """
    import jax.tree_util as jtu

    if len(holograms) == 0:
        return holograms

    cls = type(holograms[0])
    for h in holograms:
        if type(h) is not cls:
            raise ValueError(
                f"Homogeneous batch required; got {type(h).__name__} "
                f"alongside {cls.__name__}."
            )

    configs, consts_list, states, starts = [], [], [], []
    for h in holograms:
        h._update_flags(method, verbose > 1, None, stat_groups, **kwargs)
        if h._engine_feedback() != "computational":
            raise ValueError(
                "optimize_batch supports fully-computational feedback only."
            )
        config = h._build_config()
        configs.append(config)
        consts_list.append(h._build_consts(config))
        states.append(h._build_state(config))
        starts.append(h.iter)

    if any(c != configs[0] for c in configs[1:]):
        raise ValueError(
            "Homogeneous batch required: every hologram must produce the "
            "same engine configuration (same shapes, method, flags, and "
            "stat groups)."
        )

    import jax.numpy as jnp

    stacked_state = jtu.tree_map(lambda *xs: jnp.stack(xs), *states)
    stacked_consts = jtu.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *consts_list
    )

    final, stats = _engine.run_gs_batch(
        configs[0], stacked_state, stacked_consts, maxiter,
        mesh=mesh, axis_name=axis_name,
    )

    stats = np.asarray(stats)
    for i, h in enumerate(holograms):
        h._sync_from_state(jtu.tree_map(lambda x: x[i], final))
        if h._device_stat_groups():
            h._record_scan_stats(stats[i], starts[i])
        h._populate_results()
    return holograms
