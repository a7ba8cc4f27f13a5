r"""
Fused WGS weight-update rules.

One pure elementwise function implements all five weighting methods; under
``jit`` XLA fuses the whole update (normalize, correct, apply, renormalize)
into a single pass over the weights — the equivalent of the
reference's ``update_weights_generic`` CUDA kernel (``cuda.cu:390-435``)
and its cupy twin (``_hologram.py:1822-1879``).

Methods (``feedback``/``target`` are amplitudes, :math:`p` =
``feedback_exponent``, :math:`f` = ``feedback_factor``):

- Leonardo / Kim:   :math:`w \leftarrow w (T/F)^p`
- Nogrette:         :math:`w \leftarrow w / (1 - f(1 - F/T))` (normalized)
- Wu:               :math:`w \leftarrow w \exp(p(T - F))`
- tanh:             :math:`w \leftarrow w (1 + f\tanh(p(T - F)))`
"""

import jax.numpy as jnp

# Numeric codes matching the reference's ALGORITHM_INDEX (`_header.py:72`).
ALGORITHM_INDEX = {
    "GS": 0,
    "WGS-Leonardo": 1,
    "WGS-Kim": 2,
    "WGS-Nogrette": 3,
    "WGS-Wu": 4,
    "WGS-tanh": 5,
    "CG": 6,
}


def _norm(x, axis_name=None):
    """Root of sum of squares (nan-safe), matching ``Hologram._norm``.
    With ``axis_name``, the sum also reduces over the mesh axis (for
    row-sharded planes inside ``shard_map``)."""
    total = jnp.nansum(jnp.square(jnp.abs(x)))
    if axis_name is not None:
        import jax

        total = jax.lax.psum(total, axis_name)
    return jnp.sqrt(total)


def _nanmean(x, axis_name=None):
    """nan-ignoring mean, optionally global over a mesh axis."""
    if axis_name is None:
        return jnp.nanmean(x)
    import jax

    total = jax.lax.psum(jnp.nansum(x), axis_name)
    count = jax.lax.psum(jnp.sum(~jnp.isnan(x)), axis_name)
    return total / count


def update_weights_generic(
    weights,
    feedback_amp,
    target_amp,
    method,
    feedback_exponent=0.8,
    feedback_factor=0.1,
    nan_checks=True,
    axis_name=None,
):
    """
    Pure functional WGS weight update.

    Parameters
    ----------
    weights : jnp.ndarray
        Current weight amplitudes (any shape; plane or per-spot vector).
    feedback_amp : jnp.ndarray
        Measured/computed amplitudes, same shape (normalized internally).
    target_amp : jnp.ndarray
        Target amplitudes, same shape.
    method : str
        One of ``"WGS-Leonardo"``, ``"WGS-Kim"``, ``"WGS-Nogrette"``,
        ``"WGS-Wu"``, ``"WGS-tanh"`` (static; selects the fused expression).
    feedback_exponent, feedback_factor : float or jnp scalar
        Method tuning (dynamic; no recompile on change).
    nan_checks : bool
        Guard divisions by zero and nan infiltration.

    Returns
    -------
    jnp.ndarray
        Updated weights, renormalized to unit norm.
    """
    method_lower = method.lower()
    if not method_lower.startswith("wgs-"):
        raise ValueError("Weighting is only for WGS methods.")
    rule = method_lower[4:]

    # HBM-traffic note: for Leonardo/Kim the feedback pre-normalization
    # (divide by the global norm s) is a pure scalar factor:
    # (s f/t)^-p = s^-p (f/t)^-p, and s^-p is removed exactly by the
    # final renormalization (masked pixels pin to factor 1, but their
    # weights are identically zero, so the trajectory is unchanged).
    # The normalized feedback array is therefore never materialized for
    # those rules — one fewer full-plane pass in the hot loop. Nogrette's
    # nanmean mixes the masked 1.0 entries (scale does NOT factor out)
    # and the additive Wu/tanh rules need the normalized values, so they
    # keep the eager normalization like the reference.
    if "wu" in rule or "tanh" in rule:
        feedback = feedback_amp / _norm(feedback_amp, axis_name)
        corrected = target_amp - feedback_exponent * feedback
    else:
        if "nogrette" in rule:
            feedback = feedback_amp / _norm(feedback_amp, axis_name)
        else:
            feedback = feedback_amp
        if nan_checks:
            # Pre-guarded division (identical result to dividing then
            # masking, but never produces the transient inf/nan that
            # checkify instrumentation would flag). NaN targets (MRAF
            # noise regions) are guarded too: they land on factor 1,
            # exactly as the isfinite mask would have produced.
            on = (target_amp != 0) & ~jnp.isnan(target_amp)
            corrected = feedback / jnp.where(on, target_amp, 1.0)
            corrected = jnp.where(jnp.isfinite(corrected) & on, corrected, 1.0)
        else:
            corrected = feedback / target_amp

    if "leonardo" in rule or "kim" in rule:
        corrected = jnp.power(corrected, -feedback_exponent)
    elif "nogrette" in rule:
        corrected = corrected * (-1.0 / _nanmean(corrected, axis_name)) + 1.0
        corrected = 1.0 / (1.0 - feedback_factor * corrected)
    elif "wu" in rule:
        corrected = jnp.exp(feedback_exponent * corrected)
    elif "tanh" in rule:
        corrected = 1.0 + feedback_factor * jnp.tanh(feedback_exponent * corrected)
    else:
        raise ValueError(f"Method '{method}' not recognized.")

    if nan_checks:
        corrected = jnp.where(jnp.isinf(corrected), 1.0, corrected)

    new_weights = weights * corrected
    if nan_checks:
        new_weights = jnp.nan_to_num(new_weights, nan=0.0001)

    return new_weights / _norm(new_weights, axis_name)
