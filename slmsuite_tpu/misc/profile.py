"""
Profiling and timing helpers for device work.

The reference leans on tqdm + pytest-benchmark + line-profiler (SURVEY
section 5); the equivalents here are:

- :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace of device execution.
- :func:`time_scan` — wall-clock rate for a jitted step function,
  chaining dependent iterations in one ``lax.scan`` and waiting with
  ``block_until_ready``.
- :func:`bytes_accessed` — XLA's deterministic cost-analysis byte count
  for a function, the hardware-noise-free way to compare memory-bound
  kernels.
"""

import contextlib
import time

__all__ = ["trace", "time_scan", "bytes_accessed"]


@contextlib.contextmanager
def trace(log_dir, host_tracer_level=2):
    """Record a ``jax.profiler`` trace into ``log_dir`` (TensorBoard format).
    ``host_tracer_level`` maps to ``ProfileOptions.host_tracer_level``
    (0 = off, 1 = trace regions, 2 = +Python, 3 = verbose)."""
    import jax

    options = jax.profiler.ProfileOptions()
    options.host_tracer_level = int(host_tracer_level)
    jax.profiler.start_trace(
        log_dir, create_perfetto_link=False, profiler_options=options
    )
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_scan(step, init, n_iterations=50, repeats=3):
    """
    Measure iterations/second of ``carry -> carry`` function ``step``.

    The iterations are chained in a single jitted ``lax.scan`` (each
    depends on the previous, so nothing can be elided) and the result is
    waited for with ``block_until_ready``. Returns the best rate over
    ``repeats`` timed runs (first run warms the compile cache).
    """
    import jax

    @jax.jit
    def run(carry):
        def body(c, _):
            return step(c), None

        carry, _ = jax.lax.scan(body, carry, None, length=n_iterations)
        return carry

    def once():
        start = time.perf_counter()
        out = run(init)
        jax.block_until_ready(out)
        return n_iterations / (time.perf_counter() - start)

    once()  # Compile + warm.
    return max(once() for _ in range(repeats))


def bytes_accessed(fn, *args):
    """
    XLA cost-analysis ``bytes accessed`` for ``jit(fn)(*args)`` — a
    deterministic, hardware-independent proxy for device-memory traffic. Returns
    ``None`` when the backend does not report cost analysis.
    """
    import jax

    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    value = cost.get("bytes accessed")
    return None if value is None else int(value)
