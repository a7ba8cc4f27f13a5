#!/usr/bin/env python
"""
Benchmarks for the BASELINE.json configs.

Default (no args): the headline metric — WGS-Kim iterations/sec on a
2048x2048 SLM with a 32x32 spot array (config 2). Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Other configs (``python bench.py --config N [size] [iters]``):
  1  GS, 1024^2, 10x10 SpotHologram grid, 50 iters
  2  WGS-Kim, 2048^2, 32x32 spots (default; ``python bench.py [N] [iters]``)
  3  MRAF image hologram (ring target, nan noise region)
  4  Camera-in-the-loop: experimental-feedback WGS on the simulated rig
  5  Zernike 3D compressed spot array (grid-free transform)

Methodology:
- Device work is a single jitted `lax.scan` of dependent iterations;
  every timed window ends in ``jax.block_until_ready``.
- The benchmark measures a GPU and refuses to run without one (run
  ``JAX_PLATFORMS=cpu python -m pytest tests/`` for the CPU tests).
  Compare two versions only within one process on one card.
"""

import json
import os
import sys
import time

import numpy as np


def _git_commit():
    """Short hash of the benched tree (+ dirty marker) for artifact
    provenance; best-effort (the artifact is still valid without git)."""
    import subprocess

    try:
        here = os.path.dirname(os.path.abspath(__file__))
        rev = subprocess.run(
            ["git", "-C", here, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "-C", here, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        return (rev + ("-dirty" if dirty else "")) if rev else None
    except Exception:  # noqa: BLE001 - provenance is best-effort
        return None


def _result(metric, value, unit, baseline, **extra):
    result = {
        "metric": metric,
        "value": round(value, 2),
        "unit": unit,
        "vs_baseline": round(value / baseline, 4),
    }
    result.update(extra)
    return result


def _emit(metric, value, unit, baseline, **extra):
    result = _result(metric, value, unit, baseline, **extra)
    print(json.dumps(result))
    return result


def bench_engine(model, iters, runner=None, n_repeats=3):
    """Time the scanned engine on a flagship model
    (:mod:`slmsuite_tpu.models`); returns ``(iter/s, stats, provenance)``
    where ``provenance`` carries the per-repeat evidence the artifact
    embeds (median/spread across ``n_repeats`` marginal estimates) —
    the analog of pytest-benchmark's per-run metadata autosave
    (``/root/reference/tests/conftest.py:520-522``)."""
    import jax

    from slmsuite_tpu.ops.engine import run_gs

    run = run_gs if runner is None else runner
    config, consts = model.config, model.consts

    def once(n, k=1):
        state = jax.block_until_ready(model.init_state())
        t0 = time.time()
        # Chain k calls with device-resident state hand-off: total
        # signal is k*n iterations from ONE compiled program, with
        # per-call dispatch appearing k times on BOTH sides of the
        # marginal difference (so it still cancels).
        stats = None
        for _ in range(k):
            state, stats = run(config, state, consts, n)
        jax.block_until_ready((state, stats))
        return time.time() - t0, np.asarray(stats)

    # Marginal (steady-state) rate: difference of a long and a short run
    # cancels the fixed per-call overhead (dispatch, stats fetch) that
    # would otherwise be misattributed to the iterations themselves.
    # Each repeat pairs one short and one long run into ITS OWN marginal
    # estimate so the artifact can report the median AND the spread.
    small = max(1, iters // 5)
    once(small)  # Warmup: compile both lengths + run.
    once(iters)
    # Science stats ALWAYS come from the standard single window (fresh
    # init, the reference's iteration count) — the timing chains below
    # keep optimizing past it and their stats are discarded.
    t_warm, stats = once(iters)
    # Size the chain so the long side holds ~0.7 s of on-device signal:
    # a fixed window at small shapes sits below the dispatch noise.
    k = int(np.clip(round(0.7 / max(t_warm, 1e-4)), 1, 64))
    rates = []
    for _ in range(n_repeats):
        t_small = once(small, k)[0]
        t_large, _chained = once(iters, k)
        wall = k * iters / t_large
        if t_large > t_small:
            marginal = k * (iters - small) / (t_large - t_small)
        else:
            marginal = wall  # Jitter swamped the difference; be honest.
        # A marginal estimate far above the wall rate is jitter.
        rates.append(min(marginal, 2.0 * wall))
    rates.sort()
    median = rates[len(rates) // 2]
    provenance = {
        "n_repeats": n_repeats,
        "timing_window_iters": k * iters,
        "iter_s_median": round(median, 2),
        "iter_s_spread": round(
            (rates[-1] - rates[0]) / max(median, 1e-9), 3
        ),
    }
    return median, stats, provenance


def attest_compressed_parity(iters=3, n_spots=64, res=512):
    """
    On-card attestation of the compressed (grid-free) Zernike transform
    pair: run a few WGS-Kim iterations from the same initial phase
    through the fused Triton-route kernels (``cuda=True``), the jnp
    cached-kernel scan and the jnp recompute path, and require matching
    spot amplitudes/weights. Returns True, or raises; False without a
    GPU.
    """
    from slmsuite_tpu.ops.platform import accelerator

    if accelerator() != "gpu":
        return False

    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import CompressedSpotHologram

    slm = SimulatedSLM(resolution=(res, res), pitch_um=(8, 8), wav_um=0.78)
    rng = np.random.default_rng(11)
    side = int(np.sqrt(n_spots))
    kx, ky = np.meshgrid(
        np.linspace(-6e-3, 6e-3, side), np.linspace(-6e-3, 6e-3, side)
    )
    spots = np.vstack([
        kx.ravel(), ky.ravel(), rng.uniform(-2e-6, 2e-6, kx.size)
    ])
    phase0 = rng.uniform(-np.pi, np.pi, (res, res)).astype(np.float32)
    variants = (
        ("kernels", True, None),
        ("jnp_cached", False, "4096"),
        ("jnp_recompute", False, "0"),
    )
    prev_cache = os.environ.get("SLMSUITE_TPU_COMPRESSED_CACHE_MB")
    out = {}
    try:
        for name, cuda, cache_mb in variants:
            if cache_mb is None:
                os.environ.pop("SLMSUITE_TPU_COMPRESSED_CACHE_MB", None)
            else:
                os.environ["SLMSUITE_TPU_COMPRESSED_CACHE_MB"] = cache_mb
            holo = CompressedSpotHologram(
                spots, basis="kxy", cameraslm=slm, cuda=cuda
            )
            holo.reset_phase(phase0)
            holo.optimize("WGS-Kim", maxiter=iters, verbose=False)
            amp_ff = np.asarray(holo.amp_ff)
            weights = np.asarray(holo.weights)
            out[name] = (amp_ff / max(amp_ff.max(), 1e-12),
                         weights / max(weights.max(), 1e-12))
    finally:
        if prev_cache is None:
            os.environ.pop("SLMSUITE_TPU_COMPRESSED_CACHE_MB", None)
        else:
            os.environ["SLMSUITE_TPU_COMPRESSED_CACHE_MB"] = prev_cache
    ref = out["kernels"]
    for name in ("jnp_cached", "jnp_recompute"):
        a_err = float(np.abs(out[name][0] - ref[0]).max())
        w_err = float(np.abs(out[name][1] - ref[1]).max())
        if not (a_err < 2e-3 and w_err < 2e-3):
            raise AssertionError(
                f"compressed kernel parity FAILED vs {name}: "
                f"amp={a_err:.2e} w={w_err:.2e}"
            )
    return True


def _marginal_rate(once, small, iters, repeats=3):
    """Marginal (long-minus-short) iteration rate of a host-driven loop,
    clamped at 2x the observed wall rate. Returns ``(rate, wall_rate)``
    so callers can emit BOTH — the marginal estimator cancels fixed
    per-call overhead (state build and sync) but can read up to double
    the end-to-end rate, so the wall rate must ride along in the JSON
    for honest comparison against the baseline targets."""
    def pair_rate(t_s, t_l):
        wall = iters / t_l
        if t_l > t_s:
            return min((iters - small) / (t_l - t_s), 2.0 * wall)
        return wall

    t_smalls, t_larges = [], []
    for _ in range(repeats):
        t_smalls.append(once(small))
        t_larges.append(once(iters))
    t_small = sorted(t_smalls)[len(t_smalls) // 2]
    t_large = sorted(t_larges)[len(t_larges) // 2]
    wall_rate = iters / t_large
    rate = pair_rate(t_small, t_large)
    # Per-repeat single-pair rates, for spread fields that describe the
    # SAME samples as the median (no extra timed windows).
    singles = sorted(pair_rate(s, l) for s, l in zip(t_smalls, t_larges))
    return rate, wall_rate, singles


def iters_to_nonuniformity(stats, threshold=0.01):
    """First 1-based iteration whose spot nonuniformity (1 - uniformity)
    drops below ``threshold``; -1 if never reached in the run. The second
    half of the driver metric (BASELINE.json)."""
    nonu = 1.0 - np.asarray(stats)[:, 0, 1]
    hit = np.nonzero(nonu < threshold)[0]
    return int(hit[0]) + 1 if hit.size else -1


def bench_batch_scaling(sizes=(1, 2, 4, 8), N=1024, base_iters=2048):
    """
    Single-chip batch-scaling curve of the batched multiplane engine:
    whole-batch iterations/sec at ``n_planes`` in ``sizes`` on ONE
    device. Near-flat per-plane cost (rate_B ~ rate_1 / B) is the
    measurable half of the multi-chip story this environment allows —
    B planes data-parallel over a mesh would then recover rate_1 per
    plane, paying only the psum of the (slm_shape) nearfield sum.

    The marginal window scales as ``1/b`` so every batch size times
    a comparable amount of on-device work.
    """
    import jax

    from slmsuite_tpu.models.parallel_models import multiplane_batched

    out = {}
    for b in sizes:
        run = multiplane_batched(b, N=N)
        iters = max(64, base_iters // b)
        small = max(8, iters // 8)

        def once(n):
            t0 = time.time()
            jax.block_until_ready(run(None, n))
            return time.time() - t0

        once(small)
        once(iters)
        # Repeats with per-side medians + a spread field derived from
        # the same per-repeat samples.
        rate, _wall, singles = _marginal_rate(once, small, iters, repeats=3)
        out[f"b{b}"] = round(rate, 1)
        out[f"b{b}_window"] = iters
        out[f"b{b}_spread"] = round(
            (singles[-1] - singles[0]) / max(rate, 1e-9), 2
        )
    base = out.get("b1", 0.0)
    if base:
        # Per-plane efficiency vs perfect scaling: rate_B * B / rate_1.
        out[f"batch_efficiency_b{sizes[-1]}"] = round(
            out[f"b{sizes[-1]}"] * sizes[-1] / base, 3
        )
    return out


def _device_fields():
    """The device every result ran on, as JAX reports it."""
    import jax

    dev = jax.devices()[0]
    return {"device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}}


def config_2(argv, embed=None):
    """Headline: WGS-Kim 2048^2, 32x32 spots.

    ``embed``: extra fields folded into the emitted JSON object — the
    default run passes compact summaries of configs 1/3/4/5 (plus
    batch-scaling evidence) through here.
    """
    N = int(argv[0]) if argv else 2048
    iters = int(argv[1]) if len(argv) > 1 else 60
    from slmsuite_tpu.models import spot_array_wgs

    model = spot_array_wgs(N=N, n_side=32, spacing_div=70)
    rate, stats, provenance = bench_engine(model, iters)

    extra = {"iters_to_1pct_nonuniformity": iters_to_nonuniformity(stats)}
    extra.update(provenance)
    commit = _git_commit()
    if commit:
        extra["git_commit"] = commit
    if embed:
        extra.update(embed)
    return _emit(
        f"WGS-Kim iterations/sec at {N}x{N} (32x32 spots, device stats on)",
        rate, "iter/s", 1000.0,
        final_efficiency=round(float(stats[-1, 0, 0]), 4),
        final_uniformity=round(float(stats[-1, 0, 1]), 4),
        **_device_fields(),
        **extra,
    )


def config_1(argv):
    """GS, 1024^2, 10x10 grid, 50 iters."""
    N = int(argv[0]) if argv else 1024
    iters = int(argv[1]) if len(argv) > 1 else 50
    from slmsuite_tpu.models import spot_array_wgs

    rate, stats, prov = bench_engine(
        spot_array_wgs(N=N, n_side=10, spacing_div=24, method="GS"), iters
    )
    return _emit(
        f"GS iterations/sec at {N}x{N} (10x10 spots)",
        rate, "iter/s", 1000.0,
        final_efficiency=round(float(stats[-1, 0, 0]), 4),
        final_uniformity=round(float(stats[-1, 0, 1]), 4),
        iters_to_1pct_nonuniformity=iters_to_nonuniformity(stats),
        **prov,
    )


def config_3(argv):
    """MRAF ring-image hologram with nan noise region."""
    N = int(argv[0]) if argv else 2048
    iters = int(argv[1]) if len(argv) > 1 else 100

    from slmsuite_tpu.models import image_mraf

    model = image_mraf(N=N, mraf_factor=0.5)
    rate, stats, prov = bench_engine(model, iters)
    return _emit(
        f"MRAF WGS-Leonardo iterations/sec at {N}x{N} (ring target)",
        rate, "iter/s", 1000.0,
        final_efficiency=round(float(stats[-1, 0, 0]), 4),
        **prov,
    )


def config_4(argv):
    """Camera-in-the-loop WGS on the simulated rig. The qualifying
    simulated rig runs DEVICE-RESIDENT: the whole measurement (display
    quantization, far-field, camera sampling, spot windows) and the
    weight update execute inside the scanned engine
    (feedback mode "experimental_spot_sim"); no host hop per iteration."""
    iters = int(argv[0]) if argv else 10

    from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_tpu.hardware.cameraslms import FourierSLM
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import SpotHologram

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

    spot_ij = np.array(
        [[160.0, 256, 352, 256], [256.0, 160, 256, 352]]
    )
    holo = SpotHologram((1024, 1024), spot_ij, basis="ij", cameraslm=fs)
    holo.optimize("WGS-Kim", maxiter=5, verbose=False)  # Warm computational.
    # Warm the stepwise experimental path too (jitted forward/backward and
    # the camera sampler compile on first use).
    holo.optimize(
        "WGS-Kim", maxiter=2, verbose=False,
        feedback="experimental_spot", stat_groups=["experimental_spot"],
    )

    # Marginal (long-minus-short) rate: cancels the per-optimize fixed
    # cost (state build and sync), isolating the per-iteration
    # closed-loop cost that the metric names.
    small = max(1, iters // 4)

    def once(n):
        t0 = time.time()
        holo.optimize(
            "WGS-Kim", maxiter=n, verbose=False,
            feedback="experimental_spot", stat_groups=["experimental_spot"],
        )
        return time.time() - t0

    rate, wall_rate, singles = _marginal_rate(once, small, iters)
    unif = holo.stats["stats"]["experimental_spot"]["uniformity"][-1]
    # Baseline 10 iter/s: the closed-loop target set by the round-2
    # review ("config-4 >= 10 iter/s"), originally scoped for a
    # host-paced loop; the device-resident scan is bounded by the two
    # FFT pairs per iteration instead (BASELINE.md names no reference
    # number for this config).
    return _emit(
        "closed-loop WGS marginal iterations/sec "
        "(simulated camera feedback, 1024^2)",
        rate, "iter/s", 10.0,
        estimator="marginal (long-minus-short), clamped <= 2x wall",
        wall_iter_s=round(wall_rate, 2),
        iter_s_spread=round((singles[-1] - singles[0]) / max(rate, 1e-9), 3),
        measured_uniformity=round(float(unif), 4),
    )


def config_5(argv):
    """Zernike 3D compressed spot array."""
    n_spots = int(argv[0]) if argv else 256
    iters = int(argv[1]) if len(argv) > 1 else 30

    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM
    from slmsuite_tpu.holography.algorithms import CompressedSpotHologram

    extra = {"kernel_parity": attest_compressed_parity()}

    slm = SimulatedSLM(resolution=(1024, 1024), pitch_um=(8, 8), wav_um=0.78)
    rng = np.random.default_rng(0)
    side = int(np.sqrt(n_spots))
    kx, ky = np.meshgrid(
        np.linspace(-8e-3, 8e-3, side), np.linspace(-8e-3, 8e-3, side)
    )
    focus = rng.uniform(-2e-6, 2e-6, kx.size)
    spots = np.vstack([kx.ravel(), ky.ravel(), focus])

    holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=slm)
    # Marginal (long-minus-short) rate, like the headline: each
    # optimize() call pays a fixed host<->device round trip (psi
    # upload, amp_ff materialization); differencing isolates the
    # per-iteration cost. Warm both lengths (the scanned engine
    # compiles per scan length).
    small = max(1, iters // 5)

    def once(n):
        t0 = time.time()
        holo.optimize("WGS-Kim", maxiter=n, verbose=False)
        return time.time() - t0

    once(small)
    once(iters)
    rate, wall_rate, singles = _marginal_rate(once, small, iters)
    cv = float(np.std(holo.amp_ff) / np.mean(holo.amp_ff))
    # Baseline 100 iter/s: the compressed-transform target set by the
    # round-2 review ("config-5 >= 100 iter/s") — the sincos-bound cost
    # of the grid-free Zernike transform pair at 1024^2 x 256 spots
    # (BASELINE.md names no reference number for this config).
    return _emit(
        f"compressed 3D-spot WGS marginal iterations/sec "
        f"({kx.size} spots, 1024^2 SLM)",
        rate, "iter/s", 100.0,
        estimator="marginal (long-minus-short), clamped <= 2x wall",
        wall_iter_s=round(wall_rate, 2),
        iter_s_spread=round((singles[-1] - singles[0]) / max(rate, 1e-9), 3),
        amp_cv=float(f"{cv:.3g}"),
        **extra,
    )


#: Fields worth carrying from a full config result into the compact
#: per-config summary embedded in the headline line.
_COMPACT_KEYS = (
    "unit", "vs_baseline", "kernel_parity", "estimator", "wall_iter_s",
    "final_efficiency", "final_uniformity", "measured_uniformity",
    "amp_cv", "iters_to_1pct_nonuniformity",
    # Repeat evidence: without the spread a per-config rate is a
    # single sample.
    "iter_s_spread", "timing_window_iters",
)


def _compact(result):
    """Compact summary of a config result dict for headline embedding."""
    out = {"iter_s": result.get("value")}
    for key in _COMPACT_KEYS:
        if key in result:
            out[key] = result[key]
    return out


def main():
    argv = sys.argv[1:]
    from slmsuite_tpu.misc.compile_cache import enable_compile_cache
    from slmsuite_tpu.ops.platform import accelerator

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    if accelerator() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {accelerator()!r}.")
    configs = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}
    if argv and argv[0] == "--config":
        try:
            config = configs[int(argv[1])]
        except (KeyError, ValueError, IndexError):
            sys.exit(f"Usage: bench.py [--config {{1..5}}] [size] [iters] "
                     f"(got {argv[1:2]})")
        config(argv[2:])
        return

    headline_only = bool(argv and argv[0] == "--headline")
    if headline_only:
        argv = argv[1:]

    # The HEADLINE runs (and prints) FIRST: a hang in the extras must not
    # cost the headline — the plain line printed here is the tail until
    # the richer combined line below supersedes it.
    headline = config_2(argv)
    if headline_only:
        return

    # Extras: compact summaries of configs 1/3/4/5 and the batch-scaling
    # curve, EMBEDDED in a re-emitted
    # headline line (the standalone per-config lines are for interactive
    # reading only). Each extra is exception-guarded AND runs under a
    # SIGALRM watchdog so an in-config device stall cannot hang the
    # process past the budget.
    import signal

    deadline = time.time() + float(
        os.environ.get("SLMSUITE_TPU_BENCH_BUDGET_S", 900)
    )

    def with_watchdog(fn, *args):
        remaining = deadline - time.time()
        if remaining <= 1:
            raise TimeoutError("bench budget exhausted")
        if hasattr(signal, "SIGALRM"):
            def on_alarm(signum, frame):
                raise TimeoutError("bench budget exhausted (watchdog)")

            prev = signal.signal(signal.SIGALRM, on_alarm)
            signal.alarm(int(remaining) + 1)
            try:
                return fn(*args)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, prev)
        return fn(*args)

    summaries = {}
    for n, args in ((1, ["1024", "30"]), (3, ["2048", "40"]),
                    (4, ["8"]), (5, ["256", "20"])):
        try:
            summaries[f"c{n}"] = _compact(with_watchdog(configs[n], args))
        except Exception as exc:  # noqa: BLE001 - report, keep headline
            summaries[f"c{n}"] = {
                "error": f"{type(exc).__name__}: {exc}"[:200]
            }
            print(json.dumps(
                {"metric": f"config_{n}", "error": f"{type(exc).__name__}: {exc}"}
            ))
    embed = {"configs": summaries}
    for key, fn in (("batch_scaling_iter_s", bench_batch_scaling),):
        try:
            embed[key] = with_watchdog(fn)
        except Exception as exc:  # noqa: BLE001 - report, keep headline
            embed[key] = {"error": f"{type(exc).__name__}: {exc}"[:200]}

    # Final (tail) line: the headline metrics with all evidence embedded.
    final = dict(headline)
    final.update(embed)
    print(json.dumps(final))


if __name__ == "__main__":
    main()
