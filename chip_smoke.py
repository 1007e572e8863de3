#!/usr/bin/env python3
"""Smoke run of cubed_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build every hand-written CUDA kernel from the sources in this checkout
   (one nvcc per source, all at once) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time both (CUDA events):
   philox_uniform bit for bit (and against numpy's Philox stream),
   region_sum within 1e-12 (float64) / 1e-6 (float32) of the sum of
   magnitudes, int64 exactly, fma_sum within 1e-12 of the sum of the terms'
   magnitudes (contiguous blocks, block views of a (499, 450, 400) array as
   the device executor passes them, ragged, float32, sizes 1, 7 and 0);
   two launches on one input bitwise equal; torch.sum is timed beside
   region_sum (no single torch call computes fma_sum's function);
4. drive the main path through the public entry points, on the default
   sequential executor and on the device executor (``CudaExecutor``):
   addsum, ``sum(a + b)`` at (5000, 5000) / 1000, then pangeo-vorticity,
   ``mean(a[1:]*x[1:] + b[1:]*y[1:])`` at (500, 450, 400) / 100, each
   checked against a numpy oracle that draws the same per-block Philox
   streams itself (rtol 1e-12). Kernel launch counts are zeroed just before
   and read just after each run; vorticity must launch philox_uniform
   exactly 400 times on both executors, region_sum at least 100 times on the
   sequential one, and fma_sum exactly 100 times on the device executor,
   which must also take no fallback, stay under its residency budget and
   leave chunk files for the output alone;
5. run vorticity's plan once more on each executor under torch.profiler:
   the sequential one op by op, timing each op kind, the device executor
   whole, with its ops' host times from its callbacks; both with the
   device's busy time and idle share.

The last three lines of standard output are the nvidia-smi line, the JSON
line of kernels, and ``{"ok": true, "device": {...}}``. Intermediate Zarr
stores go to ``.chip_smoke_work/`` in this checkout and are removed at exit.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, ".chip_smoke_work")

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
#: float32 rate, used as the rate of the adds and integer multiplies counted
#: below (an upper rate gives a lower, still valid, bound)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

#: GPU clock cycles the spin kernel holds the stream before a timed run
#: (about 50 ms at the H100's 1.98 GHz boost clock)
SPIN_CYCLES = 100_000_000

ADDSUM = dict(shape=(5000, 5000), chunks=1000)
VORTICITY = dict(shape=(500, 450, 400), chunks=100)
SEED = 20261017


#: the card's name and power limit, as nvidia-smi gives them (set by main)
CARD = "card not read"


class PhaseFailed(Exception):
    pass


def smi_tag() -> str:
    return f"card: {CARD}"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def time_ms(torch, fn, args_list, reps: int = 20) -> float:
    """Mean milliseconds per call of ``fn(*args)`` over CUDA events, cycling
    through ``args_list`` (distinct buffers, so the 50 MB L2 holds little of
    a call's data), after a warm-up. A spin kernel runs first, so the host
    enqueues every launch before the first one starts and the events time
    the device work, not the host's launch rate."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_philox(torch) -> dict:
    from cubed_tpu_torch.kernels.philox_uniform import (
        philox_key, philox_uniform, philox_uniform_plain,
    )

    dev = torch.device("cuda")
    max_err = 0.0
    for shape in [(100, 100, 100), (99, 100, 100), (1000, 1000), (7,)]:
        for seed in [0, 1, 123456789, 2**30 - 1 + 99]:
            key = philox_key(seed)
            out = philox_uniform(torch.empty(shape, dtype=torch.float64, device=dev), key)
            plain = philox_uniform_plain(out.numel(), key, device=dev).reshape(shape)
            torch.cuda.synchronize()
            ref = np.random.Generator(np.random.Philox(seed=seed)).random(shape)
            got = out.cpu().numpy()
            check(np.array_equal(got.view(np.uint64), ref.view(np.uint64)),
                  f"philox_uniform {shape} seed {seed} differs from numpy")
            check(torch.equal(out, plain), f"philox_uniform {shape} seed {seed} differs from plain")
            max_err = max(max_err, float((out - plain).abs().max()))
    print("philox_uniform: bit-exact against numpy and the plain version, "
          "shapes (100,100,100) (99,100,100) (1000,1000) (7,), 4 seeds each")

    shape = (100, 100, 100)  # one block of the main path
    n = int(np.prod(shape))
    outs = [(torch.empty(shape, dtype=torch.float64, device=dev), philox_key(s)) for s in range(8)]
    ms = time_ms(torch, philox_uniform, outs)
    plain_ms = time_ms(torch, lambda k: philox_uniform_plain(n, k, device=dev), [(philox_key(1),)], reps=5)
    counters = -(-n // 4)
    b, by = bound_ms(8 * n, 40 * counters)  # 8 B written; 2x(hi, lo) x 10 rounds
    print(f"philox_uniform {shape} f64: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, bound {b:.5f} ms ({by})")
    return dict(
        name="philox_uniform", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/philox_uniform.cu",
        replaces="cubed_tpu/random.py:217 (_random_block; _philox_block :137)",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
    )


def check_region_sum(torch) -> dict:
    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [
        ((100, 100, 100), None), ((100, 100, 100), (0,)), ((100, 100, 100), (1, 2)),
        ((99, 37, 101), None), ((99, 37, 101), (0,)), ((99, 37, 101), (1, 2)),
        ((100, 50, 100), None), ((2, 1, 1), None), ((5000, 5000), (1,)),
    ]
    # a sum taken in another order differs by rounding relative to the sum
    # of magnitudes (which, for the main path's non-negative data, is the
    # sum itself): |kernel - plain| <= rtol * sum(|x|)
    tol = {torch.float64: 1e-12, torch.float32: 1e-6}
    max_err = 0.0
    for shape, axes in cases:
        for dt in (torch.float64, torch.float32, torch.int64):
            if dt == torch.int64:
                x = torch.randint(-(10**12), 10**12, shape, generator=gen, device=dev)
            else:
                x = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 100 - 50).to(dt)
            a = region_sum(x, axes)
            b = region_sum(x, axes)
            p = region_sum_plain(x, axes)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"region_sum {shape} {axes} {dt}: two launches differ")
            check(a.shape == p.shape and a.dtype == p.dtype, f"region_sum {shape} {axes} {dt}: shape/dtype")
            if dt == torch.int64:
                check(torch.equal(a, p), f"region_sum {shape} {axes} int64 not exact")
            else:
                scale = region_sum_plain(x.double().abs(), axes)
                ok = bool(((a.double() - p.double()).abs() <= tol[dt] * scale).all())
                check(ok, f"region_sum {shape} {axes} {dt} beyond rtol {tol[dt]} of sum(|x|)")
                if dt == torch.float64:
                    max_err = max(max_err, float((a - p).abs().max()))
    print("region_sum: float64 within 1e-12 and float32 within 1e-6 of sum(|x|), int64 exact, "
          "repeat launches bitwise equal, over", len(cases), "shape/axis cases")

    shape = (100, 100, 100)  # the main path's initial_reduce block
    xs = [(torch.rand(shape, generator=gen, device=dev, dtype=torch.float64),) for _ in range(8)]
    ms = time_ms(torch, lambda x: region_sum(x, None), xs)
    plain_ms = time_ms(torch, lambda x: region_sum_plain(x, None), xs)
    library_ms = time_ms(torch, lambda x: torch.sum(x), xs)
    n = int(np.prod(shape))
    b, by = bound_ms(8 * n + 8, n)
    print(f"region_sum {shape} f64 all axes: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, "
          f"torch.sum {library_ms:.5f} ms, bound {b:.5f} ms ({by})")
    return dict(
        name="region_sum", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/region_sum.cu",
        replaces="cubed_tpu/kernels/reductions.py:192 (region_sum; block_sum :84) at 0cd9f84^",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=library_ms,
    )


def check_fma_sum(torch) -> dict:
    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    # four resident-sized arrays, as the index ops leave them: the device
    # executor hands fma_sum (100, 100, 100) views with strides (180000, 400, 1)
    bases = [torch.rand((499, 450, 400), generator=gen, device=dev, dtype=torch.float64)
             for _ in range(4)]

    def rand(shape, dt=torch.float64):
        return [torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(dt) for _ in range(4)]

    cases = [
        ("(100,100,100) contiguous", rand((100, 100, 100))),
        ("(100,100,100) view of (499,450,400)", [b[100:200, 200:300, 0:100] for b in bases]),
        ("(99,50,100) ragged view", [b[400:499, 400:450, 300:400] for b in bases]),
        ("(99,100,50)", rand((99, 100, 50))),
        ("(99,100,50) float32", rand((99, 100, 50), torch.float32)),
        ("(100,100,100) float32 view", [t[50:150, 25:125, 100:200] for t in rand((200, 150, 200), torch.float32)]),
        ("size 1", rand((1,))),
        ("size 7", rand((7,))),
        ("size 0", rand((0, 5))),
    ]
    # the products and their sum round alike in both; only the order of the
    # float64 sum differs: |kernel - plain| <= 1e-12 * sum(|a*x| + |b*y|)
    max_err = 0.0
    for label, (a, x, b, y) in cases:
        k1 = fma_sum(a, x, b, y)
        k2 = fma_sum(a, x, b, y)
        p = fma_sum_plain(a, x, b, y)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"fma_sum {label}: two launches differ")
        check(k1.shape == p.shape and k1.dtype == p.dtype == torch.float64, f"fma_sum {label}: shape/dtype")
        scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
        err = float((k1 - p).abs().max()) if k1.numel() else 0.0
        check(err <= 1e-12 * scale, f"fma_sum {label}: |kernel - plain| {err} beyond 1e-12 * {scale}")
        max_err = max(max_err, err)
    print("fma_sum: within 1e-12 of sum(|a*x| + |b*y|) of the plain version, repeat launches "
          "bitwise equal, over", len(cases), "cases:", ", ".join(label for label, _ in cases))

    # timing at the main path's shape: distinct block views (256 MB of reads
    # in all, past the 50 MB L2)
    views = [tuple(base[i * 100:(i + 1) * 100, j * 100:(j + 1) * 100, 0:100] for base in bases)
             for i, j in itertools.product(range(4), range(2))]
    ms = time_ms(torch, fma_sum, views)
    plain_ms = time_ms(torch, fma_sum_plain, views)
    n = 100 * 100 * 100
    b, by = bound_ms(4 * 8 * n + 8, 3 * n)  # 4 inputs read, one float64 written; 2 mul + 1 add
    print(f"fma_sum (100,100,100) f64 views: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, "
          f"bound {b:.5f} ms ({by}); {smi_tag()}")
    return dict(
        name="fma_sum", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/fma_sum.cu",
        replaces="cubed_tpu/kernels/reductions.py:257 (fused_fma_mean; pallas_call :300) at 0cd9f84^",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
    )


# ---------------------------------------------------------------------------
# phase 4: the main path and its oracle
# ---------------------------------------------------------------------------


def oracle_random(shape, chunks, root_seed) -> np.ndarray:
    """numpy's own per-block streams: block at linear offset k draws from
    Philox(seed=root_seed + k)."""
    out = np.empty(shape, dtype=np.float64)
    grids = [range(0, s, chunks) for s in shape]
    nblocks = [len(g) for g in grids]
    for idx in np.ndindex(*nblocks):
        sel = tuple(slice(i * chunks, min((i + 1) * chunks, s)) for i, s in zip(idx, shape))
        bshape = tuple(s.stop - s.start for s in sel)
        k = int(np.ravel_multi_index(idx, nblocks))
        out[sel] = np.random.Generator(np.random.Philox(seed=root_seed + k)).random(bshape)
    return out


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its CUDA launches."""
    from cubed_tpu_torch.kernels.fma_sum import fma_sum
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.kernels.region_sum import region_sum

    return {"philox_uniform": philox_uniform, "region_sum": region_sum, "fma_sum": fma_sum}


def stores_with_chunks(work_dir: str) -> set:
    """The Zarr stores under *work_dir* that hold any chunk file."""
    found = set()
    for root, _, files in os.walk(work_dir):
        if root.endswith(".zarr") and any(f != ".zarray" for f in files):
            found.add(root)
    return found


def run_main_path(torch, name: str, executor_name: str, build, expected: float,
                  counts_required: dict) -> dict:
    """Compute one configuration on one executor ("sequential" or "cuda"),
    check it against the oracle's *expected* value and the kernel launch
    counts; for the device executor also its fallback counters, its peak
    memory against its budget, and that only the output reached storage."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    work = os.path.join(WORK_DIR, f"{name}-{executor_name}")
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB")
    random.seed(SEED)
    result = build(spec)
    plan = result.plan._finalize(array_names=(result.name,))
    projected = plan.max_projected_mem()
    executor = CudaExecutor() if executor_name == "cuda" else None
    wrappers = kernel_wrappers()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    value = result.compute(executor=executor)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    stored = stores_with_chunks(work)
    shutil.rmtree(work, ignore_errors=True)

    label = f"{name} [{executor_name}]"
    value = float(value)
    rel = abs(value - expected) / abs(expected)
    print(f"{label}: compute() {elapsed:.3f} s ({plan.num_tasks()} tasks, {plan.num_ops()} ops), "
          f"value {value!r}, numpy oracle {expected!r}, rel err {rel:.3e}; {smi_tag()}")
    print(f"{label}: max_projected_mem {projected} B, torch.cuda.max_memory_allocated {peak} B")
    print(f"{label}: launches {json.dumps(launches)}")
    check(np.isfinite(value), f"{label}: value is not finite")
    check(rel <= 1e-12, f"{label}: value differs from the numpy oracle beyond rtol 1e-12")
    for kname, (lo, hi) in counts_required.items():
        n = launches[kname]
        check(lo <= n <= hi, f"{label}: {kname} launched {n} times, expected [{lo}, {hi}]")
    if executor is not None:
        budget = executor._budget(spec, torch.device("cuda"))
        stats = dict(sorted(executor.stats.items()))
        print(f"{label}: executor stats {json.dumps(stats)}; residency budget {budget} B")
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors"):
            check(stats.get(counter, 0) == 0, f"{label}: {counter} = {stats.get(counter)}")
        check(peak <= budget, f"{label}: peak device memory {peak} B over the budget {budget} B")
        output_store = os.path.normpath(result.zarray_maybe_lazy.store)
        check({os.path.normpath(p) for p in stored} == {output_store},
              f"{label}: chunk files in {sorted(stored)}, expected the output's alone")
    return launches


def addsum_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    shape, chunks = ADDSUM["shape"], ADDSUM["chunks"]
    a = cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec)
    b = cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec)
    return xp.sum(xp.add(a, b))


def addsum_oracle() -> float:
    shape, chunks = ADDSUM["shape"], ADDSUM["chunks"]
    a, b = [oracle_random(shape, chunks, random.getrandbits(30)) for _ in range(2)]
    return float(np.sum(a + b))


def vorticity_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    shape, chunks = VORTICITY["shape"], VORTICITY["chunks"]
    a, b, x, y = [cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def vorticity_oracle() -> float:
    shape, chunks = VORTICITY["shape"], VORTICITY["chunks"]
    a, b, x, y = [oracle_random(shape, chunks, random.getrandbits(30)) for _ in range(4)]
    return float(np.mean(a[1:] * x[1:] + b[1:] * y[1:]))


# ---------------------------------------------------------------------------
# phase 5: where the time goes
# ---------------------------------------------------------------------------


def profiled(torch, fn) -> tuple:
    """Run *fn* under torch.profiler's CUDA activity; returns (wall seconds,
    kernel seconds, copy seconds, the five kernels with the most device
    time, why the device time is missing or None)."""
    from torch.profiler import ProfilerActivity, profile

    prof, why = profile(activities=[ProfilerActivity.CUDA]), "the profiler recorded no device events"
    t0 = time.perf_counter()
    try:
        prof.start()
    except (AssertionError, RuntimeError) as e:  # no CUDA tracing available here
        prof, why = None, f"the profiler did not start: {e!r}"
    try:
        fn()
    finally:
        if prof is not None:
            prof.stop()
    wall = time.perf_counter() - t0
    kernels_s = copies_s = 0.0
    by_kernel = []
    for e in prof.key_averages() if prof is not None else ():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e6
        if e.key.startswith(("Memcpy", "Memset")):
            copies_s += t
        else:
            kernels_s += t
            by_kernel.append((t, e.count, e.key))
    top = sorted(by_kernel, reverse=True)[:5]
    return wall, kernels_s, copies_s, top, None if kernels_s + copies_s > 0 else why


def print_device_split(label: str, wall, kernels_s, copies_s, top, why) -> None:
    if why is not None:
        print(f"{label}: device busy time not measured ({why})")
        return
    busy = kernels_s + copies_s
    print(f"{label}: device busy {busy:.4f} s (kernels {kernels_s:.4f} s, copies {copies_s:.4f} s) "
          f"= {100 * busy / wall:.2f}% of wall; idle share {100 * (1 - busy / wall):.2f}%; {smi_tag()}")
    print(f"{label}: top kernels by device time: " + "; ".join(
        f"{key[:60]} {t * 1e3:.3f} ms / {n}" for t, n, key in top))


def breakdown(torch, name: str, build) -> None:
    """Sequential executor: run the plan again with its ops one at a time, in
    the sequential executor's order, each timed on the host clock up to a
    synchronize, under torch.profiler for the device's busy time."""
    import cubed_tpu_torch

    spec = cubed_tpu_torch.Spec(work_dir=os.path.join(WORK_DIR, f"{name}-breakdown"), allowed_mem="2GB")
    random.seed(SEED)
    result = build(spec)
    dag = result.plan._finalize(array_names=(result.name,)).dag
    per_kind: dict = {}

    def run_ops():
        for node in dag.topological_sort():
            op = dag.nodes[node].get("primitive_op")
            if op is None:
                continue
            t = time.perf_counter()
            for m in op.pipeline.mappable:
                op.pipeline.function(m, config=op.pipeline.config)
            torch.cuda.synchronize()
            kind = dag.nodes[node]["op_name"]
            per_kind[kind] = per_kind.get(kind, 0.0) + time.perf_counter() - t

    split = profiled(torch, run_ops)
    shutil.rmtree(spec.work_dir, ignore_errors=True)
    ops = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(per_kind.items(), key=lambda kv: -kv[1]))
    print(f"{name} breakdown [sequential]: wall {split[0]:.3f} s; by op kind: {ops}")
    print_device_split(f"{name} breakdown [sequential]", *split)


def breakdown_device(torch, name: str, build) -> None:
    """Device executor: compute once more under torch.profiler for the
    device's busy time and idle share; then run the plan again with the
    executor's ops one at a time, each timed on the host clock up to a
    synchronize (within a compute, a segment's ops share one time)."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.pipeline import visit_nodes

    spec = cubed_tpu_torch.Spec(work_dir=os.path.join(WORK_DIR, f"{name}-breakdown-cuda"), allowed_mem="2GB")
    random.seed(SEED)
    result = build(spec)

    def run():
        result.compute(executor=CudaExecutor())
        torch.cuda.synchronize()

    split = profiled(torch, run)
    shutil.rmtree(spec.work_dir, ignore_errors=True)
    print(f"{name} breakdown [cuda]: wall {split[0]:.3f} s")
    print_device_split(f"{name} breakdown [cuda]", *split)

    random.seed(SEED)
    result = build(spec)
    dag = result.plan._finalize(array_names=(result.name,)).dag
    ex = CudaExecutor()
    resident: dict = {}
    budget = ex._budget(spec, torch.device("cuda"))
    requested = {result.zarray_maybe_lazy.store}
    per_kind: dict = {}
    t0 = time.perf_counter()
    for op_name, node in visit_nodes(dag):
        t = time.perf_counter()
        in_segment = ex._classify(node["primitive_op"]) == "segment"
        ex._run([(op_name, node)], resident, budget, requested, None, in_segment=in_segment)
        torch.cuda.synchronize()
        kind = node["op_name"]
        per_kind[kind] = per_kind.get(kind, 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    for res in resident.values():
        if res.target.store in requested:
            ex._flush(res)
    per_kind["flush"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    shutil.rmtree(spec.work_dir, ignore_errors=True)
    ops = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(per_kind.items(), key=lambda kv: -kv[1]))
    print(f"{name} breakdown [cuda, op by op]: wall {wall:.3f} s; by op kind: {ops}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import cubed_tpu_torch  # noqa: F401
        from cubed_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: cubed_tpu_torch is not importable from {REPO}: {e}", file=sys.stderr)
        return 1
    os.environ["CUBED_TPU_TORCH_DEVICE"] = "cuda"

    global CARD
    CARD = smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")
    try:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(_build.SOURCES)})")

        kernels = [check_philox(torch), check_region_sum(torch), check_fma_sum(torch)]

        for name, build, oracle, required in [
            ("addsum", addsum_build, addsum_oracle, {
                "sequential": {"philox_uniform": (50, 50), "region_sum": (25, 10**9), "fma_sum": (0, 0)},
                "cuda": {"philox_uniform": (50, 50), "region_sum": (25, 10**9), "fma_sum": (0, 0)},
            }),
            ("vorticity", vorticity_build, vorticity_oracle, {
                "sequential": {"philox_uniform": (400, 400), "region_sum": (100, 10**9), "fma_sum": (0, 0)},
                "cuda": {"philox_uniform": (400, 400), "region_sum": (1, 10**9), "fma_sum": (100, 100)},
            }),
        ]:
            t1 = time.perf_counter()
            random.seed(SEED)
            expected = oracle()
            print(f"{name}: numpy oracle {time.perf_counter() - t1:.1f} s")
            launches = {ex: run_main_path(torch, name, ex, build, expected, req)
                        for ex, req in required.items()}
        # the kernels line reads this slice's main path: vorticity on the
        # device executor
        for k in kernels:
            k["launches"] = launches["cuda"][k["name"]]
        breakdown(torch, "vorticity", vorticity_build)
        breakdown_device(torch, "vorticity", vorticity_build)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(smi)
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
