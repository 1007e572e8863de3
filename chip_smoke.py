#!/usr/bin/env python3
"""Smoke run of cubed_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--against CHECKOUT]

Phases, in order; any failure ends the run with a nonzero exit code:

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build every hand-written CUDA kernel from the sources in this checkout
   (one nvcc per source, all at once), print the build seconds and each
   kernel's registers and spills (ptxas -v);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time both (CUDA events):
   philox_uniform bit for bit (and against numpy's Philox stream), its
   bound the larger of its bytes and its integer issue, counted from its
   SASS; region_sum within 1e-12 (float64) / 1e-6 (float32) of the sum of
   magnitudes, int64 exactly, fma_sum within 1e-12 of the sum of the terms'
   magnitudes (contiguous blocks, block views of a (499, 450, 400) array as
   the device executor passes them, misaligned and ragged views, reduced
   axes (0,) and (1, 2), combine-sized inputs, float32, sizes 1, 7 and 0);
   one launch per call and two launches on one input bitwise equal; every
   path of both (rows/columns, vector/scalar, one CTA/split) taken and
   printed per case; one kernel per call and no other kernel, counted by
   name under torch.profiler; region_sum's axis (0,) of a block view
   allocating no input-sized buffer; torch.sum is timed beside region_sum
   (also at a combine-sized input, at (5000, 5000) over axis (1,) and over
   axis (0,) of block views; no single torch call computes fma_sum's
   function). With ``--against CHECKOUT``, the fma_sum and region_sum of
   another checkout of this repo are built from its sources and timed
   beside these on the same inputs, in turns (theirs, ours, ours, theirs);
4. drive the main path through the public entry points, on the default
   sequential executor and on the device executor (``CudaExecutor``):
   addsum, ``sum(a + b)`` at (5000, 5000) / 1000, then pangeo-vorticity,
   ``mean(a[1:]*x[1:] + b[1:]*y[1:])`` at (500, 450, 400) / 100, each
   checked against a numpy oracle that draws the same per-block Philox
   streams itself (rtol 1e-12). Kernel launch counts are zeroed just before
   and read just after each run, with the paths each kernel took;
   vorticity must launch philox_uniform
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
#: float32 rate, used as the rate of the floating-point adds and multiplies
#: counted below (an upper rate gives a lower, still valid, bound)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

#: 32-bit integer issue on the H100 SXM, per pipe: 64 lanes per clock per SM
#: for integer add, multiply-add, shift and logic (CUDA C++ Programming
#: Guide, throughput of native arithmetic instructions, compute capability
#: 9.0), x 132 SMs x the 1980 MHz maximum SM clock (nvidia-smi
#: clocks.max.sm on an H100 80GB HBM3). IMAD issues on the FMA pipe; IADD3,
#: LOP3, SHF, ISETP, LEA, SEL, PRMT and MOV on the ALU pipe; the two run in
#: parallel, so the busier one bounds the time.
INT_LANES_PER_CLOCK_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
INT_ISSUE_PER_S = INT_LANES_PER_CLOCK_PER_SM * H100_SMS * H100_MAX_SM_CLOCK_HZ

#: philox_uniform_kernel's integer issue slots per counter, per pipe, counted
#: from ``cuobjdump -sass`` of its sm_90a build (nvcc 12.9; the ten rounds are
#: unrolled and each thread takes one counter, so the kernel's instructions
#: are one counter's). FMA pipe: 73 IMAD.WIDE.U32[.X] at two slots each (a
#: 64-bit result) + 21 IMAD.X + 10 IMAD.MOV.U32 + 1 IMAD.SHL.U32 = 178. ALU
#: pipe: 39 LOP3 + 41 IADD3[.X] + 9 SHF + 8 ISETP + 9 MOV + 2 LEA = 108.
#: Uniform-datapath instructions (once a warp) are not counted. Each run
#: counts them again from its own build (:func:`int_pipe_slots`).
PHILOX_FMA_PIPE_SLOTS = 178
PHILOX_ALU_PIPE_SLOTS = 108
_ALU_OPCODES = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "MOV")

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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_pipe_slots(opcodes: dict) -> tuple[int, int]:
    """(FMA-pipe, ALU-pipe) integer issue slots of one kernel's SASS opcode
    counts: IMAD.WIDE and IMAD.HI take two slots, other IMADs one."""
    fma = alu = 0
    for op, n in opcodes.items():
        if op.startswith("IMAD"):
            fma += n * (2 if ".WIDE" in op or ".HI" in op else 1)
        elif op.startswith(_ALU_OPCODES):
            alu += n
    return fma, alu


def kernel_launches_by_name(torch, fn) -> dict:
    """Device kernels launched while *fn* runs, by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0 and not e.key.startswith(("Memcpy", "Memset")):
            counts[e.key] = counts.get(e.key, 0) + e.count
    return counts


def print_resource_usage() -> None:
    """Registers a thread and spill bytes of every built kernel (ptxas -v)."""
    from cubed_tpu_torch.kernels import _build

    for name in _build.SOURCES:
        for fn, u in sorted(_build.resource_usage(name).items()):
            print(f"ptxas {name}: {fn}: {u.get('registers')} registers, "
                  f"{u.get('spill_stores')} B spill stores, {u.get('spill_loads')} B spill loads")


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
    fma, alu = PHILOX_FMA_PIPE_SLOTS, PHILOX_ALU_PIPE_SLOTS
    try:
        from cubed_tpu_torch.kernels import _build

        (opcodes,) = [c for f, c in _build.sass_opcodes("philox_uniform").items() if "philox" in f]
        fma, alu = int_pipe_slots(opcodes)
        print(f"philox_uniform SASS: {sum(opcodes.values())} instructions; integer issue slots per "
              f"counter: FMA pipe {fma}, ALU pipe {alu} (constants: {PHILOX_FMA_PIPE_SLOTS}, "
              f"{PHILOX_ALU_PIPE_SLOTS})")
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        print(f"philox_uniform SASS not counted in this run ({e!r}); the constants stand")
    # 8 B written per element; the busier integer pipe's slots for every counter
    b, by = bound_ms(8 * n, max(fma, alu) * counters, INT_ISSUE_PER_S)
    print(f"philox_uniform {shape} f64: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, bound {b:.5f} ms ({by}: "
          f"bytes {8 * n / HBM_BYTES_PER_S * 1e3:.5f} ms, integer issue "
          f"{max(fma, alu) * counters / INT_ISSUE_PER_S * 1e3:.5f} ms); {smi_tag()}")
    return dict(
        name="philox_uniform", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/philox_uniform.cu",
        replaces="cubed_tpu/random.py:217 (_random_block; _philox_block :137)",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
    )


#: region_sum's cases on the views the device executor passes, beside the
#: random shapes above: (label, input from a (499, 450, 400) base, axes)
REGION_VIEW_CASES = [
    ("(100,100,100) view of (499,450,400)", lambda b: b[100:200, 200:300, 0:100], None),
    ("(100,100,100) view one element off 16 B", lambda b: b[100:200, 200:300, 1:101], None),
    ("(99,50,100) ragged view", lambda b: b[400:499, 400:450, 300:400], None),
    ("(100,100,100) contiguous", lambda b: b[:100, :100, :100].contiguous(), None),
    ("(100,100,100) view, axis (0,)", lambda b: b[100:200, 200:300, 0:100], (0,)),
    ("(100,100,100) view, axes (1,2)", lambda b: b[100:200, 200:300, 0:100], (1, 2)),
    ("(5,5,4) combine", lambda b: b[:5, :5, :4].contiguous(), None),
    ("(5,5,4) combine, axis (0,)", lambda b: b[:5, :5, :4].contiguous(), (0,)),
    ("(4,1,4) combine view", lambda b: b[:5, :5, :4].contiguous()[1:, 1:2], None),
    ("size 0", lambda b: b[:0, :5, 0], None),
    ("size 1", lambda b: b[:1, 0, 0], None),
    ("(500,1000) axis (1,)", lambda b: b[:50, :100, :100].reshape(500, 1000), (1,)),
]


def paths_delta(wrapper, before: dict) -> str:
    return "+".join(k for k, v in wrapper.paths.items() if v > before[k])


def one_launch_per_call(torch, wrapper, kernel_key: str, calls: list) -> None:
    """Run *calls* (thunks) under torch.profiler: the device must run exactly
    one kernel named *kernel_key* per launch the wrapper counts, and no
    other kernel (no copy of an input, no second pass)."""
    before = wrapper.launches
    kernels = kernel_launches_by_name(torch, lambda: [c() for c in calls])
    launched = wrapper.launches - before
    ours = sum(n for k, n in kernels.items() if kernel_key in k)
    others = {k: n for k, n in kernels.items() if kernel_key not in k}
    print(f"{kernel_key}: {len(calls)} calls, {launched} counted launches, profiler: {ours} "
          f"{kernel_key} kernels, other kernels {others or 'none'}")
    check(ours == launched and not others,
          f"{kernel_key}: {ours} kernels and {others} for {launched} counted launches")


def check_region_sum(torch) -> dict:
    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [
        ((100, 100, 100), None), ((100, 100, 100), (0,)), ((100, 100, 100), (1, 2)),
        ((99, 37, 101), None), ((99, 37, 101), (0,)), ((99, 37, 101), (1, 2)),
        ((100, 50, 100), None), ((2, 1, 1), None), ((5000, 5000), (1,)),
    ]
    base64 = torch.rand((499, 450, 400), generator=gen, device=dev, dtype=torch.float64) * 100 - 50
    bases = {torch.float64: base64, torch.float32: base64.to(torch.float32),
             torch.int64: torch.randint(-(10**12), 10**12, (499, 450, 400), generator=gen, device=dev)}
    inputs = []  # (label, tensor, axes)
    for shape, axes in cases:
        for dt in (torch.float64, torch.float32, torch.int64):
            if dt == torch.int64:
                x = torch.randint(-(10**12), 10**12, shape, generator=gen, device=dev)
            else:
                x = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 100 - 50).to(dt)
            inputs.append((f"{shape} {axes}", x, axes))
    for label, make, axes in REGION_VIEW_CASES:
        for dt, base in bases.items():
            inputs.append((label, make(base), axes))
    # a sum taken in another order differs by rounding relative to the sum
    # of magnitudes: |kernel - plain| <= rtol * sum(|x|)
    tol = {torch.float64: 1e-12, torch.float32: 1e-6}
    max_err = 0.0
    taken = []
    for label, x, axes in inputs:
        dt = x.dtype
        before, paths = region_sum.launches, dict(region_sum.paths)
        a = region_sum(x, axes)
        launched = region_sum.launches - before
        b = region_sum(x, axes)
        p = region_sum_plain(x, axes)
        torch.cuda.synchronize()
        what = f"region_sum {label} {dt}"
        check(launched == (1 if a.numel() else 0), f"{what}: {launched} launches for one call")
        check(torch.equal(a, b), f"{what}: two launches differ")
        check(a.shape == p.shape and a.dtype == p.dtype, f"{what}: shape/dtype")
        if dt == torch.int64:
            check(torch.equal(a, p), f"{what}: int64 not exact")
        else:
            scale = region_sum_plain(x.double().abs(), axes)
            ok = bool(((a.double() - p.double()).abs() <= tol[dt] * scale).all())
            check(ok, f"{what}: beyond rtol {tol[dt]} of sum(|x|)")
            if dt == torch.float64 and a.numel():
                max_err = max(max_err, float((a - p).abs().max()))
        if dt == torch.float64:
            taken.append(f"{label}: {paths_delta(region_sum, paths) or 'no launch'}")
    print(f"region_sum: float64 within 1e-12 and float32 within 1e-6 of sum(|x|), int64 exact, "
          f"one launch per call, repeat launches bitwise equal, over {len(inputs)} cases")
    print("region_sum paths (float64): " + "; ".join(taken))
    check(all(region_sum.paths.values()), f"region_sum: a path never taken: {region_sum.paths}")

    f64_inputs = [(x, axes) for _, x, axes in inputs if x.dtype == torch.float64]
    one_launch_per_call(torch, region_sum, "region_sum", [lambda x=x, a=axes: region_sum(x, a)
                                                          for x, axes in f64_inputs])

    # axis (0,) of a strided view: read in place, no buffer of the input's size
    view = base64[100:200, 200:300, 0:100]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    region_sum(view, (0,))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - start
    print(f"region_sum (100,100,100) view, axis (0,): {extra} B allocated at peak "
          f"(the input is {view.numel() * 8} B)")
    check(extra < view.numel() * 8 // 4, f"region_sum axis (0,): {extra} B allocated")

    shape = (100, 100, 100)  # the main path's initial_reduce block
    xs = [(torch.rand(shape, generator=gen, device=dev, dtype=torch.float64),) for _ in range(8)]
    ms = time_ms(torch, lambda x: region_sum(x, None), xs)
    plain_ms = time_ms(torch, lambda x: region_sum_plain(x, None), xs)
    library_ms = time_ms(torch, lambda x: torch.sum(x), xs)
    n = int(np.prod(shape))
    b, by = bound_ms(8 * n + 8, n)
    print(f"region_sum {shape} f64 all axes: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, "
          f"torch.sum {library_ms:.5f} ms, bound {b:.5f} ms ({by}); {smi_tag()}")
    for label, args, axes, nbytes in region_timings(torch, gen, base64):
        t = time_ms(torch, lambda x: region_sum(x, axes), args)
        t_lib = time_ms(torch, lambda x: torch.sum(x, dim=axes or tuple(range(x.ndim)), keepdim=True), args)
        print(f"region_sum {label}: {t:.5f} ms/launch, torch.sum {t_lib:.5f} ms, "
              f"bound {bound_ms(nbytes, 0)[0]:.5f} ms (bytes); {smi_tag()}")
    del bases, base64
    return dict(
        name="region_sum", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/region_sum.cu",
        replaces="cubed_tpu/kernels/reductions.py:192 (region_sum; block_sum :84) at 0cd9f84^",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=library_ms,
    )


def region_timings(torch, gen, base64) -> list:
    """(label, argument tuples, axes, bytes read and written) of region_sum's
    further timed shapes: the main path's block views, a combine-sized input,
    the (5000, 5000) addsum-sized rows, and axis (0,) of a block view."""
    views = [(base64[i * 100:(i + 1) * 100, j * 100:(j + 1) * 100, 0:100],)
             for i, j in itertools.product(range(4), range(2))]
    combine = [(torch.rand((5, 5, 4), generator=gen, device="cuda", dtype=torch.float64),) for _ in range(8)]
    rows = [(torch.rand((5000, 5000), generator=gen, device="cuda", dtype=torch.float64),) for _ in range(2)]
    return [
        ("(100,100,100) f64 views of (499,450,400), all axes", views, None, 8e6 + 8),
        ("(5,5,4) f64 combine, all axes", combine, None, 800 + 8),
        ("(5000,5000) f64, axis (1,)", rows, (1,), 2e8 + 4e4),
        ("(100,100,100) f64 views, axis (0,)", views, (0,), 8e6 + 8e4),
    ]


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
        ("(100,100,100) view one element off 16 B", [b[100:200, 200:300, 1:101] for b in bases]),
        ("(99,50,100) ragged view", [b[400:499, 400:450, 300:400] for b in bases]),
        ("(99,100,50)", rand((99, 100, 50))),
        ("(99,100,50) float32", rand((99, 100, 50), torch.float32)),
        ("(100,100,100) float32 view", [t[50:150, 25:125, 100:200] for t in rand((200, 150, 200), torch.float32)]),
        ("(5,5,4) combine", rand((5, 5, 4))),
        ("size 1", rand((1,))),
        ("size 7", rand((7,))),
        ("size 0", rand((0, 5))),
    ]
    # the products and their sum round alike in both; only the order of the
    # float64 sum differs: |kernel - plain| <= 1e-12 * sum(|a*x| + |b*y|)
    max_err = 0.0
    taken = []
    for label, (a, x, b, y) in cases:
        before, paths = fma_sum.launches, dict(fma_sum.paths)
        k1 = fma_sum(a, x, b, y)
        launched = fma_sum.launches - before
        k2 = fma_sum(a, x, b, y)
        p = fma_sum_plain(a, x, b, y)
        torch.cuda.synchronize()
        check(launched == 1, f"fma_sum {label}: {launched} launches for one call")
        check(torch.equal(k1, k2), f"fma_sum {label}: two launches differ")
        check(k1.shape == p.shape and k1.dtype == p.dtype == torch.float64, f"fma_sum {label}: shape/dtype")
        scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
        err = float((k1 - p).abs().max()) if k1.numel() else 0.0
        check(err <= 1e-12 * scale, f"fma_sum {label}: |kernel - plain| {err} beyond 1e-12 * {scale}")
        max_err = max(max_err, err)
        taken.append(f"{label}: {paths_delta(fma_sum, paths)}")
    print("fma_sum: within 1e-12 of sum(|a*x| + |b*y|) of the plain version, one launch per call, "
          "repeat launches bitwise equal, over", len(cases), "cases")
    print("fma_sum paths: " + "; ".join(taken))
    check(all(fma_sum.paths.values()), f"fma_sum: a path never taken: {fma_sum.paths}")
    one_launch_per_call(torch, fma_sum, "fma_sum", [lambda ts=ts: fma_sum(*ts) for _, ts in cases])

    # timing at the main path's shape: distinct block views (256 MB of reads
    # in all, past the 50 MB L2)
    views = main_path_views(bases)
    ms = time_ms(torch, fma_sum, views)
    plain_ms = time_ms(torch, fma_sum_plain, views)
    n = 100 * 100 * 100
    b, by = bound_ms(4 * 8 * n + 8, 3 * n)  # 4 inputs read, one float64 written; 2 mul + 1 add
    print(f"fma_sum (100,100,100) f64 views: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, "
          f"bound {b:.5f} ms ({by}); {smi_tag()}")
    del bases
    return dict(
        name="fma_sum", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/fma_sum.cu",
        replaces="cubed_tpu/kernels/reductions.py:257 (fused_fma_mean; pallas_call :300) at 0cd9f84^",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
    )


def main_path_views(bases) -> list:
    """Eight sets of four (100, 100, 100) block views of the four bases."""
    return [tuple(base[i * 100:(i + 1) * 100, j * 100:(j + 1) * 100, 0:100] for base in bases)
            for i, j in itertools.product(range(4), range(2))]


def compare_against(torch, path: str) -> None:
    """Time this checkout's fma_sum and region_sum beside another checkout's
    (at *path*, built from its own sources) on the same inputs, in turns:
    theirs, ours, ours, theirs."""
    import importlib
    import importlib.util

    from cubed_tpu_torch.kernels import fma_sum as ours_fma, region_sum as ours_region

    kdir = os.path.join(os.path.abspath(path), "cubed_tpu_torch", "kernels")
    spec = importlib.util.spec_from_file_location(
        "against_kernels", os.path.join(kdir, "__init__.py"), submodule_search_locations=[kdir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["against_kernels"] = pkg
    spec.loader.exec_module(pkg)
    theirs_fma = importlib.import_module("against_kernels.fma_sum")
    theirs_region = importlib.import_module("against_kernels.region_sum")
    importlib.import_module("against_kernels._build").build_all()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bases = [torch.rand((499, 450, 400), generator=gen, device="cuda", dtype=torch.float64)
             for _ in range(4)]
    blocks = [(torch.rand((100, 100, 100), generator=gen, device="cuda", dtype=torch.float64),)
              for _ in range(8)]
    def region(m, axes):
        return lambda x: m.region_sum(x, axes)

    cases = [
        ("fma_sum (100,100,100) f64 views", lambda m: m.fma_sum, (ours_fma, theirs_fma), main_path_views(bases)),
        ("region_sum (100,100,100) f64 contiguous, all axes", lambda m: region(m, None),
         (ours_region, theirs_region), blocks),
    ] + [(f"region_sum {label}", lambda m, axes=axes: region(m, axes), (ours_region, theirs_region), args)
         for label, args, axes, _ in region_timings(torch, gen, bases[0])]
    for label, get, (ours, theirs), args in cases:
        times = [time_ms(torch, get(m), args) for m in (theirs, ours, ours, theirs)]
        print(f"against {path}: {label}: theirs {times[0]:.5f} / {times[3]:.5f} ms, "
              f"ours {times[1]:.5f} / {times[2]:.5f} ms; {smi_tag()}")


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
    paths = {k: dict(w.paths) for k, w in wrappers.items() if hasattr(w, "paths")}
    t0 = time.perf_counter()
    value = result.compute(executor=executor)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    paths = {k: {p: wrappers[k].paths[p] - n for p, n in before.items() if wrappers[k].paths[p] > n}
             for k, before in paths.items()}
    peak = torch.cuda.max_memory_allocated()
    stored = stores_with_chunks(work)
    shutil.rmtree(work, ignore_errors=True)

    label = f"{name} [{executor_name}]"
    value = float(value)
    rel = abs(value - expected) / abs(expected)
    print(f"{label}: compute() {elapsed:.3f} s ({plan.num_tasks()} tasks, {plan.num_ops()} ops), "
          f"value {value!r}, numpy oracle {expected!r}, rel err {rel:.3e}; {smi_tag()}")
    print(f"{label}: max_projected_mem {projected} B, torch.cuda.max_memory_allocated {peak} B")
    print(f"{label}: launches {json.dumps(launches)}; paths {json.dumps(paths)}")
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


def main(argv: list) -> int:
    against = None
    if argv[:1] == ["--against"] and len(argv) == 2:
        against = argv[1]
    elif argv:
        print("usage: chip_smoke.py [--against CHECKOUT]", file=sys.stderr)
        return 2
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
        print_resource_usage()

        kernels = [check_philox(torch), check_region_sum(torch), check_fma_sum(torch)]
        if against:
            compare_against(torch, against)

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
    sys.exit(main(sys.argv[1:]))
