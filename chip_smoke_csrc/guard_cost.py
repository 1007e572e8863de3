"""Where the memory guard's cost goes, and what it and the checksums cost
the sequential executor.

Times vorticity's warm (replayed) compute on ``CudaExecutor`` at full width
((500, 450, 400) / 100, as ``chip_smoke.py --reliability-phase`` check 8
does), in turns, under five settings of the guard: off; observe (the
default: the allocator read without synchronizing, an observe-only unit's
RSS read at its entry and exit); observe with a synchronize before each of
the allocator's reads (as the guard read it before); observe with the RSS
sampler running for observe-only units too; and observe with both, the
guard as it was. Each setting is the same plan shape, so every compute
after the first two replays the same captured graph.

With ``--sequential``: vorticity on the sequential executor at chip_smoke's
spilled cut ((200, 180, 160) / 40: 921 tasks, each writing its chunks
fsync'd) under the guard off or observing and the checksums off or
recorded (``integrity="write"``, the default), the four settings in turns,
two rounds.

Run on the card from the repo's root:
``python3 chip_smoke_csrc/guard_cost.py [--sequential]`` (about a minute,
or three, with the build). Prints a line a setting (median and quartiles of
the compute's host time, ending in a synchronize) and a JSON summary last.
"""

import json
import os
import random
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["CUBED_TPU_TORCH_DEVICE"] = "cuda"

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TURNS = 30
SEQUENTIAL_ROUNDS = 2


def synced(memory, name):
    """The guard's allocator read *name*, a synchronize before it."""
    inner = getattr(memory, name)

    def read(dev, *args):
        torch.cuda.synchronize(dev)
        return inner(dev, *args)

    return read


def sampled_guard(memory):
    """The guard as a retryable task's: its unit registered with the RSS
    sampler (the device executor's units are observe-only, which read RSS at
    entry and exit alone). Under ``observe`` at allowed_mem 2GB nothing is
    judged over the budget either way."""

    class Sampled(memory.task_guard):
        def __init__(self, key: str = "", injected_bytes: int = 0, observe_only: bool = False):
            super().__init__(key, injected_bytes, observe_only=False)

    return Sampled


def sequential(card: str) -> dict:
    """The guard's and the checksums' cost on the sequential executor."""
    import cubed_tpu_torch

    work = os.path.join(cs.WORK_DIR, "guard-cost-seq")
    settings = [(guard, integrity) for guard in ("off", "observe") for integrity in ("off", "write")]
    times = {s: [] for s in settings}
    try:
        for r in range(SEQUENTIAL_ROUNDS):
            for guard, integrity in (settings if r % 2 == 0 else list(reversed(settings))):
                random.seed(cs.SEED)
                spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", memory_guard=guard,
                                            integrity=integrity)
                arr = cs.vorticity_build(spec, cs.SPILL)
                t = time.perf_counter()
                arr.compute()
                torch.cuda.synchronize()
                times[guard, integrity].append(time.perf_counter() - t)
                shutil.rmtree(work, ignore_errors=True)
    finally:
        shutil.rmtree(cs.WORK_DIR, ignore_errors=True)
    summary = {}
    for (guard, integrity), v in times.items():
        label = f"guard {guard}, integrity {integrity}"
        summary[label] = [float(x) for x in v]
        print(f"sequential vorticity {cs.SPILL['shape']} / {cs.SPILL['chunks']}, {label}: "
              + ", ".join(f"{x:.3f}" for x in v) + f" s; card: {card}")
    return {"card": card, "sequential_s": summary}


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("guard_cost: needs a GPU", file=sys.stderr)
        return 1
    import cubed_tpu_torch
    from cubed_tpu_torch.kernels import _build
    from cubed_tpu_torch.runtime import memory
    from cubed_tpu_torch.runtime.executors import cuda as cuda_module
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    _build.build_all()
    card = cs.nvidia_smi()
    if argv == ["--sequential"]:
        print(json.dumps(sequential(card)))
        return 0
    sync = {"_start_device_reading": synced(memory, "_start_device_reading"),
            "_end_device_reading": synced(memory, "_end_device_reading")}
    sampled = {"task_guard": sampled_guard(memory)}
    settings = {
        "off": ("off", {}),
        "observe": ("observe", {}),
        "observe, synchronized reads": ("observe", sync),
        "observe, sampled": ("observe", sampled),
        "observe, synchronized reads and sampled (the guard before)": ("observe", dict(sync, **sampled)),
    }
    work = os.path.join(cs.WORK_DIR, "guard-cost")
    arrays = {}
    for name, (mode, _) in settings.items():
        random.seed(cs.SEED)
        spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", memory_guard=mode)
        arrays[name] = cs.vorticity_build(spec, cs.VORTICITY)
    ex = CudaExecutor()
    for _ in range(2):  # the first sighting, then the capture
        for name in settings:
            arrays[name].compute(executor=ex)
    times = {name: [] for name in settings}
    try:
        for i in range(TURNS):
            for name in (list(settings) if i % 2 == 0 else list(reversed(list(settings)))):
                patches = settings[name][1]
                owners = {k: cuda_module if k == "task_guard" else memory for k in patches}
                saved = {k: getattr(owners[k], k) for k in patches}
                for k, v in patches.items():
                    setattr(owners[k], k, v)
                if "task_guard" not in patches:
                    memory.stop_sampler()
                try:
                    t = time.perf_counter()
                    arrays[name].compute(executor=ex)
                    torch.cuda.synchronize()
                    times[name].append(time.perf_counter() - t)
                finally:
                    for k, v in saved.items():
                        setattr(owners[k], k, v)
                if ex.stats.get("segment_struct_hits", 0) != 1:
                    print(f"guard_cost: a compute under {name} did not replay", file=sys.stderr)
                    return 1
    finally:
        shutil.rmtree(cs.WORK_DIR, ignore_errors=True)
    summary = {}
    for name, v in times.items():
        q = [float(x) * 1e3 for x in np.percentile(v, [25, 50, 75])]
        summary[name] = q
        print(f"{name}: median {q[1]:.3f} ms (quartiles {q[0]:.3f}-{q[2]:.3f}), {TURNS} computes; card: {card}")
    print(json.dumps({"card": card, "quartiles_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
