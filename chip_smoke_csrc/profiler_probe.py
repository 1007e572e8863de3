"""Why a torch.profiler session can record none of a check's kernels.

Runs 60 profiling sessions of chip_smoke.py's per-block float32 Philox
check (six launches of ``philox_uniform`` a session, behind the sentinel
kernel), a (4000, 4000) product and sum on the card between sessions,
every other session opened and closed ``chip_smoke.PROFILE_PAD_S`` of host
time away from its work (as chip_smoke.py's sessions are) and the others
not. Each session's six launches are counted three ways: key_averages'
rows with device time above 0 (how chip_smoke.py counted before), its rows
at any device time, and the chrome trace's kernel records; and each
kernel record's start less its launch call's on the host's clock (a
kernel cannot start before its launch: a negative difference is the
device's clock reading behind the host's). A session short of six prints
its raw records (``chip_smoke.session_report``).

Run on the card from the repo's root:
``python3 chip_smoke_csrc/profiler_probe.py`` (about a minute). Prints a
line a session and a JSON summary last.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SESSIONS = 60
PIECE = "philox_uniform_kernel"


def unpadded_session(fn):
    """A session as chip_smoke.py opened them before: no host time around
    the work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cs.SENTINEL_CYCLES)
        fn()
        torch.cuda.synchronize()
    return prof, cs.trace_events(prof)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_probe: needs the card", file=sys.stderr)
        return 1
    from cubed_tpu_torch.kernels.philox_uniform import philox_key, philox_uniform

    cs.CARD = cs.nvidia_smi()
    dev = torch.device("cuda")
    calls = [lambda s=s: philox_uniform(torch.empty(s, dtype=torch.float32, device=dev), philox_key(5))
             for s, _ in cs.PHILOX_F32_BLOCK_CASES]
    load = torch.rand((4000, 4000), device=dev)
    rows = []
    t0 = time.perf_counter()
    for k in range(SESSIONS):
        (load @ load).sum().item()
        padded = k % 2 == 0
        fn = lambda: [c() for c in calls]  # noqa: E731
        prof, events = cs.profiled_session(torch, fn) if padded else unpadded_session(fn)
        positive = any_time = 0
        for e in prof.key_averages():
            if PIECE in e.key:
                any_time += e.count
                positive += e.count if getattr(e, "self_device_time_total", 0) > 0 else 0
        trace = sum(1 for e in cs.trace_kernels(events) if PIECE in e["name"])
        launches = {(e.get("args") or {}).get("correlation"): float(e["ts"]) for e in events
                    if e.get("cat") == "cuda_runtime" and "aunch" in str(e.get("name", ""))}
        lags = [float(e["ts"]) - launches[(e.get("args") or {}).get("correlation")] for e in events
                if e.get("cat") == "kernel" and (e.get("args") or {}).get("correlation") in launches]
        rows.append(dict(session=k, padded=padded, device_time_above_0=positive, any_time=any_time, trace=trace,
                         lag_min_us=min(lags, default=None), lag_max_us=max(lags, default=None)))
        print(f"session {k} padded {padded}: key_averages with device time > 0 {positive}, at any time "
              f"{any_time}, trace {trace} of {len(calls)}; kernel start less launch call "
              f"{min(lags, default=float('nan')):.2f}..{max(lags, default=float('nan')):.2f} us "
              f"({len(lags)} records matched of {len(launches)} launch calls)", flush=True)
        if trace < len(calls):
            print(cs.session_report(prof, events))
    short = [r for r in rows if r["trace"] < len(calls)]
    behind = [r for r in rows if r["lag_min_us"] is not None and r["lag_min_us"] < 0]
    print(f"profiler_probe: {len(short)} sessions short ({sum(r['padded'] for r in short)} padded), "
          f"{len(behind)} with a kernel stamped before its launch call (least "
          f"{min((r['lag_min_us'] for r in behind), default=float('nan')):.2f} us); "
          f"{time.perf_counter() - t0:.1f} s; {cs.smi_tag()}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
