"""Where merge_split's time goes, and how its work split moves it.

Builds variants of ``cubed_tpu_torch/kernels/csrc/merge_sort.cu`` whose
merge_split kernel stops after a stage (text edits of the source, into a
git-ignored build directory), and times each beside the kernel as it is, at
the order-statistics phase's shapes on the card: sort's (512, 256, 256)
float64 pair (values) and argsort's (171, 256, 256) pairs (float64 with
int64 indices), over several tiles and lane counts, each against its
two-block byte bound at 3.35 TB/s. The stages:

- ``kernel``: the kernel as it is (checked against merge_split_plain);
- ``no merge``: the split searches, the loads and the stores, the merge
  replaced by the identity (each thread stores its outputs' places of the
  segments as loaded);
- ``no load, no merge``: the split searches and the stores;
- ``store only``: the stores (each split the middle of its interval).

The stages' differences estimate what each costs where the others overlap
it. Run on the card from the repo's root:
``python3 chip_smoke_csrc/split_stages.py`` (about two minutes, most of it
nvcc). Prints one line a timing and a JSON list last.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cubed_tpu_torch.kernels import _build, _geometry  # noqa: E402
from cubed_tpu_torch.kernels import merge_sort as ms  # noqa: E402

BUILD = os.path.join(REPO, ".chip_smoke_work", "split_stages")
KERNEL = "    merge_split_kernel("
MERGE = """      merge_range<E>(at, 0, nxs, nxs, tn - nxs, j0, min(kItems, tn - j0), [&](int t, const E& e) {
        out[g0 + t * inner] = lv[e.p];
        if constexpr (kIdx) outi[g0 + t * inner] = li[e.p];
      });"""
IDENTITY = """      for (int t = 0; t < min(kItems, tn - j0); ++t) {
        out[g0 + t * inner] = lv[j0 + t];
        if constexpr (kIdx) outi[g0 + t * inner] = li[j0 + t];
      }"""
LOAD = "    const int total = rows[4 * kMaxGroups];"
NO_LOAD = "    const int total = 0 * rows[4 * kMaxGroups];"
SEARCH = "      while (__any_sync(0xffffffffu, lo < hi)) {"
NO_SEARCH = "      lo = (lo + hi) >> 1;\n      hi = lo;\n" + SEARCH

#: (shape, with indices, the (tile, lanes) work splits timed)
CASES = [((512, 256, 256), False, [(512, 16), (256, 16), (128, 16), (512, 8)]),
         ((171, 256, 256), True, [(256, 16), (128, 16), (256, 8)])]


def edit(src: str, *pairs) -> str:
    """*src* with each (old, new) replaced once in merge_split_kernel's part."""
    i = src.index(KERNEL)
    head, tail = src[:i], src[i:]
    for old, new in pairs:
        if old not in tail:
            raise SystemExit(f"split_stages: the kernel no longer holds {old.strip()[:60]!r}")
        tail = tail.replace(old, new, 1)
    return head + tail


def variants(src: str) -> dict:
    return {
        "kernel": src,
        "no merge": edit(src, (MERGE, IDENTITY)),
        "no load, no merge": edit(src, (MERGE, IDENTITY), (LOAD, NO_LOAD)),
        "store only": edit(src, (MERGE, IDENTITY), (LOAD, NO_LOAD), (SEARCH, NO_SEARCH)),
    }


def build(sources: dict) -> dict:
    """Each variant built with the package's nvcc flags (all at once) and
    loaded, its shared memory allowed; returns {name: library}."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for k, (name, text) in enumerate(sources.items()):
        path = os.path.join(BUILD, f"variant{k}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(BUILD, f"libvariant{k}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"split_stages: nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "merge_split_kernelIdLi" in line:
                mode = "pairs" if "merge_split_kernelIdLi1" in line else "values"
                regs = [x.split(":", 1)[1].strip() for x in lines[i + 1:i + 4] if "registers" in x]
                print(f"ptxas {name} ({mode}, float64): {'; '.join(regs)}")
        handle = ctypes.CDLL(lib)
        handle.merge_sort_init.restype = ctypes.c_int
        if handle.merge_sort_init() != 0:
            raise SystemExit(f"split_stages: merge_sort_init failed for {name}")
        handle.merge_split.argtypes = ms._library().merge_split.argtypes
        handle.merge_split.restype = ctypes.c_int
        libs[name] = handle
    return libs


def plan(n: int, inner: int, tile: int, lanes: int, mode: str) -> _geometry.SplitPlan:
    """split_plan's geometry at a given tile and lane count."""
    sector = min(_geometry.SECTOR_BYTES // 8, lanes)
    regions, smem = _geometry.split_layout(tile, lanes, sector, 8, _geometry.SPLIT_MODES[mode])
    tiles_n, lane_groups = -(-n // tile), -(-inner // lanes)
    return _geometry.SplitPlan(outer=1, n=n, inner=inner, itemsize=8, mode=_geometry.SPLIT_MODES[mode], tile=tile,
                               lanes=lanes, sector=sector, tiles_n=tiles_n, lane_groups=lane_groups,
                               tiles=tiles_n * lane_groups, grid=tiles_n * lane_groups, smem=smem, regions=regions)


def launch(lib, p, x, y, xi, yi, flag, out, outi) -> None:
    shifts = [ctypes.c_int(v.bit_length() - 1) for v in (p.tile, p.lanes, p.sector)]
    err = lib.merge_split(ctypes.c_int(ms.DTYPES[x.dtype]), ctypes.c_int(p.mode), ms._ptr(x), ms._ptr(y),
                          ms._ptr(xi), ms._ptr(yi), ms._ptr(flag), ctypes.c_longlong(0), ms._ptr(out),
                          ms._ptr(outi), ctypes.c_longlong(p.n), ctypes.c_longlong(p.inner), *shifts,
                          ctypes.c_longlong(p.tiles_n), ctypes.c_longlong(p.lane_groups), ctypes.c_longlong(p.tiles),
                          ctypes.c_int(p.grid), ms._regions(p.regions), ctypes.c_int(p.smem),
                          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise SystemExit(f"split_stages: launch error {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("split_stages: needs the card", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    with open(os.path.join(_build.CSRC_DIR, "merge_sort.cu")) as f:
        libs = build(variants(f.read()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
    low = torch.tensor(True, device=dev)
    rows = []
    for shape, with_idx, splits in CASES:
        def pair():
            x, y = (ms.sort_block(torch.rand(shape, generator=gen, device=dev, dtype=torch.float64), 0)
                    for _ in range(2))
            if not with_idx:
                return x, y, None, None
            xi = torch.randperm(x.numel(), generator=gen, device=dev).reshape(shape)
            return x, y, xi, xi + x.numel()

        pairs = [pair() for _ in range(2)]
        outs = [(torch.empty_like(pairs[0][0]),
                 torch.empty(shape, dtype=torch.int64, device=dev) if with_idx else None) for _ in range(2)]
        n = pairs[0][0].numel()
        bound = 2 * (16 if with_idx else 8) * n / cs.HBM_BYTES_PER_S * 1e3
        want = ms.merge_split_plain(pairs[0][0], pairs[0][1], low, 0, pairs[0][2], pairs[0][3])
        for tile, lanes in splits:
            p = plan(shape[0], n // shape[0], tile, lanes, "pairs" if with_idx else "values")
            for name, lib in libs.items():
                args = [(lib, p, *pairs[k], low, *outs[k]) for k in range(2)]
                launch(*args[0])
                torch.cuda.synchronize()
                if name == "kernel":
                    got = outs[0]
                    same = (cs._same(got[0], want[0]) and cs._same(got[1], want[1])) if with_idx else \
                        cs._same(got[0], want)
                    if not same:
                        raise SystemExit(f"split_stages: {name} at {tile} x {lanes} differs from the plain version")
                t = cs.time_ms(torch, launch, args, reps=20)
                rows.append(dict(shape=shape, indices=with_idx, tile=tile, lanes=lanes, stage=name, ms=t,
                                 bound_ms=bound))
                print(f"merge_split {shape} {'f64 + int64' if with_idx else 'f64'} tile {tile} x {lanes} lanes "
                      f"({p.tiles} CTAs, {p.smem} B shared memory each) {name}: {t:.5f} ms, "
                      f"{100 * bound / t:.1f}% of the {bound:.5f} ms bound; {cs.smi_tag()}", flush=True)
        del pairs, outs
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
