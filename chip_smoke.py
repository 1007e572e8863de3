#!/usr/bin/env python3
"""Smoke run of cubed_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--against CHECKOUT]

(``--profile-device-run`` is phase 5's own call of this script,
``--check-layouts FILE`` phase 4's, ``--observe-device-run`` the
observability phase's, and ``--time-kernels CHECKOUT`` and
``--time-computes CHECKOUT`` the ``--against`` timings' calls;
``--array-api-phase [full]`` runs the Array API phase alone, ``full`` at
BASELINE.md's 10000 x 10000 / 5000 scale; ``--order-stats-phase [full]``
the order-statistics phase alone, with its merge kernels' checks, ``full``
at 4096 steps of the time axis; ``--zarr-stencil-phase`` the Zarr and
stencils phase alone; ``--linalg-fft-phase`` the linear algebra and
spectra phase alone, its summary JSON on its last line;
``--reliability-phase`` the memory guard and reliability phase alone, its
summary JSON on its last line; ``--threads-phase`` the threaded executor's
phase alone, three timing rounds, its summary JSON on its last line;
``--analytics-phase`` the observability analytics phase alone, its summary
JSON on its last line; ``--fleet-phase`` the process pool and TCP fleet
phase alone, its summary JSON on its last line; ``--service-phase`` the
compute service phase alone, its summary JSON on its last line
(``--service-failover run|recover JOB`` are its check 3's processes);
``--attention-phase`` the ring attention phase alone and ``--chaos-phase``
the chaos campaign phase alone, each its summary JSON on its last line;
``--spare`` a fresh
process that imports torch and the port, then runs the arguments it reads
from stdin, one JSON line: the whole run starts each process of its own
that way ahead of its use.)

Phases, in order; any failure ends the run with a nonzero exit code:

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build every hand-written CUDA kernel from the sources in this checkout
   (one nvcc per source, all at once, with chip_smoke's own
   ``chip_smoke_csrc/philox_rounds.cu``: Philox's rounds alone, for
   measurement only), print the build seconds and each kernel's registers
   and spills (ptxas -v); phase 4's numpy oracles are computed meanwhile;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time both (CUDA events):
   philox_uniform bit for bit against numpy's Philox stream and the plain
   version, both its kernels: the per-block one, and the batched one on
   all 100 blocks of a (500, 450, 400) / 100 array and on ragged, odd-width,
   1-D, 4-D and size-0 grids (one launch per call, repeat launches bitwise
   equal, one kernel per call under torch.profiler); the batched launch is
   timed beside the per-block route on the same output (100 per-block
   launches and their copies into the assembled array), and the per-block
   kernel beside the batched kernel on a grid of one block, in turns, by
   device and host time; Philox's bound is the larger of its bytes and its
   integer issue at the fewest slots per counter that any build of its
   rounds shows in its SASS (the per-block kernel, the rounds alone), and
   the rounds alone (nothing stored) are timed beside their issue floors
   with IMAD.WIDE at two and at one FMA-pipe slot; region_sum within 1e-12
   (float64) / 1e-6 (float32) of the sum of magnitudes, int64 exactly
   (contiguous blocks, block views of a (499, 450, 400) array as the
   device executor passes them, misaligned and ragged views, reduced axes
   (0,) and (1, 2), combine-sized inputs, float32, sizes 1, 7 and 0); one
   launch per call and two launches on one input bitwise equal; every path
   (rows/columns, vector/scalar, one CTA/split) taken and printed per case;
   one kernel per call and no other kernel, counted by name under
   torch.profiler; region_sum's axis (0,) of a block view allocating no
   input-sized buffer; torch.sum is timed beside region_sum (also at a
   combine-sized input, at (5000, 5000) over axis (1,) and over axis (0,)
   of block views; no single torch call computes fma_sum_blocks' or
   philox_uniform's function); fma_sum_blocks (every block of the fused
   reduction in one launch) within 1e-12 of each block's sum of magnitudes
   of its plain version and of per-block fma_sum (fma_sum_blocks on a grid
   of one block), on the main path's ragged grid of [1:] views of (500,
   450, 400) / 100 and on ragged, odd, misaligned, float32, 1-D and 4-D
   grids, repeat launches bitwise equal, one kernel per call, every path
   taken, timed beside the per-block route (100 one-block launches) and its
   bound (the four views read once); fma_sum, the chunked path's unit, on
   the per-block cases above within 1e-12 of the terms' magnitudes, one
   launch per call (none for size 0), timed by device and host time; the
   batching rules of region_sum's and Philox's custom ops under
   torch.func.vmap (grid views of a [1:] slice, addsum's (5, 5, 1000, 1000)
   fused op) against their plain versions and numpy, one kernel per
   batched call, timed beside their bounds and torch.sum. With
   ``--against CHECKOUT``, the fma_sum and region_sum of another checkout
   of this repo are built from its sources and timed beside these on the
   same inputs (drawn from one seed), in turns (theirs, ours, ours,
   theirs), by device and host time; the other checkout is timed in a
   process of its own (this script with ``--time-kernels CHECKOUT``, which
   prints its timings as JSON), since both checkouts register the same
   custom ops (against a checkout from before this one's fma_sum_blocks
   took the place of fma_sum's own kernel: that kernel against
   fma_sum_blocks on one (100, 100, 100) and one (40, 40, 40) block); then
   the four device computes (cold, capturing, two warm) of vorticity,
   elemwise, reduce and matmul, one after the other, on each checkout, each
   in a fresh process (``--time-computes CHECKOUT``), in turns, three
   rounds, with each compute's median and quartile spread. Then the float32 side
   (``compute_dtype="float32"``): both Philox kernels' float32 entry points
   bit for bit against numpy's float64 streams rounded to float32 and
   against their plain versions (per block at vorticity_f32's (100, 100,
   100) blocks, odd sizes and outputs 4 and 12 bytes off 16; batched at
   vorticity_f32's (500, 450, 400) / 100 array, the ragged, 1-D, 4-D and
   size-0 grids, column-view, misaligned and 200-byte-row outputs and the
   batching rule's (25, 1000000) fill), one launch and one kernel per call,
   their SASS, and each timed beside its plain version, its bound and the
   float64 launch in the same call; fma_sum_blocks and region_sum on
   float32 inputs (their routes under the mode) against their plain
   versions, timed beside their halved byte bounds; every
   ``matmul_precision`` mode ("float32", "tensorfloat32", "bfloat16",
   "bfloat16_3x") on a (1000, 1000) / 250 matmul plan against its exact
   model (rtol 1e-5), with the GEMM kernels torch.profiler records for it,
   and one (1000, 1000) product per mode timed beside its GEMM bound;
4. drive the main path through the public entry points, on the default
   sequential executor and on the device executor (``CudaExecutor``):
   addsum, ``sum(a + b)`` at (5000, 5000) / 1000, then pangeo-vorticity,
   ``mean(a[1:]*x[1:] + b[1:]*y[1:])`` at (500, 450, 400) / 100, each
   checked against a numpy oracle that draws the same per-block Philox
   streams itself (rtol 1e-12). Kernel launch counts are zeroed just before
   and read just after each run, with the paths each kernel took.
   Vorticity must launch philox_uniform exactly 400 times (per block) on
   the sequential executor; on the device executor it is computed four
   times with distinct seeds on one executor, each equal to its oracle:
   the first runs its segment op by op (the first sighting of its
   structural key: a plan computed once is never captured), the second
   captures it as a CUDA graph and replays it (``segments_compiled`` 1),
   the others replay it (``segment_struct_hits`` 1); each launches
   philox_uniform 4 times (batched) and fma_sum_blocks once (split
   tiles), with ``batched_ops`` 5, ``chunked_ops`` 3, ``eager_ops`` 1,
   ``segments_traced`` 1, no fallback, peak reserved memory (graph pools
   included) under its residency budget and chunk files for the output
   alone; cold, capturing and warm ``compute()`` are printed. Addsum's
   fused random op is batched on the device executor (one Philox launch
   per array, ``batched_ops`` 1), its cold ``compute()`` printed. A cut
   vorticity, (200, 180, 160) / 40 under a budget of two arrays, spills,
   fails its segment's memory pre-check (``segment_mem_aborts`` 1) and
   takes fma_sum block by block (100 launches of fma_sum_blocks, a grid of
   one block each): the fusion rule's chunked form. Then the rest of the
   BASELINE set, each on both executors against a numpy oracle drawing the
   same per-block Philox streams, rtol 1e-12, with launches, paths,
   counters, projected and peak memory printed: config 2, elemwise,
   ``sum(sqrt(abs(sin(a)*b + cos(b))))`` at (6000, 6000) / 1000; config 3,
   ``max(mean(a, axis=0))`` at (8000, 8000) / 1000; config 4,
   ``sum(matmul(a, b))`` at (4000, 4000) / 1000 (the oracle is numpy's
   ``a @ b``); and config 5's array made time-contiguous,
   ``mean(rechunk(a, (500, 45, 40)), axis=0)`` at (500, 450, 400) / 100,
   compared element by element, under allowed_mem 2GB, 500MB and 200MB,
   whose plans must have 1, 3 and 2 copy ops of 5; 108, 128, 100; and 500,
   100 tasks. The sequential executor copies through Zarr; on the device
   executor, three computes with distinct seeds, every copy op an alias
   (``rechunk_alias``), chunk files for the output alone, the segment
   captured on the second compute and replayed on the third. Each of these
   runs' launch counts is pinned (device region_sum 6, 49, 19 and 1;
   sequential 71, 176, 143 and 100), and every region_sum and batched
   Philox launch of its device computes is recorded by layout (shape,
   strides, offset, alignment; axes, block chunks, keys) and run again on
   the card at that layout against its plain version, in a fresh process
   (``--check-layouts``): region_sum within 1e-12 of the sum of
   magnitudes, Philox bit for bit, one launch per call and one kernel per
   call under torch.profiler. Before those, bench.py's three other
   workloads at its sizes: vorticity_f32 (config 5's plan on
   ``CudaExecutor(compute_dtype="float32")``, cold, capturing and warm,
   each against numpy's emulation of the mode at rtol 1e-6 and the float64
   oracle within the reference's float32 bound; the float32 Philox kernel 4
   times, fma_sum_blocks and region_sum on float32; then cut to (200, 180,
   160) / 40 under a budget below one float32 array, where the random ops
   run block by block through the per-block float32 entry point, 400
   launches), matmul_bf16 (config 4's plan with ``matmul_precision=
   "bfloat16"`` as well, three computes, against numpy's product of the
   bf16-rounded operands at rtol 1e-5 and within 2e-2 of the exact value)
   and addsum_scaled (``sum(a + b)`` at (16000, 16000) / 2000 float64 on
   both executors, rtol 1e-12), their layouts recorded and checked with
   the rest; every result in its declared float64;
   Then the observability phase: vorticity again with every observer
   attached. On the device executor in a process of its own
   (``--observe-device-run``, so the plan shape is new there), four
   computes (cold, capturing, two warm, phase 4's seeds) with a
   ``TraceCollector``, a ``TracingCallback``, a ``DeviceMemoryCallback``
   and a ``TorchProfilerCallback`` (each session opened by an uncounted
   sentinel kernel): every value equal to its oracle (rtol 1e-12), the
   executor's counters and launches equal to phase 4's unobserved computes
   (the graph pool's bytes aside), ``ComputeEndEvent.executor_stats``
   holding them with ``tasks_completed`` 921, ``bytes_written`` 8 (the
   output's flush) and a ``per_op`` row per op, the merged trace loadable
   with one operation span per op, the profiler's trace of every compute
   (the capturing one too) recording each hand kernel as many times as its
   wrapper counted, and the allocator's peak within the budget; the
   capturing compute also runs with the dispatch profiler armed, and its
   time over the warm computes' and its top stacks are printed; then warm
   computes in turns, COST_ROUNDS rounds, four ways (the executor alone, as
   ``compute()`` ran before the lifecycle; ``compute()`` unobserved; with a
   TraceCollector; with all four observers), with their medians. On the
   sequential executor, vorticity at the spilled cut (the same 921 tasks)
   with a TraceCollector: one task span per task, storage and kernel
   sub-spans accounting for every chunk read and written and every
   blockwise task, bytes and chunks written equal to what the plan's
   outputs take as stored, the collector's own callback time, and the wall
   clock beside the threads phase's unobserved sequential run of it (this
   observed run comes after the threads phase);
   Then the analytics phase, in a process of its own (``--analytics-phase``,
   alone it first runs phase 4's unobserved computes in another process,
   ``--analytics-unobserved``): (1) vorticity at full width on
   ``CudaExecutor``, cold, capturing and warm, of one seed, each with a
   ``FlightRecorder`` and ``Spec(run_history=..., telemetry_port=0,
   dispatch_profile=True)``: each value against the numpy oracle (rtol
   1e-12), the Philox, region_sum and fma_sum_blocks launches equal to
   phase 4's unobserved computes', ``analyze()`` reading one task span per
   op with the op graph as the critical path's source and its buckets
   covering the wall clock, ``explain()``'s tasks and its output op's bytes
   equal to ``executor_stats``' (only the output reaches storage), three
   run records of one fingerprint (no card byte copied for it) and
   ``regress`` rendering the diff of the last two, a block function holding
   a CUDA tensor fingerprinted from a host copy, counted; ``/metrics``,
   ``/healthz`` and ``/snapshot.json`` scraped over loopback with each
   compute's tasks done equal to its total, and ``python -m
   cubed_tpu_torch.top --once`` rendering from the endpoint; (2) the
   reliability phase's cut (160, 160, 120) / 40 on 8 threads under
   dataflow with the dispatch profiler: a chunk graph recorded and read as
   the critical path's source, a "dispatch profile" lane, the value bit for
   bit the sequential executor's (the observability phase's run of the cut
   with a TraceCollector, passed in; alone the phase runs its own), and
   both computes' bucket splits (critical path and busy time); (3) a seeded task
   fault exhausting its retries with ``CUBED_TPU_TORCH_FLIGHT_RECORDER``
   set: one bundle naming the failing op and chunk, and ``python -m
   cubed_tpu_torch.diagnose <bundle> --analyze`` exiting 0 on it; (4)
   vorticity's warm compute, 30 turns each, unobserved and with the three
   knobs armed, medians and quartiles (not a gate). Its summary JSON is its
   last line. The whole run ends with phase 5;
   Then the Array API phase: 22 ops (tests/test_mem_utilization.py's
   ``OPS`` that the port has, flip, roll, var, std, cumulative_sum,
   argmax, where, count_nonzero and an integer-array index) on two
   ``random.random`` inputs of 5000 x 5000 float64 in 2500 x 2500 chunks,
   allowed_mem 2GB. Each on the sequential executor under allowed_mem
   equal to its plan's projected memory (reserved_mem 0), every task's
   device peak (the allocator's peak over the task's start, read by the
   library's memory guard; its ``guard_mem_peak``, which also holds the
   task's RSS growth, printed beside) at most that bound; then on
   ``CudaExecutor`` cold and warm, each value against a
   numpy oracle drawn from the same Philox blocks (exact where the op
   moves values or rounds once, sums rtol 1e-12, the scan within n eps
   max|x|), no failed check, and a profiled warm compute whose copies of
   64 KiB or more between host and card, beyond the output's own chunk
   writes, are none for the resident reads of flip, concat, roll and the
   integer-array index; each op's times, ratio, paths and launches printed;
   Then the Zarr and stencils phase, on vorticity's four arrays, (500, 450,
   400) float64 in 100-chunks under 2GB: a horizontal five-point Laplacian
   by ``map_overlap(depth=(0, 1, 1), boundary="periodic")`` written by
   ``to_zarr`` compressed with zlib level 1, and vorticity's product
   ``a[1:]*x[1:] + b[1:]*y[1:]`` written uncompressed by ``store``, on
   ``CudaExecutor`` (the stencil cold, the product cold and warm), each
   store read back with ``from_zarr`` against a numpy oracle drawn from the
   same Philox blocks (the stencil rtol 1e-12, the product exact; the warm
   write's chunk files byte for byte the cold one's), with each write's
   compression and fsync'd writes
   timed apart, the bytes written as stored (equal to the store's files),
   launches, path counters and peak reserved memory; the mean of the
   stencil's square (Philox and region_sum launched), ``random.normal`` and
   ``random.randint`` at the same shape bit for bit against numpy's
   per-block Philox draws, and ``pad`` (constant and edge) of addsum's
   (5000, 5000) / 1000 array against ``np.pad``; then the same plans on the
   sequential executor, cut to (100, 450, 400) (pad to (1000, 5000)), under
   allowed_mem equal to each plan's projected memory, every task's device
   peak at most that bound;
   Then the order-statistics phase. First its merge kernels
   (csrc/merge_sort.cu: sort_block, argsort_block, merge_split) against
   their plain versions, bit for bit: the sorts at the phase's blocks, at
   NaN, -0.0, ties, integer extremes, ragged and one-element cases, along
   16384 steps and past a tile for every dtype on both axes, with the
   launches of each sort's plan (the tile sort, then its merge passes);
   merge_split over its own tiles (both halves, values and pairs, every
   dtype, equal keys with other bits, x below and above y, lanes of 171,
   T + 1 and 3T + 5 on both axes, the phase's pairs, vmapped batches), one
   launch a call; each kernel's counted launches held against
   torch.profiler's records; each timed beside its plain version,
   ``torch.sort`` of the same data and its byte bound (the sorts also
   along 16384 steps; merge_split's pairs path at argsort's chunk, and the
   bytes its loads cover over the bound's). Then 16 ops
   (sort, argsort, median, quantile 0.9, topk/argtopk 16, nanmedian,
   nanmean, nansum, nanmax, nanmin along time on a copy with values under
   0.01 made NaN; searchsorted of 2**20 queries in a sorted 2**24 array;
   histogram of 64 bins, implicit range, unweighted and weighted; cov and
   corrcoef of (64, 2**20)) on a per-gridpoint climatology, (2048, 256,
   256) float64 in (512, 256, 256) chunks under 2GB: on the sequential
   executor, cut to (1024, 128, 128) in (64, 64, 64) chunks, under
   allowed_mem equal to each plan's projected memory, every task's device
   peak at most that bound (sort and argsort also with the network forced,
   in (128, 64, 64) chunks, and along a 16384-step axis in one chunk,
   where they are read again with the plain ``torch.sort`` bodies, not
   gated: the reason the merge kernels exist); on ``CudaExecutor`` cold
   and warm against
   numpy oracles drawn from the same Philox blocks (sorts, searches,
   counts, top-k and extrema exact; sums and interpolations rtol 1e-12;
   the weighted histogram rtol 1e-11; cov and corrcoef atol 1e-12), no
   failed check, and a profiled warm compute with no copy between host and
   card beyond the output's writes and each sort's bitonic round timed
   against its byte bound; every kernel of the path launched.
   Then the linear algebra and spectra phase, in a process of its own
   (``--linalg-fft-phase``), under 2GB, every input drawn by the batched
   Philox (``random.random``; the integer product's by ``randint``): einsum
   on vorticity's arrays (``tyx,tyx->yx``, ``tyx,t->yx``), at matmul's
   4000^2 / 1000 in float64 and in float32 under ``matmul_precision=
   "bfloat16"`` (against its exact model and ``contraction.matmul_plain``
   on the card), and an int64 product at 2000^2 / 500, exact; ``rfft``
   along time of a (2048, 256, 256) / (512, 64, 64) climatology, its power
   spectrum's mean over gridpoints, ``rfftn``/``irfftn`` over vorticity's
   horizontal axes, ``fftshift(fftfreq)``; TSQR of a (2^20, 128) / (65536,
   128) matrix (Q, with Q R and Q^T Q checked on the card; R against
   numpy's after canonical signs), ``svdvals``, the Frobenius norm; the
   solvers on (65536, 8, 8) / (8192, 8, 8) SPD matrices (cholesky, solve,
   inv, slogdet, eigh, and cholesky of a batch with one matrix that is not
   positive definite: NaN on and below its diagonal, 0 above); the blocked
   Cholesky of an 8192^2 matrix (L L^T checked on the card). Each op on
   ``CudaExecutor`` cold, capturing and warm against a numpy oracle on the
   same Philox streams, with its seconds, path counters (no failed check),
   Philox and region_sum launches, whether its segment was captured (the
   host-synchronising solvers, eigh and svd, run op by op) and its peak
   reserved memory; then cut plans on the sequential executor under the
   tight bound, every task's device peak at most its projection.
   Then the memory guard and reliability phase, in a process of its own
   (``--reliability-phase``), on vorticity's product ``a[1:]*x[1:] +
   b[1:]*y[1:]`` and mean, inputs drawn by ``random.random``, each checked
   against numpy on the same Philox streams: (1) on the sequential executor
   at (200, 180, 160) / 40 under ``memory_guard="enforce"`` and allowed_mem
   the plan's projected memory, every task passes and its guard reading
   over its op's projection is at most 1.0, the device reading equal to the
   allocator's peak from a reset at the task's start; (2) a ``map_blocks``
   with a hidden temporary of four blocks on the card,
   ``extra_projected_mem=0``: under observe every task soft-exceeds and
   the value is right, under enforce with 2 retries the actionable abort
   naming the op and the bytes after at most 3 attempts; (3) a task
   allocating past the card's free memory: ``torch.OutOfMemoryError``,
   classified RESOURCE, the actionable abort, ``memory_allocated`` back to
   its value before, the next compute right; (4) the product written by
   ``to_zarr`` under ``integrity="verify"``, 6 retries and seeded write
   failures (leaving ``.tmp`` litter), corruption and task failures, every
   op's output stored, then resumed with the faults disarmed: the store
   equal to a fault-free one bit for bit, faults, retries, detected and
   quarantined chunks all counted; (5) the product's compute cancelled
   after 37 tasks of its store's op, ``num_tasks(resume=True)`` equal to
   the tasks not done, a resume running exactly those, then a rotten chunk
   quarantined and its one task re-run; on ``CudaExecutor`` at (500, 450,
   400) / 100: (6) resume of the stored product, whole (its op skipped)
   and with one chunk corrupt (quarantined, its op re-run, the store
   verified), then vorticity's cold compute with ``deadline_s`` at half its
   time, aborted at a boundary, and the next compute right; (7) the product
   written with integrity off, write, and write with a verified read-back,
   seconds and the host's CRC rate; (8) vorticity's warm (replayed) compute
   with the guard off and observing, 200 each in turns, medians and
   quartiles; (9) each unit's guard reading, taken without a synchronize,
   equal to the synchronized reading at the same points: vorticity's cold,
   capturing and replayed computes, a matmul plan with every op eager (a
   cuBLAS product), a unit freeing a block used on a side stream
   (``record_stream``).
   Then the threads phase, in a process of its own (``--threads-phase``),
   ``AsyncPythonDagExecutor`` running every task through
   ``execute_with_stats`` in a pool thread: (6, first) wall times in turns
   on the spilled cut, the sequential executor against threads at 1, 4, 8
   and 16 workers under the dataflow scheduler, every value and launch
   count bit for bit the first sequential run's (alone three rounds; in the
   whole run one round, checks 2, 3 and 6 at the reliability phase's
   cut (160, 160, 120) / 40, and check 1 under dataflow alone, to stay
   near the run's 1050 s aim); (1) vorticity at full width on 8 threads under both
   schedulers against the numpy oracle (rtol 1e-12), the per-block Philox,
   region_sum and fma_sum launches equal to phase 4's sequential run's, and
   tasks dispatched early under dataflow; (2) the cut under oplevel at 1, 4
   and 8 workers, bit for bit the sequential's; (3) ``enforce`` at the
   plan's bound on the cut: at one worker every task's device reading equal
   to the synchronized reset-based one, at 8 every reading at least its
   one-worker reading, admission stepping down, the value bit for bit; (4)
   seeded storage and task faults with speculative backups at the
   reliability phase's cut, the store bit for bit the fault-free one's; (5)
   a journaled compute cancelled partway, resumed from its journal on
   threads and on ``CudaExecutor``: each runs exactly the tasks (the ops)
   not both journaled and verified.
   Then the fleet phase, in a process of its own (``--fleet-phase``): the
   process pool (``MultiprocessDagExecutor``) and the TCP fleet
   (``DistributedDagExecutor``), four workers each on this card, every
   task in a worker process on ``cuda``, under the dataflow scheduler.
   The pool in one compute (each pool compute pays its workers' start):
   vorticity at full width under ``enforce`` at the plan's bound, a worker
   SIGKILLed after 800 of its 921 tasks: (1) the value at rtol 1e-12 of the
   numpy oracle, the launches the workers report summed equal to phase 4's
   sequential run's, every worker on ``cuda`` with a launch, none in this
   process; (2) bit for bit phase 4's sequential value; (3) the pool
   rebuilt with half its workers; (5) each task's guard reading, taken in
   its worker, within the bound, and no attempt over it. The fleet: (1) at
   full width as the pool; (2) and (5) the reliability phase's cut (160,
   160, 120) / 40 under ``enforce`` at its plan's bound, bit for bit the
   threads phase's sequential value at that cut; (4) a rechunk of the cut
   reading peers' caches, equal to a store-only run, and again under
   seeded ``peer_corrupt_rate`` faults, each fallback counted; (3) a worker
   SIGKILLed mid-compute at the cut (one worker lost, its tasks requeued),
   the value bit for bit. (6) ``close()`` leaves no live child process;
   (7) the fleet's start and one round at the cut (the threads phase's
   sequential and 4-thread times, the fleet's) are printed, not a gate.
   Alone the phase computes the sequential values and times itself. The
   whole run takes the linear algebra and spectra phase after the threads
   phase and runs the fleet phase beside it, in a work directory of its
   own (``.chip_smoke_work_fleet/``): its times there are under that load.
   The service phase, in a process of its own (``--service-phase``),
   started before the order-statistics phase and collected after it, in
   ``.chip_smoke_work_service/``: (1) a ``ComputeService`` of two tenants
   (weights 4 and 1) on one ``CudaExecutor`` takes vorticity at full width
   from both at once, each value bit for bit phase 4's and the launches
   twice phase 4's first compute's; a rebuilt identical plan is a
   plan-cache hit, and with the result cache an identical submit is a hit
   with no task run; (2) a durable service over a fleet of one worker on
   ``cuda`` with the autoscaler (at most three) takes a backlog of four
   requests at the reliability phase's cut, each bit for bit the threads
   phase's sequential value; the autoscaler spawns a worker (the kernels
   built first, ``--device cuda``) and retires one after idle; every worker
   reports ``cuda`` and a launch; (3) a service process and its
   coordinator SIGKILLed after half of a request's tasks at the cut; a
   successor service process on the same ``service_dir`` adopts the
   orphaned workers (one takeover, no worker lost), resumes fewer tasks
   than the plan's, the value bit for bit, and the invariant auditor is
   clean over the journal, the control dir and the work dir; (4) check 2's
   tasks under ``enforce`` at the plan's bound, each reading (taken in its
   worker) within it, none over; (5) ``close()`` leaves no live child and
   the control log's worker pids are all gone; (6) a warm request through
   the service against the bare executor, the autoscaler's spawn to first
   task, the takeover from the kill to the successor's first completion,
   and the control log's cost at the cut are printed, not a gate.
   The attention phase, in a process of its own (``--attention-phase``),
   started with the service phase and collected after it, in
   ``.chip_smoke_work_attention/``: ``flash_block`` against its plain step
   (two steps from empty accumulators, both masks) at the main path's
   slot-step (1, 4096, 16, 128) float32 and at ragged ones (lengths not a
   multiple of 64, D of 8, 64 and 256, causal blocks whose first rows see no
   key), then timed (CUDA events) beside its FP32 bound, its TF32
   tensor-core bound, the plain step and SDPA on the same block; the main
   path, its launches counted from 0: ``ring_attention`` on a mesh of four
   slots of cuda:0 and ``attention()`` on three ``random.random`` arrays
   computed through the plan (per-block Philox on the sequential executor),
   at (1, 16384, 16, 128) float32, both masks, 64 ``flash_block`` launches in
   all, each result finite and within 1e-4 of dense attention run one head
   at a time on the card; a causal backward at 2048 positions within 2e-4
   of dense autograd's largest gradient; the ring and SDPA on the whole
   attention timed, not a gate.
   The chaos phase, in a process of its own (``--chaos-phase``), started
   with the threads phase and collected after it, in
   ``.chip_smoke_work_chaos/``, every compute on the card: (1) a campaign
   of generated schedules (seeds 0-3, three failure domains each, on the
   threaded executor and on an in-process fleet), each bit for bit its
   numpy value and clean under the invariant auditor; (2) a coordinator
   kill in a child interpreter, recovered by a clean replay; (3) a failing
   schedule shrunk to its culprit and replayed from its repro file with the
   same failure; (4) ``python -m cubed_tpu_torch.chaos --seed 2`` exits 0;
5. run vorticity's plan once more on each executor under torch.profiler:
   the device executor whole, then op by op on the host clock, and then
   the sequential one op by op at the spilled cut, timing each op kind;
   both with the
   device's busy time and idle share. Every profiling session opens with a
   sentinel kernel that is not counted: the profiler can drop a session's
   first kernel record. The device executor's profiled run is a replay of
   its captured segment, made in a process of its own
   (``--profile-device-run``; in a process that had already profiled and
   run many kernels the profiler lost one Philox record of four), and its
   reading is used only when it recorded every launch the wrappers counted
   (up to three tries); its copy kernels and float64 fill kernels must then
   be at least 390 fewer each than the 399 and 398 that the random ops made
   when they ran block by block (their block copies and template fills).

The kernels line gives each kernel's launches in the run of its path:
vorticity's first device compute; for the float32 entry points and routes
vorticity_f32's first compute, and its spilled run for the per-block float32
Philox entry point; for the merge kernels the order-statistics phase's first
device computes; for flash_block the attention phase's main path.
The last three lines of standard output are the nvidia-smi line, the JSON
line of kernels, and ``{"ok": true, "device": {...}}``. Intermediate Zarr
stores go to ``.chip_smoke_work/`` in this checkout and are removed at exit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import itertools
import json
import math
import os
import random
import shutil
import subprocess
import threading
import sys
import time
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, ".chip_smoke_work")
#: the work directories of the phases the whole run runs beside others
SIDE_WORK_DIRS = {"--threads-phase": os.path.join(REPO, ".chip_smoke_work_threads"),
                  "--fleet-phase": os.path.join(REPO, ".chip_smoke_work_fleet"),
                  "--service-phase": os.path.join(REPO, ".chip_smoke_work_service"),
                  "--attention-phase": os.path.join(REPO, ".chip_smoke_work_attention"),
                  "--chaos-phase": os.path.join(REPO, ".chip_smoke_work_chaos")}

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

#: Philox's integer issue slots per counter are counted every run from the
#: SASS (``cuobjdump -sass``) of each build of its rounds (:func:`philox_sass`):
#: on sm_90a with nvcc 12.9 the per-block kernel (one counter a thread) took
#: 178 FMA-pipe slots (73 IMAD.WIDE.U32[.X] at two slots each, a 64-bit
#: result, + 21 IMAD.X + 10 IMAD.MOV.U32 + 1 IMAD.SHL.U32) and 108 ALU-pipe
#: slots (LOP3, IADD3[.X], SHF, ISETP, MOV, LEA); the rounds alone
#: (chip_smoke_csrc/philox_rounds.cu, four counters a thread) 164 and 91 a
#: counter. Uniform-datapath instructions (once a warp) are not counted.
_ALU_OPCODES = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "MOV")

#: GPU clock cycles the spin kernel holds the stream before a timed run
#: (about 50 ms at the H100's 1.98 GHz boost clock)
SPIN_CYCLES = 100_000_000

#: counters a thread of the batched Philox kernel takes per work item
#: (kCounters in csrc/philox_uniform.cu)
PHILOX_COUNTERS = 4

ADDSUM = dict(shape=(5000, 5000), chunks=1000)
VORTICITY = dict(shape=(500, 450, 400), chunks=100)
#: BASELINE configs 2-4 (bench.py's elemwise, reduce and matmul workloads)
ELEMWISE = dict(shape=(6000, 6000), chunks=1000)
REDUCE = dict(shape=(8000, 8000), chunks=1000)
MATMUL = dict(shape=(4000, 4000), chunks=1000)
#: config 5's array made time-contiguous: rechunk to (500, 45, 40), then a
#: time mean; under each allowed_mem the planner makes another chain of copy
#: ops: allowed_mem -> (copy ops, their tasks)
RECHUNK_TARGET = (500, 45, 40)
RECHUNK_PLANS = {"2GB": (1, [5]), "500MB": (3, [108, 128, 100]), "200MB": (2, [500, 100])}
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


def host_us(torch, fn, args_list, reps: int = 200) -> float:
    """Mean microseconds of host time per call of ``fn(*args)``, enqueued
    back to back with no spin kernel ahead (the host's launch rate), after
    a warm-up."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e6


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


#: GPU clock cycles of the sentinel kernel that opens every profiling
#: session: in a process that has already run many kernels, torch.profiler
#: drops the first kernel record of a session, and the sentinel's record is
#: the one to lose (it is never counted)
SENTINEL_CYCLES = 1000
SENTINEL_KERNEL = "spin_kernel"

#: profiled runs of the device executor tried before phase 5 gives up on a
#: reading that records every counted launch
PROFILE_ATTEMPTS = 3
#: a piece of the device kernel names of each wrapper
KERNEL_RECORDS = {"philox_uniform": "philox_", "region_sum": "region_sum_", "fma_sum_blocks": "fma_blocks_kernel"}


#: host seconds a profiling session runs before the work it records and
#: after that work has ended on the card: the profiler keeps a device record
#: only inside the session's window on the host's clock
PROFILE_PAD_S = 0.02


def trace_events(prof) -> list:
    """The events of a finished torch.profiler session's chrome trace."""
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, f"trace-{os.getpid()}-{time.monotonic_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    os.remove(path)
    return events.get("traceEvents", events) if isinstance(events, dict) else events


def profiled_session(torch, fn, cpu: bool = False):
    """Run *fn* in a torch.profiler session (the CUDA activity, and the CPU's
    where *cpu*), opened and closed PROFILE_PAD_S of host time away from the
    work, the sentinel kernel first; returns (the profiler, its trace's
    events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        torch.cuda._sleep(SENTINEL_CYCLES)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof, trace_events(prof)


def trace_kernels(events) -> list:
    """The kernel records of a trace, the sentinel's left out."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
            and SENTINEL_KERNEL not in str(e.get("name", ""))]


def kernel_launches_by_name(torch, fn, session: Optional[list] = None) -> dict:
    """Device kernels launched while *fn* runs, by name: each kernel record
    of torch.profiler's trace counts once, whatever its duration. With
    *session* (a list), the session's (profiler, events) are appended to it."""
    prof, events = profiled_session(torch, fn)
    if session is not None:
        session.append((prof, events))
    counts: dict = {}
    for e in trace_kernels(events):
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def session_report(prof, events) -> str:
    """A session's raw device records: key_averages' device rows (with their
    device time), prof.events()' device events, the trace's kernel records
    (start, duration, correlation) and launch calls, each kernel's start
    less its launch call's, and the trace's span on the host's clock."""
    lines = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t or "kernel" in e.key or "Memcpy" in e.key:
            lines.append(f"  key_averages: {e.key[:90]} count {e.count} self device us {t}")
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            lines.append(f"  events(): {e.name[:90]} start {e.time_range.start:.3f} end {e.time_range.end:.3f} "
                         f"async {e.is_async}")
    launches = {(e.get("args") or {}).get("correlation"): e for e in events
                if e.get("cat") == "cuda_runtime" and "aunch" in str(e.get("name", ""))}
    lags = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            corr = (e.get("args") or {}).get("correlation")
            launch = launches.get(corr)
            lag = float(e["ts"]) - float(launch["ts"]) if launch else None
            if lag is not None:
                lags.append(lag)
            lines.append(f"  trace kernel: {str(e.get('name'))[:90]} ts {e.get('ts')} dur {e.get('dur')} "
                         f"correlation {corr} start less launch {lag}")
    stamps = [float(e["ts"]) for e in events if "ts" in e]
    ends = [float(e["ts"]) + float(e.get("dur", 0)) for e in events if "ts" in e]
    lines.append(f"  trace: {len(events)} events, {len(launches)} launch calls, host span "
                 f"{min(stamps, default=0):.3f}-{max(ends, default=0):.3f} us; kernel start less launch call "
                 f"{min(lags, default=float('nan')):.3f}..{max(lags, default=float('nan')):.3f} us")
    return "\n".join(lines)


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


#: the Philox kernels by a piece of their mangled names
PHILOX_KERNELS = {"philox_uniform_kernel": "block", "philox_blocks_kernel": "batched",
                  "philox_rounds_kernel": "rounds"}
PHILOX_KERNEL_NAMES = {v: k for k, v in PHILOX_KERNELS.items()}

#: chip_smoke's own CUDA source: Philox's rounds alone, built beside the
#: package's kernels (not part of the package)
ROUNDS_SOURCE = os.path.join(REPO, "chip_smoke_csrc", "philox_rounds.cu")


def start_rounds_build():
    """Start nvcc for :data:`ROUNDS_SOURCE`, with the package's flags and its
    ``philox.cuh``; returns (process, library path)."""
    from cubed_tpu_torch.kernels import _build

    os.makedirs(WORK_DIR, exist_ok=True)
    lib = os.path.join(WORK_DIR, "libphilox_rounds.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, ROUNDS_SOURCE]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def finish_rounds_build(started) -> str:
    proc, lib = started
    out, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"nvcc failed for {ROUNDS_SOURCE}:\n{out}")
    regs = [line.strip() for line in out.splitlines() if "registers" in line]
    print(f"ptxas philox_rounds (chip_smoke_csrc): {'; '.join(regs)}")
    return lib


def philox_sass(rounds_lib: str) -> dict:
    """SASS opcode counts of each Philox kernel: "block" (per block),
    "batched" and "rounds" (the rounds alone, from *rounds_lib*); the
    float32 instances of the two templates as "block_f32" and "batched_f32"
    (mangled ``...IfE...``; the float64 ones ``...IdE...``)."""
    from cubed_tpu_torch.kernels import _build

    short = {}
    found = {**_build.sass_opcodes("philox_uniform"), **_build.library_sass_opcodes(rounds_lib)}
    for fn, counts in found.items():
        for piece, name in PHILOX_KERNELS.items():
            if piece in fn:
                short[name + ("_f32" if "IfE" in fn else "")] = counts
    want = set(PHILOX_KERNEL_NAMES) | {"block_f32", "batched_f32"}
    check(set(short) == want, f"Philox SASS: found {sorted(short)} of {sorted(want)}")
    return short


def issue_floors_ms(opcodes: dict, counters: int, per_thread: int) -> tuple[float, float]:
    """Least time for *counters* counters of a kernel whose SASS gives
    *opcodes* for *per_thread* counters a thread, at the full issue rate of
    its busiest integer pipe: (IMAD.WIDE and IMAD.HI at two FMA-pipe slots,
    at one slot). The one-slot floor is also held to the dispatch rate of
    one warp instruction per clock per SM sub-partition (128 lanes per clock
    per SM)."""
    fma2, alu = int_pipe_slots(opcodes)
    fma1 = sum(n for op, n in opcodes.items() if op.startswith("IMAD"))
    instr = sum(opcodes.values())
    two = max(fma2, alu) / per_thread * counters / INT_ISSUE_PER_S * 1e3
    one = max(fma1, alu, instr / 2) / per_thread * counters / INT_ISSUE_PER_S * 1e3
    return two, one


#: the batched Philox kernel's cases beside the main path's array: ragged
#: edges, a last extent not a multiple of 4, 1-D, size 0, full blocks on
#: 16-byte stores beside a scalar edge, 4-D
PHILOX_BLOCK_CASES = [
    ((500, 450, 400), (100, 100, 100)),
    ((13, 11), (4, 5)),
    ((7,), (3,)),
    ((0, 5), (2, 2)),
    ((8, 14), (4, 8)),
    ((50, 45, 40), (10, 10, 20)),
    ((2, 3, 4, 5), (1, 2, 3, 4)),
]


def numpy_blocks(shape, chunks, seeds) -> np.ndarray:
    """numpy's own per-block streams, assembled: block k (C order of the
    block grid) draws from Philox(seed=seeds[k])."""
    out = np.empty(shape, dtype=np.float64)
    grids = [range(0, s, c) if s else range(1) for s, c in zip(shape, chunks)]
    for k, idx in enumerate(np.ndindex(*[len(g) for g in grids])):
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = np.random.Generator(np.random.Philox(seed=int(seeds[k]))).random(out[sel].shape)
    return out


def check_philox(torch, rounds_lib: str) -> dict:
    from cubed_tpu_torch.kernels import _build
    from cubed_tpu_torch.kernels.philox_uniform import (
        _occupancy, blocks_plan, philox_key, philox_keys, philox_uniform, philox_uniform_blocks,
        philox_uniform_blocks_plain, philox_uniform_plain,
    )

    dev = torch.device("cuda")
    # the per-block kernel (sequential executor, fused random ops)
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
    print("philox_uniform (per block): bit-exact against numpy and the plain version, "
          "shapes (100,100,100) (99,100,100) (1000,1000) (7,), 4 seeds each")

    # the batched kernel: every block of an op, in place, in one launch
    max_err = 0.0
    taken = []
    for shape, chunks in PHILOX_BLOCK_CASES:
        nblocks = int(np.prod([-(-s // c) if s else 1 for s, c in zip(shape, chunks)]))
        seeds = 2**30 - 3 + np.arange(nblocks, dtype=np.int64)  # across 2**30, as root + offset can be
        keys = philox_keys(seeds)
        before, paths = philox_uniform.launches, dict(philox_uniform.paths)
        got = philox_uniform_blocks(torch.empty(shape, dtype=torch.float64, device=dev), chunks, keys)
        launched = philox_uniform.launches - before
        again = philox_uniform_blocks(torch.empty(shape, dtype=torch.float64, device=dev), chunks, keys)
        plain = philox_uniform_blocks_plain(shape, chunks, keys, device=dev)
        torch.cuda.synchronize()
        what = f"philox_uniform_blocks {shape} / {chunks}"
        check(launched == (1 if got.numel() else 0), f"{what}: {launched} launches for one call")
        check(torch.equal(got, again), f"{what}: two launches on the same keys differ")
        check(torch.equal(got, plain), f"{what}: differs from the plain version")
        ref = numpy_blocks(shape, chunks, seeds)
        check(np.array_equal(got.cpu().numpy().view(np.uint64), ref.view(np.uint64)),
              f"{what}: differs from numpy's per-block streams")
        if got.numel():
            max_err = max(max_err, float((got - plain).abs().max()))
        taken.append(f"{shape}/{chunks}: {paths_delta(philox_uniform, paths) or 'no launch'}")
        del got, again, plain
    print(f"philox_uniform_blocks: bit-exact against numpy's per-block streams (all "
          f"{5 * 5 * 4} blocks of (500,450,400)/100) and the plain version, one launch per call, "
          f"repeat launches bitwise equal, over {len(PHILOX_BLOCK_CASES)} cases")
    print("philox_uniform_blocks paths: " + "; ".join(taken))
    small = [(torch.empty(s, dtype=torch.float64, device=dev), c,
              philox_keys(np.arange(int(np.prod([-(-n // k) for n, k in zip(s, c)])))))
             for s, c in PHILOX_BLOCK_CASES[1:] if int(np.prod(s))]
    one_launch_per_call(torch, philox_uniform, "philox_blocks_kernel",
                        [lambda a=a: philox_uniform_blocks(*a) for a in small])

    # integer issue slots per counter, from this run's builds; the bound takes
    # the fewest that any build of the rounds shows
    sass = philox_sass(rounds_lib)
    per_counter = {}
    for name, per_thread in (("block", 1), ("rounds", PHILOX_COUNTERS)):
        fma, alu = int_pipe_slots(sass[name])
        per_counter[name] = max(fma, alu) / per_thread
        print(f"{PHILOX_KERNEL_NAMES[name]} SASS: {sum(sass[name].values())} instructions for {per_thread} "
              f"counter(s) a thread; integer issue slots per counter: FMA pipe {fma / per_thread:.2f}, ALU pipe "
              f"{alu / per_thread:.2f}")
    fma, alu = int_pipe_slots(sass["batched"])
    print(f"philox_blocks_kernel SASS (static: both store paths and the per-item set-up, {PHILOX_COUNTERS} "
          f"counters a thread): {sum(sass['batched'].values())} instructions; FMA pipe {fma / PHILOX_COUNTERS:.2f} "
          f"a counter, ALU pipe {alu / PHILOX_COUNTERS:.2f}")
    slots = min(per_counter.values())
    print(f"philox integer issue per counter for the bound: {slots:.2f} slots (the fewest of "
          f"{json.dumps(per_counter)})")

    # timing: one block, the per-block kernel beside the batched kernel on a
    # grid of one block, in turns: whether the per-block kernel could go
    for shape in [(100, 100, 100), (1000, 1000)]:
        n = int(np.prod(shape))
        outs = [(torch.empty(shape, dtype=torch.float64, device=dev), philox_key(s)) for s in range(8)]

        def one_block(out, key):
            return philox_uniform_blocks(out, out.shape, np.array([key], dtype=np.uint64))

        check(torch.equal(philox_uniform(*outs[0]).clone(), one_block(*outs[0])),
              f"philox_uniform {shape}: the batched kernel on one block differs from the per-block kernel")
        fns = [philox_uniform, one_block, one_block, philox_uniform]
        dev_ms = [time_ms(torch, f, outs) for f in fns]
        host = [host_us(torch, f, outs) for f in fns]
        b, by = bound_ms(8 * n, slots * -(-n // 4), INT_ISSUE_PER_S)
        print(f"philox_uniform {shape} f64, one block: per-block kernel {dev_ms[0]:.5f} / {dev_ms[3]:.5f} ms/launch "
              f"({host[0]:.2f} / {host[3]:.2f} us of host time a call); batched kernel on a grid of one block "
              f"{dev_ms[1]:.5f} / {dev_ms[2]:.5f} ms/launch ({host[1]:.2f} / {host[2]:.2f} us); bound {b:.5f} ms "
              f"({by}); {smi_tag()}")
        if shape == (100, 100, 100):
            block_ms = (dev_ms[0] + dev_ms[3]) / 2
            block_plain_ms = time_ms(torch, lambda k: philox_uniform_plain(n, k, device=dev), [(philox_key(1),)],
                                     reps=5)
            print(f"philox_uniform {shape} f64 (per block): {block_ms:.5f} ms/launch, plain {block_plain_ms:.5f} ms, "
                  f"bound {b:.5f} ms ({by}); {smi_tag()}")
        del outs

    # timing: one random array of the main path, batched, beside the per-block route
    # (a per-block launch and a copy into the assembled array, per block)
    shape, chunks = VORTICITY["shape"], (VORTICITY["chunks"],) * 3
    n = int(np.prod(shape))
    seeds = 2**29 + np.arange(100, dtype=np.int64)
    keys = philox_keys(seeds)
    arrays = [torch.empty(shape, dtype=torch.float64, device=dev) for _ in range(2)]
    ms = time_ms(torch, lambda out: philox_uniform_blocks(out, chunks, keys), [(a,) for a in arrays])
    ctas_per_sm = _occupancy(dev)
    p = blocks_plan(arrays[0], chunks, _build.sm_count(dev), ctas_per_sm)
    block_keys = [tuple(int(v) for v in k) for k in keys]
    sels = [tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
            for idx in np.ndindex(5, 5, 4)]

    def per_block_route(out):
        for sel, key in zip(sels, block_keys):
            out[sel] = philox_uniform(
                torch.empty(tuple(x.stop - x.start for x in sel), dtype=torch.float64, device=dev), key)

    route_ms = time_ms(torch, per_block_route, [(a,) for a in arrays], reps=5)
    plain_ms = time_ms(torch, lambda: philox_uniform_blocks_plain(shape, chunks, keys, device=dev), [()], reps=1)
    block_counters = [-(-int(np.prod([x.stop - x.start for x in sel])) // 4) for sel in sels]
    counters = sum(block_counters)

    # the rounds alone (chip_smoke_csrc/philox_rounds.cu), on the same work
    # items, beside their issue floors: whether IMAD.WIDE takes two
    # FMA-pipe slots (the bound's model) or one
    rounds = ctypes.CDLL(rounds_lib).philox_rounds_f64
    rounds.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rounds.restype = ctypes.c_int
    keys_dev = torch.from_numpy(keys.view(np.int64)).to(dev)
    counters_dev = torch.tensor(block_counters, dtype=torch.int32, device=dev)

    check(p.per_block[1] != 0, "philox_rounds takes more than one work item a block")

    def rounds_only(out):
        err = rounds(out.data_ptr(), keys_dev.data_ptr(), counters_dev.data_ptr(), *p.per_block, p.items, p.grid,
                     torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "philox_rounds")

    rounds_ms = time_ms(torch, rounds_only, [(a,) for a in arrays])
    two, one = issue_floors_ms(sass["rounds"], counters, PHILOX_COUNTERS)
    print(f"philox_rounds_kernel, rounds only ({counters} counters, nothing stored): {rounds_ms:.5f} ms; "
          f"its issue floor with IMAD.WIDE at two FMA-pipe slots {two:.5f} ms ({100 * two / rounds_ms:.1f}%), "
          f"at one slot {one:.5f} ms ({100 * one / rounds_ms:.1f}%); {smi_tag()}")
    b, by = bound_ms(8 * n, slots * counters, INT_ISSUE_PER_S)
    print(f"philox_uniform_blocks {shape}/{chunks[0]} f64 ({p.grid} CTAs of {p.items} work items, "
          f"{ctas_per_sm} CTAs/SM): {ms:.5f} ms/launch ({100 * b / ms:.1f}% of bound); the per-block route "
          f"(100 per-block launches + copies) {route_ms:.5f} ms; plain {plain_ms:.5f} ms; bound {b:.5f} ms "
          f"({by}: bytes {8 * n / HBM_BYTES_PER_S * 1e3:.5f} ms, integer issue "
          f"{slots * counters / INT_ISSUE_PER_S * 1e3:.5f} ms for {counters} counters at "
          f"{slots:.2f} slots); {smi_tag()}")
    del arrays
    return dict(
        name="philox_uniform", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/philox_uniform.cu",
        replaces="cubed_tpu/random.py:217 (_random_block; _philox_block :137)",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        slots=slots, sass=sass,
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


def one_launch_per_call(torch, wrapper, kernel_key, calls: list) -> None:
    """Run *calls* (thunks) under torch.profiler: the device must run exactly
    one kernel named *kernel_key* (or any of a tuple of names) per launch the
    wrapper counts, and no other kernel (no copy of an input, no second
    pass). Any other kernel, or more of these than counted, fails at once; a
    reading with fewer than counted (the profiler dropped a record, see
    PERF.md) is not used, and the session runs again, up to
    PROFILE_ATTEMPTS sessions in all."""
    keys = (kernel_key,) if isinstance(kernel_key, str) else tuple(kernel_key)
    kernel_key = "+".join(keys)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = wrapper.launches
        session: list = []
        kernels = kernel_launches_by_name(torch, lambda: [c() for c in calls], session)
        launched = wrapper.launches - before
        ours = sum(n for k, n in kernels.items() if any(key in k for key in keys))
        others = {k: n for k, n in kernels.items() if not any(key in k for key in keys)}
        print(f"{kernel_key}: {len(calls)} calls, {launched} counted launches, profiler: {ours} "
              f"{kernel_key} kernels, other kernels {others or 'none'} (session {attempt})")
        if ours < launched:
            print(f"{kernel_key}: session {attempt} recorded fewer kernels than counted; its raw records:\n"
                  + session_report(*session[0]))
        check(ours <= launched and not others,
              f"{kernel_key}: {ours} kernels and {others} for {launched} counted launches")
        if ours == launched:
            return
    check(False, f"{kernel_key}: no session of {PROFILE_ATTEMPTS} recorded every counted launch")


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


def check_fma_one_block(torch) -> None:
    """fma_sum, the chunked path's unit: fma_sum_blocks on a grid of one
    block, on the cases the per-block kernel it replaced was held to."""
    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_blocks, fma_sum_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    # four resident-sized arrays, as the index ops leave them: the device
    # executor's chunked path hands fma_sum (100, 100, 100) views with
    # strides (180000, 400, 1)
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
    taken = []
    for label, (a, x, b, y) in cases:
        before, paths = fma_sum_blocks.launches, dict(fma_sum_blocks.paths)
        k1 = fma_sum(a, x, b, y)
        launched = fma_sum_blocks.launches - before
        k2 = fma_sum(a, x, b, y)
        p = fma_sum_plain(a, x, b, y)
        torch.cuda.synchronize()
        check(launched == (1 if a.numel() else 0), f"fma_sum {label}: {launched} launches for one call")
        check(torch.equal(k1, k2), f"fma_sum {label}: two launches differ")
        check(k1.shape == p.shape and k1.dtype == p.dtype == torch.float64, f"fma_sum {label}: shape/dtype")
        scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
        err = float((k1 - p).abs().max()) if k1.numel() else 0.0
        check(err <= 1e-12 * scale, f"fma_sum {label}: |kernel - plain| {err} beyond 1e-12 * {scale}")
        taken.append(f"{label}: {paths_delta(fma_sum_blocks, paths)}")
    print("fma_sum (fma_sum_blocks on a grid of one block): within 1e-12 of sum(|a*x| + |b*y|) of the plain "
          "version, one launch per call (none for size 0), repeat launches bitwise equal, over", len(cases), "cases")
    print("fma_sum paths: " + "; ".join(taken))
    one_launch_per_call(torch, fma_sum_blocks, "fma_blocks_kernel",
                        [lambda ts=ts: fma_sum(*ts) for _, ts in cases if ts[0].numel()])

    # timing at the chunked path's shape: distinct block views (256 MB of
    # reads in all, past the 50 MB L2), device and host time
    views = main_path_views(bases)
    ms = time_ms(torch, fma_sum, views)
    host = host_us(torch, fma_sum, views)
    plain_ms = time_ms(torch, fma_sum_plain, views)
    n = 100 * 100 * 100
    b, by = bound_ms(4 * 8 * n + 8, 3 * n)  # 4 inputs read, one float64 written; 2 mul + 1 add
    print(f"fma_sum (100,100,100) f64 views, one block: {ms:.5f} ms/launch ({host:.2f} us of host time a call), "
          f"plain {plain_ms:.5f} ms, bound {b:.5f} ms ({by}); {smi_tag()}")
    del bases


#: fma_sum_blocks' cases: (label, base shape, chunks, dtype name, view of
#: each base); the main path's ragged grid of [1:] views first
FMA_BLOCK_CASES = [
    ("main path: [1:] views of (500,450,400) / 100", (500, 450, 400), (100, 100, 100), "float64",
     lambda t: t[1:]),
    ("(50,45,40)[1:] / 10", (50, 45, 40), (10, 10, 10), "float64", lambda t: t[1:]),
    ("(50,45,40)[1:] / 10 float32", (50, 45, 40), (10, 10, 10), "float32", lambda t: t[1:]),
    ("odd (37,29,13) / (8,7,5)", (37, 29, 13), (8, 7, 5), "float64", lambda t: t),
    ("misaligned (60,40,33)[1:, :, 1:] / (10,10,8)", (60, 40, 33), (10, 10, 8), "float64",
     lambda t: t[1:, :, 1:]),
    ("1-D (1001,)[1:] / 300 float32", (1001,), (300,), "float32", lambda t: t[1:]),
    ("4-D (6,6,4,6)[1:] / (2,4,3,4)", (6, 6, 4, 6), (2, 4, 3, 4), "float64", lambda t: t[1:]),
]


def per_block_fma(torch, ts, chunks):
    """The per-block route: one fma_sum launch a block, stacked."""
    from cubed_tpu_torch.kernels.fma_sum import fma_sum

    grid = [range(0, n, c) for n, c in zip(ts[0].shape, chunks)]
    out = torch.empty([len(g) for g in grid], dtype=torch.float64, device=ts[0].device)
    for idx in itertools.product(*[range(len(g)) for g in grid]):
        sel = tuple(slice(i * c, i * c + c) for i, c in zip(idx, chunks))
        out[idx] = fma_sum(*[t[sel] for t in ts]).reshape(())
    return out


def check_fma_sum_blocks(torch) -> dict:
    from cubed_tpu_torch.kernels.fma_sum import blocks_plan, fma_sum_blocks, fma_sum_blocks_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    max_err = 0.0
    taken = []
    calls = []
    main = None
    for label, shape, chunks, dt, view in FMA_BLOCK_CASES:
        bases = [torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(getattr(torch, dt))
                 for _ in range(4)]
        ts = [view(b) for b in bases]
        before, paths = fma_sum_blocks.launches, dict(fma_sum_blocks.paths)
        k1 = fma_sum_blocks(*ts, chunks)
        launched = fma_sum_blocks.launches - before
        k2 = fma_sum_blocks(*ts, chunks)
        plain = fma_sum_blocks_plain(*ts, chunks)
        per_block = per_block_fma(torch, ts, chunks)
        a, x, b, y = ts
        # |kernel - other| <= 1e-12 * each block's sum(|a*x| + |b*y|)
        scale = fma_sum_blocks_plain(a.abs(), x.abs(), b.abs(), y.abs(), chunks)
        torch.cuda.synchronize()
        what = f"fma_sum_blocks {label}"
        check(launched == 1, f"{what}: {launched} launches for one call")
        check(torch.equal(k1, k2), f"{what}: two launches differ")
        check(k1.shape == plain.shape and k1.dtype == torch.float64, f"{what}: shape/dtype")
        for other, name in ((plain, "plain version"), (per_block, "per-block fma_sum")):
            err = (k1 - other).abs()
            check(bool((err <= 1e-12 * scale).all()), f"{what}: beyond 1e-12 of the {name}")
        max_err = max(max_err, float((k1 - plain).abs().max()))
        p = blocks_plan(*ts, chunks)
        taken.append(f"{label}: {paths_delta(fma_sum_blocks, paths)} ({p.items} work items, "
                     f"{p.per_block[0]} a block)")
        calls.append((ts, chunks))
        if main is None:
            main = (ts, chunks)
    print(f"fma_sum_blocks: within 1e-12 of each block's sum(|a*x| + |b*y|) of the plain version and of "
          f"per-block fma_sum, one launch per call, repeat launches bitwise equal, over {len(calls)} cases")
    print("fma_sum_blocks paths: " + "; ".join(taken))
    check(all(fma_sum_blocks.paths.values()), f"fma_sum_blocks: a path never taken: {fma_sum_blocks.paths}")
    one_launch_per_call(torch, fma_sum_blocks, "fma_blocks_kernel",
                        [lambda c=c: fma_sum_blocks(*c[0], c[1]) for c in calls])

    ts, chunks = main
    ms = time_ms(torch, fma_sum_blocks, [(*ts, chunks)])
    route_ms = time_ms(torch, per_block_fma, [(torch, ts, chunks)], reps=5)
    plain_ms = time_ms(torch, fma_sum_blocks_plain, [(*ts, chunks)], reps=2)
    n = ts[0].numel()
    nblocks = 5 * 5 * 4
    b, by = bound_ms(4 * 8 * n + 8 * nblocks, 3 * n)  # 4 inputs read, a float64 a block written
    print(f"fma_sum_blocks {tuple(ts[0].shape)} f64 [1:] views / 100 ({nblocks} blocks): {ms:.5f} ms/launch "
          f"({100 * b / ms:.1f}% of bound); the per-block route (100 fma_sum launches) {route_ms:.5f} ms; "
          f"plain {plain_ms:.5f} ms; bound {b:.5f} ms ({by}: {4 * 8 * n / 1e6:.2f} MB read); {smi_tag()}")
    return dict(
        name="fma_sum_blocks", route="cuda",
        source="cubed_tpu_torch/kernels/csrc/fma_sum.cu",
        replaces="cubed_tpu/kernels/reductions.py:257 (fused_fma_mean; pallas_call :300) at 0cd9f84^",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
    )


def check_batched_rules(torch, slots: float) -> None:
    """The batching rules of region_sum's and Philox's custom ops under
    torch.func.vmap, against their plain versions: one kernel per batched
    call (torch.profiler), and their times at addsum's fused op, (5, 5,
    1000, 1000), beside their bounds and torch.sum."""
    from cubed_tpu_torch.kernels.philox_uniform import (
        philox_blocks, philox_keys, philox_uniform, philox_uniform_blocks_plain,
    )
    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    vmap = torch.func.vmap
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    base = torch.rand((500, 450, 400), generator=gen, device=dev, dtype=torch.float64)[1:]
    st = base.stride()
    grid = base.as_strided((4, 4, 4, 100, 100, 100), tuple(100 * s for s in st) + st)
    stacked = [(torch.rand((5, 5, 1000, 1000), generator=gen, device=dev, dtype=torch.float64),)
               for _ in range(2)]
    cases = [(grid, axes, 3) for axes in ((0, 1, 2), (0,), (1, 2))] + [(stacked[0][0], (0, 1), 2)]
    rule_calls = []
    for x, axes, levels in cases:
        f = lambda b, axes=axes: region_sum(b, axes)  # noqa: E731
        for _ in range(levels):
            f = vmap(f)
        before = region_sum.launches
        got = f(x)
        launched = region_sum.launches - before
        plain = region_sum_plain(x, tuple(a + levels for a in axes))
        scale = region_sum_plain(x.abs(), tuple(a + levels for a in axes))
        torch.cuda.synchronize()
        what = f"region_sum rule {tuple(x.shape)} in-block axes {axes}"
        check(launched == 1, f"{what}: {launched} launches")
        check(bool(((got - plain).abs() <= 1e-12 * scale).all()), f"{what}: beyond 1e-12 of sum(|x|)")
        rule_calls.append(lambda f=f, x=x: f(x))
    print(f"region_sum batching rule: {len(cases)} grid views, one launch each, within 1e-12 of sum(|x|)")
    one_launch_per_call(torch, region_sum, "region_sum", rule_calls)

    like = torch.zeros((), dtype=torch.float64, device=dev).expand(1000, 1000)
    seeds = (2**30 - 7 + torch.arange(25, dtype=torch.int64)).reshape(5, 5, 1, 1)
    rule = vmap(vmap(lambda s: philox_blocks(like, s)))
    before = philox_uniform.launches
    got = rule(seeds)
    torch.cuda.synchronize()
    check(philox_uniform.launches - before == 1, "Philox rule: not one launch")
    host = got.cpu().numpy()
    for i, j in itertools.product(range(5), range(5)):
        want = np.random.Generator(np.random.Philox(seed=int(seeds[i, j, 0, 0]))).random((1000, 1000))
        check(np.array_equal(host[i, j].view(np.uint64), want.view(np.uint64)),
              f"Philox rule: block ({i}, {j}) differs from numpy")
    print("Philox batching rule: (5, 5) blocks of (1000, 1000) in one launch, bit for bit numpy's streams")
    one_launch_per_call(torch, philox_uniform, "philox_blocks_kernel", [lambda: rule(seeds)])

    reduce_rule = vmap(vmap(lambda b: region_sum(b, (0, 1))))
    ms = time_ms(torch, reduce_rule, stacked)
    lib = time_ms(torch, lambda x: torch.sum(x, dim=(2, 3), keepdim=True), stacked)
    plain = time_ms(torch, lambda x: region_sum_plain(x, (2, 3)), stacked)
    b, by = bound_ms(8 * 25e6 + 8 * 25, 25e6)
    print(f"region_sum rule (5,5,1000,1000) f64 over the in-block axes: {ms:.5f} ms/launch "
          f"({100 * b / ms:.1f}% of bound), torch.sum {lib:.5f} ms, plain {plain:.5f} ms, bound {b:.5f} ms "
          f"({by}); {smi_tag()}")
    ms = time_ms(torch, rule, [(seeds,)])
    # the plain version of the same 25 blocks (each keyed as the rule keys it)
    keys = philox_keys(seeds.reshape(-1).numpy())
    plain = time_ms(torch, lambda: philox_uniform_blocks_plain((5000, 5000), (1000, 1000), keys, device=dev),
                    [()], reps=2)
    counters = 25 * 250_000
    b, by = bound_ms(8 * 25e6, slots * counters, INT_ISSUE_PER_S)
    print(f"Philox rule (5,5) blocks of (1000,1000) f64: {ms:.5f} ms/launch ({100 * b / ms:.1f}% of bound), "
          f"plain {plain:.5f} ms, bound {b:.5f} ms ({by}); {smi_tag()}")
    del base, grid, stacked


# ---------------------------------------------------------------------------
# phase 3, float32: the Philox kernels' float32 entry points and the float32
# routes of fma_sum_blocks and region_sum (compute_dtype="float32")
# ---------------------------------------------------------------------------

#: the float32 per-block entry point's cases: (shape, offset of the output
#: from a 16-byte aligned base, in elements): vorticity_f32's blocks of
#: (100, 100, 100), ragged and odd sizes, and an output 4 bytes off (scalar
#: stores)
PHILOX_F32_BLOCK_CASES = [((100, 100, 100), 0), ((99, 100, 100), 0), ((1000, 1000), 0), ((7,), 0),
                          ((1001,), 1), ((99, 100, 101), 3)]


def f32_bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def check_philox_f32(torch, slots: float, sass: dict) -> list:
    """The float32 entry points of both Philox kernels, bit for bit numpy's
    float64 streams rounded to float32 and their plain versions: per block
    at vorticity_f32's (100, 100, 100) blocks, odd sizes and a misaligned
    output; batched at vorticity_f32's (500, 450, 400) / 100 array (the
    batched route's layout) and the float64 cases' ragged, 1-D, 4-D and
    size-0 grids, with strided and misaligned outputs; one launch per call
    and one kernel per call; each timed behind the spin kernel beside its
    plain version and its bound (4 bytes an element or the integer floor)."""
    from cubed_tpu_torch.kernels.philox_uniform import (
        philox_key, philox_keys, philox_uniform, philox_uniform_blocks, philox_uniform_blocks_plain,
        philox_uniform_plain,
    )

    dev = torch.device("cuda")
    f32 = torch.float32
    max_err = {"block": 0.0, "batched": 0.0}
    for shape, offset in PHILOX_F32_BLOCK_CASES:
        n = int(np.prod(shape))
        for seed in (0, 123456789, 2**30 + 96):
            base = torch.full((n + offset,), -1.0, dtype=f32, device=dev)
            out = base[offset:].view(shape)
            before = dict(philox_uniform.paths)
            philox_uniform(out, philox_key(seed))
            plain = philox_uniform_plain(n, philox_key(seed), device=dev, dtype=f32).reshape(shape)
            torch.cuda.synchronize()
            what = f"philox_uniform f32 {shape} offset {offset} seed {seed}"
            check(philox_uniform.paths["block_f32"] == before["block_f32"] + 1, f"{what}: not one f32 launch")
            ref = np.random.Generator(np.random.Philox(seed=seed)).random(shape).astype(np.float32)
            check(np.array_equal(f32_bits(out.cpu().numpy()), ref.view(np.uint32)),
                  f"{what}: differs from numpy's float64 stream rounded to float32")
            check(torch.equal(out.view(torch.int32), plain.view(torch.int32)), f"{what}: differs from plain")
            check(offset == 0 or float(base[offset - 1]) == -1.0, f"{what}: wrote before its output")
    print(f"philox_uniform (per block, float32): bit for bit numpy's float64 stream rounded to float32 and the "
          f"plain version, {len(PHILOX_F32_BLOCK_CASES)} shapes (outputs 4 and 12 bytes off 16 included), 3 seeds "
          f"each")
    one_launch_per_call(torch, philox_uniform, "philox_uniform_kernel",
                        [lambda s=s: philox_uniform(torch.empty(s, dtype=f32, device=dev), philox_key(5))
                         for s, _ in PHILOX_F32_BLOCK_CASES])

    layouts = [(shape, chunks, None) for shape, chunks in PHILOX_BLOCK_CASES] + [
        ((64, 48), (16, 16), ("column-view", 80, 16)),
        ((64, 48), (16, 16), ("misaligned", 48, 1)),
        ((64, 48), (16, 16), ("rows of 50", 50, 2)),
        ((25, 1000000), (1, 1000000), None),  # the Philox batching rule's (n, size) fill
    ]
    taken = []
    thunks = []
    for shape, chunks, strided in layouts:
        nblocks = int(np.prod([-(-n // c) if n else 1 for n, c in zip(shape, chunks)]))
        seeds = 2**30 - 3 + np.arange(nblocks, dtype=np.int64)
        keys = philox_keys(seeds)
        if strided is None:
            out = torch.empty(shape, dtype=f32, device=dev)
        else:
            _, width, first = strided
            base = torch.full((shape[0] * width + first,), -1.0, dtype=f32, device=dev)
            out = base[first: first + shape[0] * width].view(shape[0], width)[:, :shape[1]]
        before = dict(philox_uniform.paths)
        philox_uniform_blocks(out, chunks, keys)
        plain = philox_uniform_blocks_plain(shape, chunks, keys, device=dev, dtype=f32)
        torch.cuda.synchronize()
        what = f"philox_uniform_blocks f32 {shape} / {chunks}" + (f" {strided[0]}" if strided else "")
        check(philox_uniform.paths["batched_f32"] - before["batched_f32"] == (1 if out.numel() else 0),
              f"{what}: not one float32 launch")
        check(torch.equal(out.contiguous().view(torch.int32), plain.view(torch.int32)), f"{what}: differs from plain")
        if out.numel() and out.numel() <= 10**8:
            ref = numpy_blocks(shape, chunks, seeds).astype(np.float32)
            check(np.array_equal(f32_bits(out.cpu().numpy()), ref.view(np.uint32)),
                  f"{what}: differs from numpy's per-block streams rounded to float32")
        taken.append(f"{shape}/{chunks}{' ' + strided[0] if strided else ''}: "
                     f"{paths_delta(philox_uniform, before) or 'no launch'}")
        if out.numel():
            thunks.append(lambda out=out, chunks=chunks, keys=keys: philox_uniform_blocks(out, chunks, keys))
        del plain
    print(f"philox_uniform_blocks (float32): bit for bit numpy's per-block streams rounded to float32 and the "
          f"plain version, one float32 launch per call, over {len(layouts)} layouts")
    print("philox_uniform_blocks float32 paths: " + "; ".join(taken))
    one_launch_per_call(torch, philox_uniform, "philox_blocks_kernel", thunks[:8])
    del thunks

    for name in ("block_f32", "batched_f32"):
        per_thread = 1 if name == "block_f32" else PHILOX_COUNTERS
        fma, alu = int_pipe_slots(sass[name])
        print(f"{name} SASS: {sum(sass[name].values())} instructions for {per_thread} counter(s) a thread; "
              f"FMA pipe {fma / per_thread:.2f} a counter, ALU pipe {alu / per_thread:.2f}; F2F "
              f"{sum(v for k, v in sass[name].items() if k.startswith('F2F'))}")

    # timing: one (100, 100, 100) block (the per-block entry point), and the
    # main path's array (the batched one), behind the spin kernel
    shape = (100, 100, 100)
    n = int(np.prod(shape))
    outs = [(torch.empty(shape, dtype=f32, device=dev), philox_key(s)) for s in range(8)]
    block_ms = time_ms(torch, philox_uniform, outs)
    block_plain_ms = time_ms(torch, lambda k: philox_uniform_plain(n, k, device=dev, dtype=f32),
                             [(philox_key(1),)], reps=5)
    block_b, block_by = bound_ms(4 * n, slots * -(-n // 4), INT_ISSUE_PER_S)
    print(f"philox_uniform {shape} f32 (per block): {block_ms:.5f} ms/launch ({100 * block_b / block_ms:.1f}% of "
          f"bound), plain {block_plain_ms:.5f} ms, bound {block_b:.5f} ms ({block_by}: bytes "
          f"{4 * n / HBM_BYTES_PER_S * 1e3:.5f} ms); {smi_tag()}")
    shape, chunks = VORTICITY["shape"], (VORTICITY["chunks"],) * 3
    n = int(np.prod(shape))
    keys = philox_keys(2**29 + np.arange(100, dtype=np.int64))
    arrays = [(torch.empty(shape, dtype=f32, device=dev),) for _ in range(2)]
    ms = time_ms(torch, lambda out: philox_uniform_blocks(out, chunks, keys), arrays)
    f64_arrays = [(torch.empty(shape, dtype=torch.float64, device=dev),) for _ in range(2)]
    ms64 = time_ms(torch, lambda out: philox_uniform_blocks(out, chunks, keys), f64_arrays)
    del f64_arrays
    plain_ms = time_ms(torch, lambda: philox_uniform_blocks_plain(shape, chunks, keys, device=dev, dtype=f32),
                       [()], reps=1)
    counters = sum(-(-int(np.prod(block)) // 4) for block in itertools.product(
        *[[min(c, d - i) for i in range(0, d, c)] for d, c in zip(shape, chunks)]))
    b, by = bound_ms(4 * n, slots * counters, INT_ISSUE_PER_S)
    print(f"philox_uniform_blocks {shape}/{chunks[0]} f32: {ms:.5f} ms/launch ({100 * b / ms:.1f}% of bound; "
          f"float64 on the same work {ms64:.5f} ms, in this call), plain {plain_ms:.5f} ms, bound {b:.5f} ms ({by}: "
          f"bytes {4 * n / HBM_BYTES_PER_S * 1e3:.5f} ms, integer issue "
          f"{slots * counters / INT_ISSUE_PER_S * 1e3:.5f} ms at {slots:.2f} slots a counter); {smi_tag()}")
    source = "cubed_tpu_torch/kernels/csrc/philox_uniform.cu"
    replaces = "cubed_tpu/random.py:217 (_random_block; _philox_block :137)"
    return [
        dict(name="philox_uniform_f32", route="cuda", source=source, replaces=replaces,
             max_abs_err=0.0, ms=block_ms, plain_ms=block_plain_ms, bound_ms=block_b, bound_by=block_by,
             library_ms=None),
        dict(name="philox_uniform_blocks_f32", route="cuda", source=source, replaces=replaces,
             max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None),
    ]


def check_f32_routes(torch) -> list:
    """fma_sum_blocks and region_sum on float32 inputs, as compute_dtype=
    "float32" gives them: fma_sum_blocks on the [1:] views of four
    (500, 450, 400) float32 arrays / 100 (vorticity_f32's fused reduction),
    region_sum over all axes of (100, 100, 100) float32 blocks; each within
    1e-12 (fma_sum_blocks, a float64 result) or 1e-6 (region_sum, rounded to
    float32) of the sum of magnitudes of its plain version (both accumulate
    in float64), timed beside its plain version, its bound (4 bytes an
    element read) and, for region_sum, torch.sum."""
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks, fma_sum_blocks_plain
    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    f32 = torch.float32
    bases = [torch.rand(VORTICITY["shape"], generator=gen, device=dev, dtype=f32) for _ in range(4)]
    ts = [t[1:] for t in bases]
    chunks = (VORTICITY["chunks"],) * 3
    before = dict(fma_sum_blocks.paths)
    got = fma_sum_blocks(*ts, chunks)
    plain = fma_sum_blocks_plain(*ts, chunks)
    scale = fma_sum_blocks_plain(*(t.abs() for t in ts), chunks)
    torch.cuda.synchronize()
    check(fma_sum_blocks.paths["float32"] == before["float32"] + 1, "fma_sum_blocks f32: not one float32 launch")
    check(bool(((got - plain).abs() <= 1e-12 * scale).all()), "fma_sum_blocks f32: beyond 1e-12 of sum(|a*x|+|b*y|)")
    fma_err = float((got - plain).abs().max())
    print(f"fma_sum_blocks f32 [1:] views / 100: within 1e-12 of each block's sum of magnitudes of the plain "
          f"version (max abs err {fma_err:.3e}), paths {paths_delta(fma_sum_blocks, before)}")
    fma_ms = time_ms(torch, fma_sum_blocks, [(*ts, chunks)])
    fma_plain_ms = time_ms(torch, fma_sum_blocks_plain, [(*ts, chunks)], reps=2)
    n = ts[0].numel()
    fma_b, fma_by = bound_ms(4 * 4 * n + 8 * 100, 3 * n)
    print(f"fma_sum_blocks {tuple(ts[0].shape)} f32 [1:] views / 100: {fma_ms:.5f} ms/launch "
          f"({100 * fma_b / fma_ms:.1f}% of bound), plain {fma_plain_ms:.5f} ms, bound {fma_b:.5f} ms ({fma_by}: "
          f"{4 * 4 * n / 1e6:.2f} MB read); {smi_tag()}")
    del bases, ts

    xs = [(torch.rand((100, 100, 100), generator=gen, device=dev, dtype=f32),) for _ in range(8)]
    region_err = 0.0
    for (x,) in xs:
        # both sum in float64 and round the total to float32: within a
        # float32 rounding of the sum of magnitudes
        got, plain = region_sum(x, None), region_sum_plain(x, None)
        scale = region_sum_plain(x.abs().double(), None)
        check(bool(((got.double() - plain.double()).abs() <= 1e-6 * scale).all()),
              "region_sum f32: beyond 1e-6 of sum(|x|) of the plain version")
        region_err = max(region_err, float((got.double() - plain.double()).abs().max()))
    ms = time_ms(torch, lambda x: region_sum(x, None), xs)
    plain_ms = time_ms(torch, lambda x: region_sum_plain(x, None), xs)
    library_ms = time_ms(torch, lambda x: torch.sum(x), xs)
    n = 10**6
    b, by = bound_ms(4 * n + 4, n)
    print(f"region_sum (100,100,100) f32 all axes: {ms:.5f} ms/launch ({100 * b / ms:.1f}% of bound), plain "
          f"{plain_ms:.5f} ms, torch.sum {library_ms:.5f} ms, bound {b:.5f} ms ({by}); {smi_tag()}")
    return [
        dict(name="fma_sum_blocks_f32", route="cuda", source="cubed_tpu_torch/kernels/csrc/fma_sum.cu",
             replaces="cubed_tpu/kernels/reductions.py:257 (fused_fma_mean; pallas_call :300) at 0cd9f84^",
             max_abs_err=fma_err, ms=fma_ms, plain_ms=fma_plain_ms, bound_ms=fma_b, bound_by=fma_by,
             library_ms=None),
        dict(name="region_sum_f32", route="cuda", source="cubed_tpu_torch/kernels/csrc/region_sum.cu",
             replaces="cubed_tpu/kernels/reductions.py:192 (region_sum; block_sum :84) at 0cd9f84^",
             max_abs_err=region_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=library_ms),
    ]


def main_path_views(bases) -> list:
    """Eight sets of four (100, 100, 100) block views of the four bases."""
    return [tuple(base[i * 100:(i + 1) * 100, j * 100:(j + 1) * 100, 0:100] for base in bases)
            for i, j in itertools.product(range(4), range(2))]


def against_cases(torch, m_fma, m_region) -> list:
    """(label, function, argument sets) of the ``--against`` timings, for one
    checkout's fma_sum and region_sum modules, on inputs drawn from a fixed
    seed (so every process draws the same ones)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bases = [torch.rand((499, 450, 400), generator=gen, device="cuda", dtype=torch.float64)
             for _ in range(4)]
    blocks = [(torch.rand((100, 100, 100), generator=gen, device="cuda", dtype=torch.float64),)
              for _ in range(8)]

    def region(axes):
        return lambda x: m_region.region_sum(x, axes)

    small = [tuple(t[i * 40:(i + 1) * 40, j * 40:(j + 1) * 40, 0:40] for t in bases)
             for i, j in itertools.product(range(8), range(4))]
    return [
        ("fma_sum (100,100,100) f64 views", m_fma.fma_sum, main_path_views(bases)),
        ("fma_sum (40,40,40) f64 views", m_fma.fma_sum, small),
        ("region_sum (100,100,100) f64 contiguous, all axes", region(None), blocks),
    ] + [(f"region_sum {label}", region(axes), args) for label, args, axes, _ in region_timings(torch, gen, bases[0])]


def time_against_cases(torch) -> list:
    """[label, device ms, host us] of every ``--against`` case, for the
    cubed_tpu_torch this process imported."""
    from cubed_tpu_torch.kernels import _build, fma_sum, region_sum

    _build.build_all()
    return [[label, time_ms(torch, fn, args), host_us(torch, fn, args)]
            for label, fn, args in against_cases(torch, fma_sum, region_sum)]


#: rounds of the device computes in ``--against`` (each round: theirs,
#: ours, ours, theirs, every one in a fresh process)
COMPUTE_ROUNDS = 3
#: the cells ``--time-computes`` runs, in the order of the full run
#: (vorticity first, then BASELINE configs 2-4): each a new CudaExecutor
TIMED_CELLS = ("vorticity", "elemwise", "reduce", "matmul")


def time_computes(torch) -> dict:
    """Seconds of each TIMED_CELLS cell's four device ``compute()``s on one
    new ``CudaExecutor`` (cold, capturing, two warm), as phase 4 runs them,
    for the cubed_tpu_torch this process imported; the cells one after the
    other in this process, so a later cell's capture finds the earlier
    cells' graphs cached, as in the full run."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    builds = {"vorticity": vorticity_build, "elemwise": elemwise_build, "reduce": reduce_build,
              "matmul": matmul_build}
    out = {}
    for cell in TIMED_CELLS:
        ex = CudaExecutor()
        seconds = []
        for i, seed in enumerate((SEED, SEED + 1, SEED + 2, SEED + 3)):
            work = os.path.join(WORK_DIR, f"computes-{os.getpid()}-{cell}-{i}")
            random.seed(seed)
            x = builds[cell](cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB"))
            x.plan._finalize(array_names=(x.name,))
            torch.cuda.synchronize()
            t = time.perf_counter()
            value = float(x.compute(executor=ex))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            shutil.rmtree(work, ignore_errors=True)
            check(np.isfinite(value), f"{cell} compute {i}: value {value}")
            check(ex.stats["segments_compiled"] == (1 if i == 1 else 0)
                  and ex.stats["segment_struct_hits"] == (1 if i >= 2 else 0),
                  f"{cell} compute {i}: stats {dict(ex.stats)}")
        out[cell] = seconds
    return out


def time_in_process(flag: str, path: str) -> list:
    """This script's ``flag PATH`` run in a process of its own: the JSON on
    its last line (the kernel modules of two checkouts register the same
    custom ops, which one process cannot hold twice)."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, os.path.abspath(path)],
                          capture_output=True, text=True, timeout=900, cwd=REPO)
    check(proc.returncode == 0, f"{flag} {path}: the run failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare_against(torch, path: str) -> None:
    """Time this checkout's fma_sum and region_sum beside another checkout's
    (at *path*, built from its own sources, timed in a process of its own)
    on the same inputs, in turns: theirs, ours, ours, theirs, by device and
    host time. Against a checkout that still has fma_sum's own kernel
    (before fma_sum_blocks took its place), the fma_sum rows hold that
    kernel against fma_sum_blocks on a grid of one block. Then the four
    device computes (cold, capturing, warm, warm) of each of TIMED_CELLS,
    each checkout in a fresh process, in turns, COMPUTE_ROUNDS rounds."""
    first = time_in_process("--time-kernels", path)
    ours = [time_against_cases(torch), time_against_cases(torch)]
    last = time_in_process("--time-kernels", path)
    for (label, t0, h0), (_, t1, h1), (_, t2, h2), (_, t3, h3) in zip(first, *ours, last):
        print(f"against {path}: {label}: theirs {t0:.5f} / {t3:.5f} ms "
              f"({h0:.2f} / {h3:.2f} us of host time a call), ours {t1:.5f} / {t2:.5f} ms "
              f"({h1:.2f} / {h2:.2f} us); ours/theirs device "
              f"{(t1 + t2) / (t0 + t3):.3f}, host {(h1 + h2) / (h0 + h3):.3f}; {smi_tag()}")
    runs: dict = {"theirs": [], "ours": []}
    for _ in range(COMPUTE_ROUNDS):
        for side in ("theirs", "ours", "ours", "theirs"):
            runs[side].append(time_in_process("--time-computes", path if side == "theirs" else REPO))
    for cell in TIMED_CELLS:
        for side, secs in runs.items():
            print(f"against {path}: {cell} device computes, {side}, s (cold, capturing, warm, warm; a fresh "
                  f"process each): " + "; ".join(" / ".join(f"{t:.4f}" for t in r[cell]) for r in secs)
                  + f"; {smi_tag()}")
        for i, what in enumerate(("cold", "capturing", "warm", "warm")):
            theirs, ours = ([r[cell][i] for r in runs[side]] for side in ("theirs", "ours"))
            q = {side: np.percentile(v, [25, 50, 75]) for side, v in (("theirs", theirs), ("ours", ours))}
            print(f"against {path}: {cell} {what} compute, median of {len(ours)} (quartile spread): theirs "
                  f"{q['theirs'][1]:.4f} s ({q['theirs'][2] - q['theirs'][0]:.4f}), ours {q['ours'][1]:.4f} s "
                  f"({q['ours'][2] - q['ours'][0]:.4f}), ours/theirs {q['ours'][1] / q['theirs'][1]:.3f}")


# ---------------------------------------------------------------------------
# phase 4: the main path and its oracle
# ---------------------------------------------------------------------------


def oracle_random(shape, chunks, root_seed) -> np.ndarray:
    """numpy's own per-block streams: block at linear offset k draws from
    Philox(seed=root_seed + k). *chunks* an int or one per axis. The blocks
    are drawn on the host's cores (numpy's generators release the GIL while
    they fill)."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(shape, dtype=np.float64)
    chunks = (chunks,) * len(shape) if isinstance(chunks, int) else tuple(chunks)
    grids = [range(0, s, c) for s, c in zip(shape, chunks)]
    nblocks = [len(g) for g in grids]

    def draw(idx):
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        k = int(np.ravel_multi_index(idx, nblocks))
        out[sel] = np.random.Generator(np.random.Philox(seed=root_seed + k)).random(
            tuple(s.stop - s.start for s in sel))

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        list(pool.map(draw, np.ndindex(*nblocks)))
    return out


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its CUDA launches."""
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.kernels.region_sum import region_sum

    return {"philox_uniform": philox_uniform, "region_sum": region_sum, "fma_sum_blocks": fma_sum_blocks}


def zero_launches() -> None:
    """Every kernel's launch and path counts set to 0."""
    for w in kernel_wrappers().values():
        w.launches = 0
        for k in w.paths:
            w.paths[k] = 0


def reset_peaks() -> None:
    """Start a compute-level reading of the card's peak memory: the
    allocator's peak statistics and the memory guard's running maximum
    reset (the guard resets the statistics at every task and folds them
    into that maximum first)."""
    from cubed_tpu_torch.runtime import memory

    memory.reset_device_peaks()


def read_peaks() -> dict:
    """The card's peak allocated and reserved bytes since
    :func:`reset_peaks`, the guard's resets folded in."""
    from cubed_tpu_torch.runtime import memory

    return memory.device_peaks()


def stores_with_chunks(work_dir: str) -> set:
    """The Zarr stores under *work_dir* that hold any chunk file."""
    found = set()
    for root, _, files in os.walk(work_dir):
        if root.endswith(".zarr") and any(f != ".zarray" for f in files):
            found.add(root)
    return found


def run_main_path(torch, name: str, executor_name: str, build, expected,
                  counts_required: dict, executor=None, seed: int = SEED, spill: bool = False,
                  allowed_mem: str = "2GB", rtol: float = 1e-12, fallbacks: int = 0) -> dict:
    """Compute one configuration on one executor ("sequential" or "cuda",
    then *executor* or a new ``CudaExecutor``) under *allowed_mem*, check it
    against the oracle's *expected* value (a float, or an array compared
    element by element) within *rtol* (an *expected* of the form
    ``{"expected": value, "also": [(label, value, rtol), ...]}`` adds more
    oracles, each with its own tolerance), and the kernel launch counts (a key
    ``kernel:path`` bounds the launches of one path, ``stats: counter`` one
    of the device executor's counters); for the device executor also its
    fallback counters (*fallbacks* of ``batched_errors`` and
    ``eager_fallbacks`` where a budget below one array is asked for, else
    none) and, unless *spill* (a budget that spills arrays to
    storage, asked for), its peak memory (reserved, graph pools included)
    against its budget and that only the output reached storage."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.cuda import _GRAPHS, CudaExecutor

    work = os.path.join(WORK_DIR, f"{name}-{executor_name}-{seed}")
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=allowed_mem)
    random.seed(seed)
    result = build(spec)
    plan = result.plan._finalize(array_names=(result.name,))
    projected = plan.max_projected_mem()
    if executor is None and executor_name == "cuda":
        executor = CudaExecutor()
    wrappers = kernel_wrappers()

    torch.cuda.synchronize()
    reset_peaks()
    for w in wrappers.values():
        w.launches = 0  # just before the run: its launches alone
    paths = {k: dict(w.paths) for k, w in wrappers.items() if hasattr(w, "paths")}
    t0 = time.perf_counter()
    value = result.compute(executor=executor)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    paths = {k: {p: wrappers[k].paths[p] - n for p, n in before.items() if wrappers[k].paths[p] > n}
             for k, before in paths.items()}
    peak, peak_reserved = read_peaks()["allocated"], read_peaks()["reserved"]
    stored = stores_with_chunks(work)
    shutil.rmtree(work, ignore_errors=True)

    label = f"{name} [{executor_name}, seed {seed}]"
    also = []
    if isinstance(expected, dict):
        expected, also = expected["expected"], expected["also"]
    check(np.asarray(value).dtype == np.float64, f"{label}: result dtype {np.asarray(value).dtype}, declared float64")
    value = np.asarray(value, dtype=np.float64)
    check(value.shape == np.shape(expected), f"{label}: shape {value.shape}, expected {np.shape(expected)}")
    rel = float(np.max(np.abs(value - expected) / np.abs(expected))) if value.size else 0.0
    shown = f"value {float(value)!r}, numpy oracle {float(expected)!r}" if not value.shape else \
        f"values of shape {value.shape}, mean {float(value.mean())!r}, numpy oracle's {float(np.mean(expected))!r}"
    print(f"{label}: compute() {elapsed:.3f} s ({plan.num_tasks()} tasks, {plan.num_ops()} ops), "
          f"{shown}, max rel err {rel:.3e}; {smi_tag()}")
    print(f"{label}: max_projected_mem {projected} B, torch.cuda.max_memory_allocated {peak} B, "
          f"max_memory_reserved {peak_reserved} B, cached graphs {_GRAPHS.nbytes(torch.device('cuda', 0))} B")
    print(f"{label}: launches {json.dumps(launches)}; paths {json.dumps(paths)}")
    check(bool(np.all(np.isfinite(value))), f"{label}: value is not finite")
    check(rel <= rtol, f"{label}: value differs from the numpy oracle beyond rtol {rtol}")
    for what, other, other_rtol in also:
        other_rel = float(np.max(np.abs(value - other) / np.abs(other)))
        print(f"{label}: {what} {float(np.mean(other))!r}, rel err {other_rel:.3e} (limit {other_rtol:.3e})")
        check(other_rel <= other_rtol, f"{label}: value differs from the {what} beyond rtol {other_rtol}")
    stats = dict(sorted(executor.stats.items())) if executor is not None else {}
    for key, (lo, hi) in counts_required.items():
        kname, _, sub = key.partition(":")
        n = stats.get(sub, 0) if kname == "stats" else paths[kname].get(sub, 0) if sub else launches[kname]
        check(lo <= n <= hi, f"{label}: {key} is {n}, expected [{lo}, {hi}]")
    if executor is not None:
        budget = executor._budget(spec, torch.device("cuda"))
        print(f"{label}: executor stats {json.dumps(stats)}; residency budget {budget} B")
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
            want = fallbacks if counter in ("eager_fallbacks", "batched_errors") else 0
            check(stats.get(counter, 0) == want, f"{label}: {counter} = {stats.get(counter)}, expected {want}")
        output_store = os.path.normpath(result.zarray_maybe_lazy.store)
        if spill:
            check(len(stored) > 1, f"{label}: nothing spilled to storage under a budget of {budget} B")
        else:
            check(peak_reserved <= budget,
                  f"{label}: peak device memory (reserved) {peak_reserved} B over the budget {budget} B")
            check({os.path.normpath(p) for p in stored} == {output_store},
                  f"{label}: chunk files in {sorted(stored)}, expected the output's alone")
    return dict(launches=launches, paths=paths, stats=stats, seconds=elapsed, rel=rel, plan=plan,
                projected=projected, peak=peak, peak_reserved=peak_reserved,
                value=None if value.shape else float(value).hex())


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


def vorticity_build(spec, config=VORTICITY):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    shape, chunks = config["shape"], config["chunks"]
    a, b, x, y = [cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def vorticity_oracle(config=VORTICITY) -> float:
    shape, chunks = config["shape"], config["chunks"]
    a, b, x, y = [oracle_random(shape, chunks, random.getrandbits(30)) for _ in range(4)]
    return float(np.mean(a[1:] * x[1:] + b[1:] * y[1:]))


def elemwise_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    a, b = [cubed_tpu_torch.random.random(ELEMWISE["shape"], chunks=ELEMWISE["chunks"], spec=spec)
            for _ in range(2)]
    return xp.sum(xp.sqrt(xp.abs(xp.sin(a) * b + xp.cos(b))))


def elemwise_oracle() -> float:
    a, b = [oracle_random(ELEMWISE["shape"], ELEMWISE["chunks"], random.getrandbits(30)) for _ in range(2)]
    return float(np.sum(np.sqrt(np.abs(np.sin(a) * b + np.cos(b)))))


def reduce_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    a = cubed_tpu_torch.random.random(REDUCE["shape"], chunks=REDUCE["chunks"], spec=spec)
    return xp.max(xp.mean(a, axis=0))


def reduce_oracle() -> float:
    return float(np.max(np.mean(oracle_random(REDUCE["shape"], REDUCE["chunks"], random.getrandbits(30)), axis=0)))


def matmul_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    a, b = [cubed_tpu_torch.random.random(MATMUL["shape"], chunks=MATMUL["chunks"], spec=spec) for _ in range(2)]
    return xp.sum(xp.matmul(a, b))


def matmul_oracle() -> float:
    a, b = [oracle_random(MATMUL["shape"], MATMUL["chunks"], random.getrandbits(30)) for _ in range(2)]
    return float(np.sum(a @ b))


def rechunk_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    a = cubed_tpu_torch.random.random(VORTICITY["shape"], chunks=VORTICITY["chunks"], spec=spec)
    return xp.mean(a.rechunk(RECHUNK_TARGET), axis=0)


_RECHUNK_ORACLES: dict = {}


def rechunk_oracle() -> np.ndarray:
    """The time mean of config 5's array, per root seed (three budgets
    compute the same seeds)."""
    root = random.getrandbits(30)
    if root not in _RECHUNK_ORACLES:
        _RECHUNK_ORACLES[root] = np.mean(oracle_random(VORTICITY["shape"], VORTICITY["chunks"], root), axis=0)
    return _RECHUNK_ORACLES[root]


def rechunk_copies(plan) -> list:
    """The tasks of each copy op of a finalized plan, in order."""
    return [d["primitive_op"].num_tasks for n in plan.dag.topological_sort()
            if (d := plan.dag.nodes[n]).get("op_name") == "rechunk"]


@contextlib.contextmanager
def recorded_kernel_calls(torch):
    """While active, record the layout of every region_sum and batched
    Philox launch on the card outside a capture (shape, strides, offset,
    storage size and 16-byte alignment; region_sum's axes, Philox's block
    chunks and keys), with how often each was launched. Yields
    ``{"region_sum": {call: n}, "philox_uniform_blocks": {call: keys}}``."""
    import cubed_tpu_torch.random as crandom
    from cubed_tpu_torch.kernels import philox_uniform as mphilox
    from cubed_tpu_torch.kernels import region_sum as mregion

    calls: dict = {"region_sum": {}, "philox_uniform_blocks": {}}
    region_inner, philox_inner = mregion._region_sum, mphilox.philox_uniform_blocks

    def layout(x):
        return (tuple(x.shape), tuple(x.stride()), x.storage_offset(),
                x.untyped_storage().nbytes() // x.element_size(), x.data_ptr() % 16, x.dtype)

    def recording():
        return not torch.cuda.is_current_stream_capturing()

    def region(x, axes, keepdims):
        if x.device.type == "cuda" and recording():
            call = (layout(x), tuple(axes), keepdims)
            calls["region_sum"][call] = calls["region_sum"].get(call, 0) + 1
        return region_inner(x, axes, keepdims)

    def philox(out, chunks, keys):
        if out.device.type == "cuda" and recording():
            host = keys.cpu().numpy().view(np.uint64) if isinstance(keys, torch.Tensor) else keys
            calls["philox_uniform_blocks"].setdefault((layout(out), tuple(chunks)), np.array(host, dtype=np.uint64))
        return philox_inner(out, chunks, keys)

    mregion._region_sum = region
    mphilox.philox_uniform_blocks = crandom.philox_uniform_blocks = philox
    try:
        yield calls
    finally:
        mregion._region_sum = region_inner
        mphilox.philox_uniform_blocks = crandom.philox_uniform_blocks = philox_inner


def strided_like(torch, gen, bases: dict, lay, fill: bool = True):
    """A tensor on the card with the layout *lay* (:func:`recorded_kernel_calls`):
    the same shape, strides, offset and 16-byte alignment, in a storage of
    the same size (shared by calls of one storage size), random values."""
    shape, stride, offset, size, align, dtype = lay
    base = bases.get((size, dtype))
    if base is None:
        pad = 16 // torch.empty((), dtype=dtype).element_size()
        if not fill:
            base = torch.empty(size + pad, dtype=dtype, device="cuda")
        elif dtype.is_floating_point:
            base = torch.randn(size + pad, generator=gen, dtype=dtype, device="cuda")
        else:
            base = torch.randint(-2**40, 2**40, (size + pad,), generator=gen, dtype=dtype, device="cuda")
        bases[(size, dtype)] = base
    item = base.element_size()
    shift = next(k for k in range(16 // item) if (base.data_ptr() + k * item) % 16 == align)
    return base.as_strided(shape, stride, offset + shift)


def layouts_to_json(calls: dict) -> dict:
    """:func:`recorded_kernel_calls`'s record in JSON's types."""
    def lay(t):
        return [list(t[0]), list(t[1]), t[2], t[3], t[4], str(t[5]).removeprefix("torch.")]

    return {"region_sum": [[lay(t), list(axes), keepdims, n] for (t, axes, keepdims), n in calls["region_sum"].items()],
            "philox_uniform_blocks": [[lay(t), list(chunks), keys.tolist()]
                                      for (t, chunks), keys in calls["philox_uniform_blocks"].items()]}


def layouts_from_json(torch, record: dict) -> dict:
    def lay(v):
        return (tuple(v[0]), tuple(v[1]), v[2], v[3], v[4], getattr(torch, v[5]))

    return {"region_sum": {(lay(t), tuple(axes), keepdims): n for t, axes, keepdims, n in record["region_sum"]},
            "philox_uniform_blocks": {(lay(t), tuple(chunks)): np.array(keys, dtype=np.uint64)
                                      for t, chunks, keys in record["philox_uniform_blocks"]}}


def check_recorded_layouts(torch, runs: dict) -> None:
    """:func:`check_path_kernels` for each run's record (name -> record), in
    a process of its own (``--check-layouts FILE``): late in a busy process
    torch.profiler loses device records (PERF.md)."""
    path = os.path.join(WORK_DIR, "path_layouts.json")
    os.makedirs(WORK_DIR, exist_ok=True)
    with open(path, "w") as f:
        json.dump({name: layouts_to_json(calls) for name, calls in runs.items()}, f)
    proc = run_fresh(["--check-layouts", path])
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"--check-layouts: the run failed:\n{proc.stderr[-4000:]}")


def check_layouts_file(torch, path: str) -> None:
    with open(path) as f:
        runs = json.load(f)
    for name, record in runs.items():
        check_path_kernels(torch, name, layouts_from_json(torch, record))


def check_path_kernels(torch, name: str, calls: dict) -> None:
    """Hold each kernel of a run against its plain version at the layouts the
    run gave it (:func:`recorded_kernel_calls`): region_sum within 1e-12 of
    the sum of magnitudes (int64 exactly), the batched Philox kernel bit for
    bit, one launch per call and, under torch.profiler, one kernel per call
    and no other (once per geometry: the layouts less their offsets)."""
    from cubed_tpu_torch.kernels.philox_uniform import (philox_uniform, philox_uniform_blocks,
                                                        philox_uniform_blocks_plain)
    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bases: dict = {}
    thunks: dict = {}
    for (lay, axes, keepdims), n in calls["region_sum"].items():
        x = strided_like(torch, gen, bases, lay)
        before = region_sum.launches
        got = region_sum(x, axes, keepdims)
        launched = region_sum.launches - before
        plain = region_sum_plain(x, axes, keepdims)
        what = f"{name}: region_sum at the path's {lay[0]} strides {lay[1]} axes {axes} ({n} on the path)"
        check(launched == 1, f"{what}: {launched} launches")
        if x.dtype.is_floating_point:
            scale = region_sum_plain(x.abs(), axes, keepdims)
            check(bool(((got - plain).abs() <= 1e-12 * scale).all()), f"{what}: beyond 1e-12 of sum(|x|)")
        else:
            check(torch.equal(got, plain), f"{what}: differs from the plain version")
        geometry = (lay[0], lay[1], lay[4], axes, keepdims)
        thunks.setdefault(geometry, lambda x=x, axes=axes, keepdims=keepdims: region_sum(x, axes, keepdims))
    print(f"{name}: region_sum at the run's {len(calls['region_sum'])} layouts "
          f"({sum(calls['region_sum'].values())} launches recorded): one launch each, within 1e-12 of sum(|x|) "
          f"of the plain version")
    check(bool(thunks), f"{name}: no region_sum launch recorded")
    one_launch_per_call(torch, region_sum, "region_sum", list(thunks.values()))
    bases.clear()
    thunks = []
    for (lay, chunks), keys in calls["philox_uniform_blocks"].items():
        out = strided_like(torch, gen, bases, lay, fill=False)
        before = philox_uniform.launches
        philox_uniform_blocks(out, chunks, keys)
        launched = philox_uniform.launches - before
        plain = philox_uniform_blocks_plain(lay[0], chunks, keys, device="cuda", dtype=lay[5])
        what = f"{name}: philox_uniform_blocks at the path's {lay[0]} {lay[5]} in blocks of {chunks}"
        check(launched == 1, f"{what}: {launched} launches")
        bits = torch.int32 if lay[5] == torch.float32 else torch.int64
        check(torch.equal(out.contiguous().view(bits), plain.view(bits)), f"{what}: differs from the plain version")
        thunks.append(lambda out=out, chunks=chunks, keys=keys: philox_uniform_blocks(out, chunks, keys))
    print(f"{name}: philox_uniform_blocks at the run's {len(thunks)} layouts: one launch each, bit for bit "
          f"the plain version")
    check(bool(thunks), f"{name}: no batched Philox launch recorded")
    one_launch_per_call(torch, philox_uniform, "philox_blocks_kernel", thunks)
    bases.clear()


def run_baseline_configs(torch, layouts: dict) -> dict:
    """BASELINE configs 2-4 on both executors against numpy oracles (the
    same per-block Philox streams), then config 5's rechunk under three
    budgets: each plan's copy ops against the planner's (1 direct, 3
    multistage, 2 through the minimum intermediate), the sequential
    executor copying through Zarr. On the device executor every run is three
    computes on one CudaExecutor with distinct seeds (cold, capturing, warm),
    the segment captured on the second and replayed on the third; every
    rechunk copy op an alias and no intermediate store written. Each
    device run's region_sum and batched Philox launches are recorded, then
    held against their plain versions at the layouts the run gave them
    (:func:`check_recorded_layouts`), with those already in *layouts*.
    Returns each run's result by name."""
    out = {}
    for name, build, oracle, seq_required, dev_required, footprint in (
        ("elemwise", elemwise_build, elemwise_oracle,
         {"philox_uniform": (72, 72), "philox_uniform:batched": (0, 0), "region_sum": (71, 71)},
         {"philox_uniform": (2, 2), "philox_uniform:batched": (2, 2), "region_sum": (6, 6),
          "stats:batched_ops": (2, 2), "stats:chunked_ops": (3, 3), "stats:eager_ops": (1, 1)},
         # the pool holds b (a fuses into its consumer)
         8 * int(np.prod(ELEMWISE["shape"]))),
        ("reduce", reduce_build, reduce_oracle,
         {"philox_uniform": (64, 64), "philox_uniform:batched": (0, 0), "region_sum": (176, 176)},
         {"philox_uniform": (1, 1), "philox_uniform:batched": (1, 1), "region_sum": (49, 49),
          "stats:batched_ops": (2, 2), "stats:chunked_ops": (5, 5), "stats:eager_ops": (1, 1)},
         # the random op fuses into the mean's first step: no array in the pool
         1),
        ("matmul", matmul_build, matmul_oracle,
         {"philox_uniform": (32, 32), "philox_uniform:batched": (0, 0), "region_sum": (143, 143)},
         {"philox_uniform": (2, 2), "philox_uniform:batched": (2, 2), "region_sum": (19, 19),
          "stats:batched_ops": (4, 4), "stats:chunked_ops": (3, 3), "stats:eager_ops": (1, 1)},
         # the pool holds at least a and b
         2 * 8 * int(np.prod(MATMUL["shape"]))),
    ):
        expected = cached_oracle(name, oracle, SEED)
        shared = {"fma_sum_blocks": (0, 0)}
        seq = run_main_path(torch, name, "sequential", build, expected, dict(shared, **seq_required))
        with recorded_kernel_calls(torch) as layouts[name]:
            runs = run_device_repeats(torch, name, build, oracle, dict(
                shared, **dev_required, **{"stats:segments_traced": (1, 1), "stats:segment_mem_aborts": (0, 0)}),
                seeds=(SEED, SEED + 1, SEED + 2), footprint=footprint)
        print(f"{name}: compute() sequential {seq['seconds']:.3f} s; cuda cold {runs[0]['seconds']:.4f} s, "
              f"capturing {runs[1]['seconds']:.4f} s, warm {runs[2]['seconds']:.4f} s; "
              f"max_projected_mem {runs[0]['projected']} B, max_memory_allocated {runs[0]['peak']} B, "
              f"max_memory_reserved {runs[0]['peak_reserved']} B (first compute), "
              f"{runs[2]['peak_reserved']} B (a replay); launches {json.dumps(runs[0]['launches'])}; {smi_tag()}")
        out[name] = {"sequential": seq, "cuda": runs}

    import cubed_tpu_torch

    for mem, (n_copies, tasks) in RECHUNK_PLANS.items():
        random.seed(SEED)
        x = rechunk_build(cubed_tpu_torch.Spec(work_dir=os.path.join(WORK_DIR, "plan"), allowed_mem=mem))
        got = rechunk_copies(x.plan._finalize(array_names=(x.name,)))
        print(f"rechunk {mem}: copy ops {len(got)}, their tasks {got} (planned: {n_copies}, {tasks})")
        check(got == tasks, f"rechunk {mem}: copy ops' tasks {got}, expected {tasks}")
        name = f"rechunk-{mem}"
        random.seed(SEED)
        expected = rechunk_oracle()
        seq = run_main_path(torch, name, "sequential", rechunk_build, expected, {
            "philox_uniform": (100, 100), "philox_uniform:batched": (0, 0), "region_sum": (100, 100)},
            allowed_mem=mem)
        with recorded_kernel_calls(torch) as layouts[name]:
            runs = run_device_repeats(torch, name, rechunk_build, rechunk_oracle, {
                "philox_uniform": (1, 1), "philox_uniform:batched": (1, 1), "region_sum": (1, 1),
                "fma_sum_blocks": (0, 0), "stats:rechunk_alias": (n_copies, n_copies),
                "stats:rechunk_virtual": (0, 0), "stats:rechunk_loads": (0, 0), "stats:rechunk_copies": (0, 0),
                "stats:segments_traced": (1, 1), "stats:segment_mem_aborts": (0, 0)},
                seeds=(SEED, SEED + 1, SEED + 2), footprint=8 * int(np.prod(VORTICITY["shape"])), allowed_mem=mem)
        print(f"{name}: compute() sequential {seq['seconds']:.3f} s; cuda cold {runs[0]['seconds']:.4f} s, "
              f"capturing {runs[1]['seconds']:.4f} s, warm {runs[2]['seconds']:.4f} s; "
              f"max_projected_mem {runs[0]['projected']} B, max_memory_allocated {runs[0]['peak']} B, "
              f"max_memory_reserved {runs[0]['peak_reserved']} B (first compute), "
              f"{runs[2]['peak_reserved']} B (a replay); stats {json.dumps(runs[0]['stats'])}; {smi_tag()}")
        out[name] = {"sequential": seq, "cuda": runs}
    check_recorded_layouts(torch, layouts)
    return out


#: vorticity cut to (200, 180, 160) / 40 under a budget of two of its
#: arrays: the random ops spill, the segment fails its memory pre-check,
#: and the fused reduction reads its blocks from storage and takes fma_sum
#: block by block (the fusion rule's chunked form: fma_sum_blocks on a grid
#: of one block, once a block)
SPILL = dict(shape=(200, 180, 160), chunks=40)
SPILL_DEVICE_MEM = 2 * 200 * 180 * 160 * 8 + 1_000_000


#: (configuration, seed) -> its numpy oracle's value, each drawn once a run
ORACLES: dict = {}


def cached_oracle(name: str, oracle, seed: int):
    """*oracle*'s value for *seed* (its random arrays' root seeds drawn after
    ``random.seed(seed)``, as the build draws them), computed once a run."""
    if (name, seed) not in ORACLES:
        random.seed(seed)
        t = time.perf_counter()
        ORACLES[name, seed] = oracle()
        print(f"{name} seed {seed}: numpy oracle {time.perf_counter() - t:.1f} s")
    return ORACLES[name, seed]


def phase4_oracles() -> list:
    """Phase 4's numpy oracles, (name, oracle, seeds), as its runs ask
    :func:`cached_oracle` for them."""
    three, four = (SEED, SEED + 1, SEED + 2), (SEED, SEED + 1, SEED + 2, SEED + 3)
    return [("addsum", addsum_oracle, (SEED,)), ("vorticity", vorticity_oracle, four),
            ("vorticity-spill", functools.partial(vorticity_oracle, SPILL), (SEED,)),
            ("vorticity_f32", vorticity_f32_oracle, three),
            ("vorticity_f32-spill", functools.partial(vorticity_f32_oracle, SPILL), (SEED,)),
            ("matmul_bf16", matmul_bf16_oracle, three), ("addsum_scaled", addsum_scaled_oracle, (SEED,)),
            ("elemwise", elemwise_oracle, three), ("reduce", reduce_oracle, three),
            ("matmul", matmul_oracle, three), ("rechunk-2GB", rechunk_oracle, three)]


def run_device_repeats(torch, name: str, build, oracle, required: dict, seeds, footprint: int,
                       executor_options=None, **kw) -> list:
    """Compute one configuration on one ``CudaExecutor(**executor_options)``
    once per seed: the first compute runs its segment op by op (a first
    sighting of its structural key), the second captures it and replays it
    (``segments_compiled`` 1), the others replay it (``segment_struct_hits``
    1). Each value is held against its oracle; each compute against
    *required*, and from the second on the graph's pool against
    *footprint* bytes."""
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    ex = CudaExecutor(**(executor_options or {}))
    runs = []
    for i, seed in enumerate(seeds):
        expected = cached_oracle(name, oracle, seed)
        req = dict(required, **{"stats:segments_compiled": (1, 1) if i == 1 else (0, 0),
                                "stats:segment_struct_hits": (1, 1) if i >= 2 else (0, 0),
                                "stats:segment_hbm_footprint": (footprint, 10**12) if i else (0, 0)})
        runs.append(run_main_path(torch, name, "cuda", build, expected, req, executor=ex, seed=seed, **kw))
    secs = [r["seconds"] for r in runs]
    print(f"{name} [cuda]: compute() cold {secs[0]:.4f} s (first sighting: op by op, no capture), "
          f"{secs[1]:.4f} s (second: capture, then replay), warm {' / '.join(f'{w:.4f}' for w in secs[2:])} s "
          f"(replays); {smi_tag()}")
    return runs


# ---------------------------------------------------------------------------
# phase 4, bench.py's other workloads: vorticity_f32, matmul_bf16,
# addsum_scaled (bench.py:64-76, :117-128)
# ---------------------------------------------------------------------------

#: bench.py's addsum_scaled: sum(a + b) over 16000^2 float64 in 2000^2 chunks
ADDSUM_SCALED = dict(shape=(16000, 16000), chunks=2000)
#: a budget below one (200, 180, 160) float32 array (23,040,000 B): the random
#: ops fail the batched route's budget check and run block by block, through
#: the per-block float32 Philox entry point
F32_SPILL_DEVICE_MEM = 20_000_000
#: the smaller matmul plan each precision mode runs on: (1000, 1000) / 250
MODES_MATMUL = dict(shape=(1000, 1000), chunks=250)
#: the per-block product's modes run on the card beside matmul_bf16's
#: "bfloat16", with the tensor-core peak of each (NVIDIA H100 SXM data sheet,
#: dense) for its GEMM bound; "float32" runs outside the tensor cores
PRECISION_PEAKS = {"float32": 67e12, "tensorfloat32": 495e12, "bfloat16": 989e12, "bfloat16_3x": 989e12}
F32_EPS = float(np.finfo(np.float32).eps)


def f32_bound(k: int, nblocks: int, ops: int) -> float:
    """The reference's documented float32 error bound (JaxExecutor's
    docstring), relative, for a sum of k positive terms in nblocks chunks
    each made by *ops* elementwise ops: (ops + log2(k) + chunks) * eps."""
    return (ops + np.log2(k) + nblocks) * F32_EPS


def bf16_round(x32: np.ndarray) -> np.ndarray:
    """float32 *x32* rounded to bf16 (to nearest even), held in float32."""
    bits = np.ascontiguousarray(x32, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def tf32_round(x32: np.ndarray) -> np.ndarray:
    """float32 *x32* rounded to TF32's 10-bit mantissa (to nearest even)."""
    bits = np.ascontiguousarray(x32, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def mode_model(a64: np.ndarray, b64: np.ndarray, mode: str) -> np.ndarray:
    """The exact model of a precision mode on float64 sources narrowed to
    float32: the operands rounded as the mode says, the products summed in
    float64."""
    a, b = a64.astype(np.float32), b64.astype(np.float32)
    if mode == "tensorfloat32":
        return tf32_round(a).astype(np.float64) @ tf32_round(b).astype(np.float64)
    if mode == "bfloat16":
        return bf16_round(a).astype(np.float64) @ bf16_round(b).astype(np.float64)
    if mode == "bfloat16_3x":
        ah, bh = bf16_round(a), bf16_round(b)
        al, bl = bf16_round(a - ah).astype(np.float64), bf16_round(b - bh).astype(np.float64)
        ah, bh = ah.astype(np.float64), bh.astype(np.float64)
        return ah @ bh + ah @ bl + al @ bh
    return a.astype(np.float64) @ b.astype(np.float64)


def vorticity_f32_oracle(config=VORTICITY) -> dict:
    """vorticity under compute_dtype="float32": numpy's emulation of it (each
    block's float64 stream rounded to float32, the products and their sum in
    float32, the mean taken in float64) at rtol 1e-6; and the float64 oracle
    within the reference's float32 bound."""
    shape, chunks = config["shape"], config["chunks"]
    a, b, x, y = [oracle_random(shape, chunks, random.getrandbits(30)) for _ in range(4)]
    exact = float(np.mean(a[1:] * x[1:] + b[1:] * y[1:]))
    a, b, x, y = [t.astype(np.float32) for t in (a, b, x, y)]
    emulated = float(np.mean(a[1:] * x[1:] + b[1:] * y[1:], dtype=np.float64))
    k = int(np.prod(a[1:].shape))
    nblocks = int(np.prod([-(-n // chunks) for n in shape]))
    return {"expected": emulated,
            "also": [("float64 oracle (the reference's float32 bound)", exact, f32_bound(k, nblocks, 3))]}


def matmul_bf16_oracle() -> dict:
    """matmul_bf16: numpy's product of the bf16-rounded float32 operands (in
    float64) at rtol 1e-5; the exact float64 value at rtol 2e-2, the
    reference test's bound (tests/test_plan_fusion.py:516-533)."""
    a, b = [oracle_random(MATMUL["shape"], MATMUL["chunks"], random.getrandbits(30)) for _ in range(2)]
    exact = float(np.sum(a @ b))
    return {"expected": float(np.sum(mode_model(a, b, "bfloat16"))),
            "also": [("exact float64 value", exact, 2e-2)]}


def addsum_scaled_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    shape, chunks = ADDSUM_SCALED["shape"], ADDSUM_SCALED["chunks"]
    a = cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec)
    b = cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec)
    return xp.sum(xp.add(a, b))


def addsum_scaled_oracle() -> float:
    shape, chunks = ADDSUM_SCALED["shape"], ADDSUM_SCALED["chunks"]
    total = 0.0
    for _ in range(2):
        total += float(np.sum(oracle_random(shape, chunks, random.getrandbits(30))))
    return total


def modes_matmul_build(spec):
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    a, b = [cubed_tpu_torch.random.random(MODES_MATMUL["shape"], chunks=MODES_MATMUL["chunks"], spec=spec)
            for _ in range(2)]
    return xp.matmul(a, b)


GEMM_NAME_PIECES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def check_matmul_modes(torch) -> None:
    """Each float32 precision mode on a (1000, 1000) / 250 matmul plan on the
    card (``CudaExecutor(compute_dtype="float32", matmul_precision=mode)``),
    element by element against its exact model at rtol 1e-5, with the GEMM
    kernels torch.profiler records for it; then one (1000, 1000) product per
    mode timed beside its GEMM bound at the mode's peak."""
    import cubed_tpu_torch
    from cubed_tpu_torch import contraction
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    random.seed(SEED + 7)
    a, b = [oracle_random(MODES_MATMUL["shape"], MODES_MATMUL["chunks"], random.getrandbits(30)) for _ in range(2)]
    switches = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    for mode in PRECISION_PEAKS:
        random.seed(SEED + 7)
        spec = cubed_tpu_torch.Spec(work_dir=os.path.join(WORK_DIR, f"modes-{mode}"), allowed_mem="2GB")
        x = modes_matmul_build(spec)
        ex = CudaExecutor(compute_dtype="float32", matmul_precision=mode)
        out = {}
        kernels = kernel_launches_by_name(torch, lambda: out.setdefault("v", x.compute(executor=ex)))
        got = out["v"]
        check(got.dtype == np.float64, f"matmul {mode}: result dtype {got.dtype}")
        model = mode_model(a, b, mode)
        rel = float(np.max(np.abs(got - model) / np.abs(model)))
        exact_rel = float(np.max(np.abs(got - a @ b) / np.abs(a @ b)))
        gemms = {k: n for k, n in kernels.items() if any(piece in k for piece in GEMM_NAME_PIECES)}
        print(f"matmul_precision={mode!r} (1000,1000)/250 [cuda, compute_dtype float32]: max rel err {rel:.3e} "
              f"against the mode's model, {exact_rel:.3e} against float64; stats {json.dumps(dict(ex.stats))}")
        print(f"matmul_precision={mode!r}: GEMM kernels recorded: {json.dumps(gemms)}")
        check(rel <= 1e-5, f"matmul {mode}: beyond rtol 1e-5 of the mode's model")
        check(bool(gemms), f"matmul {mode}: no GEMM kernel recorded")
        check(ex.stats["eager_fallbacks"] == 0, f"matmul {mode}: a fallback")
        shutil.rmtree(spec.work_dir, ignore_errors=True)
    check((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == switches,
          "a process-global matmul switch changed")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    pairs = [(torch.rand((1000, 1000), generator=gen, device=dev), torch.rand((1000, 1000), generator=gen, device=dev))
             for _ in range(4)]
    for mode, peak in PRECISION_PEAKS.items():
        def product(x, y, mode=mode):
            with contraction.precision(mode):
                return contraction.matmul(x, y)

        ms = time_ms(torch, product, pairs)
        plain_ms = time_ms(torch, lambda x, y, mode=mode: contraction.matmul_plain(x, y, mode)
                           if mode in contraction.REDUCED else torch.matmul(x, y), pairs)
        passes = 3 if mode == "bfloat16_3x" else 1
        b, by = bound_ms(3 * 4e6 * 4, passes * 2e9, peak)
        print(f"per-block product (1000,1000) f32 at {mode!r}: {ms:.5f} ms ({100 * b / ms:.1f}% of its bound), "
              f"plain version {plain_ms:.5f} ms, bound {b:.5f} ms ({by}: {passes} x 2 GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s); {smi_tag()}")


def run_bench_cells(torch, layouts: dict) -> dict:
    """bench.py's three workloads the BASELINE configs leave out, at its
    sizes: vorticity_f32 (config 5's plan on ``CudaExecutor(compute_dtype=
    "float32")``: cold, capturing, warm, each against the float32-emulating
    oracle at rtol 1e-6 and the float64 oracle within the reference's float32
    bound; then cut to (200, 180, 160) / 40 under a budget below one float32
    array, where the random ops run block by block through the per-block
    float32 Philox entry point); matmul_bf16 (config 4's plan with
    ``matmul_precision="bfloat16"`` too, against numpy's product of the
    bf16-rounded operands at rtol 1e-5 and the exact value at 2e-2); and
    addsum_scaled (``sum(a + b)`` at (16000, 16000) / 2000 float64, both
    executors, rtol 1e-12). Device runs record their region_sum and batched
    Philox layouts into *layouts*."""
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    out = {}
    f32 = {"compute_dtype": "float32"}
    with recorded_kernel_calls(torch) as layouts["vorticity_f32"]:
        out["vorticity_f32"] = run_device_repeats(torch, "vorticity_f32", vorticity_build, vorticity_f32_oracle, {
            "philox_uniform": (4, 4), "philox_uniform:batched_f32": (4, 4), "philox_uniform:block": (0, 0),
            "region_sum": (1, 10**9), "region_sum:float32": (1, 10**9), "fma_sum_blocks": (1, 1),
            "fma_sum_blocks:float32": (1, 1), "stats:batched_ops": (5, 5), "stats:chunked_ops": (3, 3),
            "stats:eager_ops": (1, 1), "stats:segments_traced": (1, 1), "stats:segment_mem_aborts": (0, 0)},
            seeds=(SEED, SEED + 1, SEED + 2), footprint=4 * 4 * int(np.prod(VORTICITY["shape"])),
            executor_options=f32, rtol=1e-6)
    out["vorticity_f32-spill"] = run_main_path(
        torch, "vorticity_f32-spill", "cuda", lambda spec: vorticity_build(spec, SPILL),
        cached_oracle("vorticity_f32-spill", functools.partial(vorticity_f32_oracle, SPILL), SEED), {
            "philox_uniform:block_f32": (400, 400), "philox_uniform:batched": (0, 0),
            "fma_sum_blocks": (100, 100), "fma_sum_blocks:float32": (100, 100),
            "stats:segment_mem_aborts": (1, 1), "stats:segments_traced": (0, 0)},
        executor=CudaExecutor(device_mem=F32_SPILL_DEVICE_MEM, **f32), spill=True, rtol=1e-6, fallbacks=4)
    with recorded_kernel_calls(torch) as layouts["matmul_bf16"]:
        out["matmul_bf16"] = run_device_repeats(torch, "matmul_bf16", matmul_build, matmul_bf16_oracle, {
            "philox_uniform": (2, 2), "philox_uniform:batched_f32": (2, 2), "region_sum": (1, 10**9),
            "region_sum:float32": (1, 10**9), "fma_sum_blocks": (0, 0), "stats:batched_ops": (4, 4),
            "stats:chunked_ops": (3, 3), "stats:eager_ops": (1, 1), "stats:segments_traced": (1, 1),
            "stats:segment_mem_aborts": (0, 0)},
            seeds=(SEED, SEED + 1, SEED + 2), footprint=2 * 4 * int(np.prod(MATMUL["shape"])),
            executor_options=dict(f32, matmul_precision="bfloat16"), rtol=1e-5)
    expected = cached_oracle("addsum_scaled", addsum_scaled_oracle, SEED)
    seq = run_main_path(torch, "addsum_scaled", "sequential", addsum_scaled_build, expected, {
        "philox_uniform": (128, 128), "philox_uniform:batched": (0, 0), "region_sum": (64, 10**9),
        "fma_sum_blocks": (0, 0)})
    with recorded_kernel_calls(torch) as layouts["addsum_scaled"]:
        dev = run_main_path(torch, "addsum_scaled", "cuda", addsum_scaled_build, expected, {
            "philox_uniform": (2, 2), "philox_uniform:batched": (2, 2), "region_sum": (2, 10**9),
            "fma_sum_blocks": (0, 0), "stats:batched_ops": (1, 1), "stats:eager_ops": (1, 1),
            "stats:segments_traced": (1, 1), "stats:segment_mem_aborts": (0, 0)})
    out["addsum_scaled"] = {"sequential": seq, "cuda": dev}
    for name in ("vorticity_f32", "matmul_bf16"):
        secs = [r["seconds"] for r in out[name]]
        print(f"{name} [cuda]: compute() cold {secs[0]:.4f} s, capturing {secs[1]:.4f} s, warm {secs[2]:.4f} s; "
              f"launches {json.dumps(out[name][0]['launches'])}, paths {json.dumps(out[name][0]['paths'])}; "
              f"max_memory_reserved {out[name][0]['peak_reserved']} B; {smi_tag()}")
    print(f"addsum_scaled: compute() sequential {seq['seconds']:.3f} s, cuda {dev['seconds']:.4f} s (cold); "
          f"device launches {json.dumps(dev['launches'])}; max_memory_reserved {dev['peak_reserved']} B; "
          f"{smi_tag()}")
    return out



# ---------------------------------------------------------------------------
# the observability phase: the compute lifecycle, traces and the device
# profiler on the main path
# ---------------------------------------------------------------------------

#: vorticity's observed device computes: cold, capturing, two warm (phase 4's
#: seeds, so its oracles and its unobserved counters are theirs)
OBSERVED_SEEDS = (SEED, SEED + 1, SEED + 2, SEED + 3)
#: warm computes a way (the executor alone, unobserved, a TraceCollector,
#: all four observers), taken in turns, for the lifecycle's and the
#: observers' cost
COST_ROUNDS = 5
#: Plan.execute runs on an executor that only fires the device executor's
#: events, and the same events fired without the lifecycle, a way
LIFECYCLE_REPS = 200
#: phase 4's executor counters that an observed compute must repeat (the
#: graph pool's bytes depend on the process's allocator history)
NOT_COMPARED = ("segment_hbm_footprint",)


def observers(torch, out_dir: str, i: int) -> dict:
    """The four observers of one compute, writing under *out_dir*."""
    from cubed_tpu_torch.observability import (
        DeviceMemoryCallback, TorchProfilerCallback, TraceCollector, TracingCallback,
    )

    return dict(profiler=TorchProfilerCallback(log_dir=os.path.join(out_dir, "profile")),
                collector=TraceCollector(trace_dir=os.path.join(out_dir, "merged")),
                tracing=TracingCallback(trace_path=os.path.join(out_dir, f"tracing-{i}.json")),
                memory=DeviceMemoryCallback())


def observe_device_run(torch) -> int:
    """``--observe-device-run``: vorticity on a new ``CudaExecutor`` in a
    process of its own (so its plan shape is cold there), four computes
    (cold, capturing, two warm) with a ``TraceCollector``, a
    ``TracingCallback``, a ``DeviceMemoryCallback`` and a
    ``TorchProfilerCallback`` attached, and an uncounted sentinel kernel
    first in each profiler session (the profiler can drop a session's first
    kernel record); then warm computes in turns four ways: the plan finalized
    and run on the executor directly, as ``compute()`` did before it ran the
    lifecycle (the lifecycle's cost to every user is the difference to the
    next way), ``compute()`` unobserved, with a TraceCollector, and with all
    four observers. Prints what the parent checks as one JSON line."""
    import cubed_tpu_torch
    from cubed_tpu_torch.observability import TraceCollector
    from cubed_tpu_torch.observability.dispatchprofile import profile_for
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.types import Callback

    class Sentinel(Callback):
        def on_compute_start(self, event):
            torch.cuda._sleep(SENTINEL_CYCLES)

    out_dir = os.path.join(WORK_DIR, f"observed-{os.getpid()}")
    wrappers = kernel_wrappers()
    ex = CudaExecutor()
    dev = torch.device("cuda", torch.cuda.current_device())
    computes = []
    for i, seed in enumerate(OBSERVED_SEEDS):
        # the capturing compute (the second) also with the dispatch
        # profiler armed: where its host time goes
        spec = cubed_tpu_torch.Spec(work_dir=os.path.join(out_dir, f"work-{i}"), allowed_mem="2GB",
                                    dispatch_profile=True if i == 1 else None)
        random.seed(seed)
        x = vorticity_build(spec)
        plan = x.plan._finalize(array_names=(x.name,))
        obs = observers(torch, out_dir, i)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        value = float(x.compute(executor=ex, callbacks=[obs["profiler"], Sentinel(), obs["collector"],
                                                        obs["tracing"], obs["memory"]]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        kernels = [e["name"] for e in json.load(open(obs["profiler"].trace_path))["traceEvents"]
                   if e.get("cat") == "kernel"]
        merged = json.load(open(obs["collector"].trace_path))["traceEvents"]
        tracing = json.load(open(obs["tracing"].trace_path))["traceEvents"]
        es = obs["collector"].executor_stats
        prof = profile_for(obs["collector"].compute_id)
        computes.append(dict(
            seed=seed, value=value, seconds=seconds, stats=dict(ex.stats),
            launches={k: w.launches for k, w in wrappers.items()},
            recorded={k: sum(record in n for n in kernels) for k, record in KERNEL_RECORDS.items()},
            sentinels=sum(SENTINEL_KERNEL in n for n in kernels),
            end_stats={k: v for k, v in es.items() if k != "per_op" and not isinstance(v, dict)},
            per_op=sorted(es.get("per_op", {})), tasks=plan.num_tasks(), ops=plan.num_ops(),
            operation_spans=sum(e.get("cat") == "operation" for e in merged),
            merged_lanes=sorted({e["args"]["name"] for e in merged if e.get("ph") == "M"}),
            tracing_tasks=sum(e["args"]["num_tasks"] for e in tracing if e.get("cat") == "task"),
            memory_peaks=[m["peak_bytes_in_use"] for m in obs["memory"].samples], budget=ex._budget(spec, dev),
            trace_bytes=os.path.getsize(obs["profiler"].trace_path),
            profile=prof.summary() if prof is not None else None))
        shutil.rmtree(spec.work_dir, ignore_errors=True)
    def bare(x) -> float:
        dag = x.plan._finalize(array_names=(x.name,)).dag
        ex.execute_dag(dag, array_names=(x.name,), spec=x.spec)
        return float(x._read_stored())

    ways = {"no lifecycle": None, "unobserved": lambda r: None,
            "TraceCollector": lambda r: [TraceCollector(trace_dir=os.path.join(out_dir, "merged"))],
            "all four observers": lambda r: list(observers(torch, out_dir, 100 + r).values())}
    cost: dict = {way: [] for way in ways}
    for r in range(COST_ROUNDS):
        for j, (way, make) in enumerate(ways.items()):
            spec = cubed_tpu_torch.Spec(work_dir=os.path.join(out_dir, f"cost-{r}-{j}"), allowed_mem="2GB")
            random.seed(SEED + 100 + len(ways) * r + j)
            x = vorticity_build(spec)
            callbacks = make(r) if make is not None else None
            torch.cuda.synchronize()
            t = time.perf_counter()
            value = bare(x) if make is None else float(x.compute(executor=ex, callbacks=callbacks))
            torch.cuda.synchronize()
            cost[way].append(time.perf_counter() - t)
            check(np.isfinite(value) and ex.stats["segment_struct_hits"] == 1,
                  f"cost, {way}: value {value}, stats {dict(ex.stats)}")
            shutil.rmtree(spec.work_dir, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps(dict(computes=computes, cost=cost, lifecycle=lifecycle_seconds(x))))
    return 0


def lifecycle_seconds(x) -> dict:
    """The lifecycle's own host time on *x*'s plan, apart from the card's
    and the executor's: ``Plan.execute`` on an executor that fires the
    device executor's events for each op (one task event of its task
    count) and runs nothing, against finalizing the plan and firing the same
    events with no callback, in turns, LIFECYCLE_REPS times each; seconds
    of each run."""
    from cubed_tpu_torch.runtime.pipeline import visit_nodes
    from cubed_tpu_torch.runtime.types import (
        DagExecutor, OperationEndEvent, OperationStartEvent, TaskEndEvent, callbacks_on,
    )
    from cubed_tpu_torch.runtime.utils import fire_task_start

    class EventsOnly(DagExecutor):
        def execute_dag(self, dag, callbacks=None, **kwargs):
            for name, node in visit_nodes(dag):
                n = node["primitive_op"].num_tasks
                callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, n))
                fire_task_start(callbacks, name, num_tasks=n)
                t = time.time()
                callbacks_on(callbacks, "on_task_end", TaskEndEvent(
                    array_name=name, num_tasks=n, task_create_tstamp=t, function_start_tstamp=t,
                    function_end_tstamp=t, task_result_tstamp=t, executor="events-only"))
                callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, n))

    names = (x.name,)
    runs: dict = {"bare": [], "lifecycle": []}
    for _ in range(LIFECYCLE_REPS):
        t = time.perf_counter()
        EventsOnly().execute_dag(x.plan._finalize(array_names=names).dag, array_names=names)
        runs["bare"].append(time.perf_counter() - t)
        t = time.perf_counter()
        x.plan.execute(executor=EventsOnly(), array_names=names)
        runs["lifecycle"].append(time.perf_counter() - t)
    return runs


def check_observed_device_run(torch, unobserved: list) -> dict:
    """Run :func:`observe_device_run` in a fresh process and hold each of its
    computes against phase 4's unobserved run of the same seed (*unobserved*:
    its counters and launches), the numpy oracle (rtol 1e-12) and the
    plan."""
    proc = run_fresh(["--observe-device-run"])
    check(proc.returncode == 0, f"observability [cuda]: the observed run failed:\n{proc.stderr[-4000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    for i, (c, plain) in enumerate(zip(r["computes"], unobserved)):
        label = f"observability [cuda, {('cold', 'capturing', 'warm', 'warm')[i]}, seed {c['seed']}]"
        expected = ORACLES["vorticity", c["seed"]]
        rel = abs(c["value"] - expected) / abs(expected)
        stats = {k: v for k, v in c["stats"].items() if k not in NOT_COMPARED}
        want = {k: v for k, v in plain["stats"].items() if k not in NOT_COMPARED}
        es = c["end_stats"]
        peaks = c["memory_peaks"]
        peak = max(peaks) if peaks and None not in peaks else None
        print(f"{label}: compute() {c['seconds']:.4f} s, value {c['value']!r}, numpy oracle {expected!r}, "
              f"rel err {rel:.3e}; executor stats {json.dumps(c['stats'])}; launches {json.dumps(c['launches'])}, "
              f"profiler records {json.dumps(c['recorded'])} (+{c['sentinels']} sentinel); {smi_tag()}")
        print(f"{label}: executor_stats tasks_completed {es.get('tasks_completed')} (plan {c['tasks']}), "
              f"bytes_written {es.get('bytes_written')}, chunks_written {es.get('chunks_written')}, per_op "
              f"{len(c['per_op'])} ops (plan {c['ops']}); merged trace: {c['operation_spans']} operation spans, "
              f"lanes {c['merged_lanes']}; TracingCallback tasks {c['tracing_tasks']}; device memory peak "
              f"{peak} B over {len(peaks)} samples, budget {c['budget']} B; profiler trace "
              f"{c['trace_bytes']} B")
        check(rel <= 1e-12, f"{label}: value differs from the numpy oracle beyond rtol 1e-12")
        check(stats == want, f"{label}: executor stats {stats}, unobserved {want}")
        check(c["launches"] == plain["launches"], f"{label}: launches {c['launches']}, unobserved {plain['launches']}")
        check(c["recorded"] == c["launches"], f"{label}: the profiler recorded {c['recorded']}, "
              f"the wrappers counted {c['launches']}")
        check(all(es.get(k) == v for k, v in want.items()),
              f"{label}: ComputeEndEvent.executor_stats lacks the executor's counters: {es}")
        check(es.get("tasks_completed") == c["tasks"] == c["tracing_tasks"] == 921,
              f"{label}: tasks_completed {es.get('tasks_completed')}, plan {c['tasks']}, traced {c['tracing_tasks']}")
        check(es.get("bytes_written") == 8 and es.get("chunks_written") == 1,
              f"{label}: bytes_written {es.get('bytes_written')}, chunks_written {es.get('chunks_written')}: "
              f"the output's flush is one 8-byte chunk")
        check(len(c["per_op"]) == c["ops"] == c["operation_spans"],
              f"{label}: per_op {len(c['per_op'])}, plan ops {c['ops']}, operation spans {c['operation_spans']}")
        check(len(peaks) == c["ops"] and peak is not None and peak <= c["budget"],
              f"{label}: device memory peaks {peaks} B, budget {c['budget']} B")
    # the capturing compute, profiled: where its host time went when it
    # read several times the warm computes' (PERF.md, open questions)
    capturing, warm = r["computes"][1], float(np.median([c["seconds"] for c in r["computes"][2:]]))
    prof = capturing["profile"] or {}
    print(f"observability [cuda, capturing]: {capturing['seconds']:.4f} s, {capturing['seconds'] / warm:.2f}x the "
          f"warm computes' median {warm:.4f} s; dispatch profiler {prof.get('samples')} samples at {prof.get('hz')} "
          f"Hz over {prof.get('duration_s')} s, top stacks:")
    for st in prof.get("top_stacks") or []:
        print(f"  {st['fraction']:.1%} {st['count']} {st['stack'][-600:]}")
    check(prof.get("samples", 0) > 0, "observability [cuda, capturing]: the dispatch profiler took no sample")
    print(f"observability [cuda]: warm compute() over {COST_ROUNDS} rounds in turns, median s: " + "; ".join(
        f"{way} {float(np.median(t)):.4f} ({' / '.join(f'{x:.4f}' for x in t)})" for way, t in r["cost"].items())
        + f"; {smi_tag()}")
    bare, life = (np.asarray(r["lifecycle"][k]) * 1e3 for k in ("bare", "lifecycle"))
    print(f"observability [host]: the lifecycle on vorticity's plan ({LIFECYCLE_REPS} runs in turns, an executor "
          f"firing the device executor's events and running nothing): Plan.execute median {np.median(life):.4f} ms "
          f"(quartiles {np.percentile(life, 25):.4f} / {np.percentile(life, 75):.4f}), finalize and the events "
          f"alone {np.median(bare):.4f} ms ({np.percentile(bare, 25):.4f} / {np.percentile(bare, 75):.4f}): the "
          f"lifecycle's own cost {np.median(life) - np.median(bare):.4f} ms a compute; {smi_tag()}")
    return r


def plan_chunk_writes(plan) -> tuple[int, int, int]:
    """(chunks, bytes, tasks) the sequential executor's blockwise tasks
    write, worked out from the plan: one chunk per output per task, each
    stored padded to its store's full chunk shape."""
    from cubed_tpu_torch.core.plan import iter_op_nodes
    from cubed_tpu_torch.primitive.blockwise import apply_blockwise

    chunks = nbytes = tasks = 0
    for _, d in iter_op_nodes(plan.dag):
        op = d["primitive_op"]
        if op.pipeline.function is not apply_blockwise:
            continue
        tasks += op.num_tasks
        for w in op.pipeline.config.writes:
            chunks += op.num_tasks
            nbytes += op.num_tasks * int(np.prod(w.array.chunks)) * np.dtype(w.array.dtype).itemsize
    return chunks, nbytes, tasks


def run_sequential_observed(torch, unobserved_seconds: float, config) -> dict:
    """Vorticity on the sequential executor with a TraceCollector, at the
    threads phase's cut (*config*): one task span per task, storage
    sub-spans, and the bytes and chunks written worked out from the plan;
    its wall clock beside the threads phase's unobserved sequential run of
    the same plan. Returns its value (``float.hex``) and ``analyze()``'s
    bucket split, which the analytics phase holds its threaded run to."""
    import cubed_tpu_torch
    from cubed_tpu_torch.observability import TraceCollector

    class TimedCollector(TraceCollector):
        """A TraceCollector that sums the host time of its own callbacks."""

        seconds = 0.0

        def on_task_end(self, event):
            t = time.perf_counter()
            super().on_task_end(event)
            self.seconds += time.perf_counter() - t

        def on_compute_end(self, event):
            t = time.perf_counter()
            super().on_compute_end(event)  # the merged trace's export
            self.seconds += time.perf_counter() - t

    work = os.path.join(WORK_DIR, "vorticity-sequential-observed")
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB")
    random.seed(SEED)
    x = vorticity_build(spec, config)
    plan = x.plan._finalize(array_names=(x.name,))
    col = TimedCollector(trace_dir=os.path.join(work, "trace"))
    t = time.perf_counter()
    value = float(x.compute(callbacks=[col]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    t = time.perf_counter()
    merged = json.load(open(col.trace_path))["traceEvents"]
    load_s = time.perf_counter() - t
    shutil.rmtree(work, ignore_errors=True)
    label = "observability [sequential]"
    es = col.executor_stats
    spans = {name: sum(e["name"] == name for e in merged if e.get("cat") != "task")
             for name in ("storage_read", "storage_write", "kernel_apply")}
    task_spans = sum(e.get("cat") == "task" for e in merged)
    chunks, nbytes, kernel_tasks = plan_chunk_writes(plan)
    expected = cached_oracle(f"vorticity {config['shape']}", lambda: vorticity_oracle(config), SEED)
    rel = abs(value - expected) / abs(expected)
    print(f"{label} {config['shape']} / {config['chunks']}: compute() {seconds:.3f} s with a TraceCollector, "
          f"unobserved (the threads phase's first sequential run) "
          f"{unobserved_seconds:.3f} s ({100 * (seconds / unobserved_seconds - 1):+.2f}%), the collector's "
          f"callbacks {col.seconds:.3f} s ({100 * col.seconds / seconds:.2f}% of the run); value {value!r}, "
          f"rel err {rel:.3e}; {task_spans} task spans (plan {plan.num_tasks()}), sub-spans {json.dumps(spans)}, "
          f"spans_dropped {es.get('spans_dropped', 0)}; bytes_written {es['bytes_written']} (plan {nbytes}), "
          f"chunks_written {es['chunks_written']} (plan {chunks}), bytes_read {es['bytes_read']}, chunks_read "
          f"{es['chunks_read']}; merged trace {len(merged)} events, loaded in {load_s:.2f} s; {smi_tag()}")
    check(rel <= 1e-12, f"{label}: value differs from the numpy oracle beyond rtol 1e-12")
    check(task_spans == plan.num_tasks() == es["tasks_completed"],
          f"{label}: {task_spans} task spans, {es['tasks_completed']} tasks completed, plan {plan.num_tasks()}")
    check((es["bytes_written"], es["chunks_written"]) == (nbytes, chunks),
          f"{label}: wrote {es['bytes_written']} B in {es['chunks_written']} chunks, plan {nbytes} B in {chunks}")
    check(spans["storage_read"] > 0 and spans["storage_write"] > 0, f"{label}: no storage sub-spans: {spans}")
    check(sum(spans.values()) + es.get("spans_dropped", 0) == es["chunks_read"] + es["chunks_written"] + kernel_tasks,
          f"{label}: sub-spans {spans} and {es.get('spans_dropped', 0)} dropped, not one per chunk read, chunk "
          f"written and blockwise task")
    return dict(value=value.hex(), split=bucket_split(col, label, seconds))


# ---------------------------------------------------------------------------
# the Array API phase: the standard's surface at the reference's published
# memory scale, the per-task memory bound on the card, resident reads
# ---------------------------------------------------------------------------

#: BASELINE.md's memory-bound scale is 10000 x 10000 float64 in 5000 x 5000
#: (200 MB) chunks under allowed_mem 2GB; cut to 5000 x 5000 in 2500 x 2500
#: (50 MB) chunks: there the memory test's flatten needs a rechunk of 2.4 GB,
#: refused at plan time by both packages, and the phase's 22 ops x 4
#: computes would take more than its 90 s. ``--array-api-phase full`` runs
#: the phase alone at the published scale, where the flatten must be
#: refused at plan time
ARRAY_API = dict(shape=(5000, 5000), chunks=2500, allowed_mem="2GB")
ARRAY_API_FULL = dict(shape=(10000, 10000), chunks=5000, allowed_mem="2GB", refused=("reshape",))


def _array_api_ops(shape) -> dict:
    """name -> (build(xp, a, b), numpy oracle(a, b), comparison, a resident
    read whose copies between host and card must be none). A comparison is
    "exact", ("rtol", r), ("scan", axis) (atol n * eps * max|value| along an
    axis of length n) or ("rows", k, rtol) (rows 0..k-1 and the last k of a
    product, each against numpy's)."""
    cols = np.arange(shape[1] - 1, -1, -7)  # an integer-array selection: every seventh column, last first
    return {
        "add": (lambda xp, a, b: xp.add(a, b), lambda a, b: a + b, "exact", False),
        "multiply": (lambda xp, a, b: xp.multiply(a, b), lambda a, b: a * b, "exact", False),
        "negative": (lambda xp, a, b: xp.negative(a), lambda a, b: -a, "exact", False),
        "astype": (lambda xp, a, b: xp.astype(a, np.float32), lambda a, b: a.astype(np.float32), "exact", False),
        "sum": (lambda xp, a, b: xp.sum(a, axis=0), lambda a, b: a.sum(axis=0), ("rtol", 1e-12), False),
        "mean": (lambda xp, a, b: xp.mean(a, axis=0), lambda a, b: a.mean(axis=0), ("rtol", 1e-12), False),
        "max": (lambda xp, a, b: xp.max(a, axis=1), lambda a, b: a.max(axis=1), "exact", False),
        "matmul": (lambda xp, a, b: xp.matmul(a, b), None, ("rows", 4, 1e-12), False),
        "transpose": (lambda xp, a, b: xp.permute_dims(a, (1, 0)), lambda a, b: a.T, "exact", False),
        "index_slice": (lambda xp, a, b: a[1:, :], lambda a, b: a[1:, :], "exact", False),
        "concat": (lambda xp, a, b: xp.concat([a, b], axis=0), lambda a, b: np.concatenate([a, b]), "exact", True),
        "stack": (lambda xp, a, b: xp.stack([a, b], axis=0), lambda a, b: np.stack([a, b]), "exact", False),
        "reshape": (lambda xp, a, b: xp.reshape(a, (a.shape[0] * a.shape[1],)), lambda a, b: a.reshape(-1),
                    "exact", False),
        "flip": (lambda xp, a, b: xp.flip(a, axis=0), lambda a, b: np.flip(a, 0), "exact", True),
        "roll": (lambda xp, a, b: xp.roll(a, 1234, axis=1), lambda a, b: np.roll(a, 1234, 1), "exact", True),
        "var": (lambda xp, a, b: xp.var(a, axis=0), lambda a, b: a.var(axis=0), ("rtol", 1e-12), False),
        "cumulative_sum": (lambda xp, a, b: xp.cumulative_sum(a, axis=1), lambda a, b: np.cumsum(a, 1),
                           ("scan", 1), False),
        "argmax": (lambda xp, a, b: xp.argmax(a, axis=0), lambda a, b: a.argmax(axis=0), "exact", False),
        "where": (lambda xp, a, b: xp.where(xp.greater(a, 0.5), a, b), lambda a, b: np.where(a > 0.5, a, b),
                  "exact", False),
        "index_array": (lambda xp, a, b: a[:, cols], lambda a, b: a[:, cols], "exact", True),
        "std": (lambda xp, a, b: xp.std(a, axis=1, correction=1), lambda a, b: a.std(axis=1, ddof=1),
                ("rtol", 1e-12), False),
        "count_nonzero": (lambda xp, a, b: xp.count_nonzero(xp.greater(a, 0.5), axis=0),
                          lambda a, b: np.count_nonzero(a > 0.5, axis=0), "exact", False),
    }


def array_api_inputs(spec, config=ARRAY_API):
    """The phase's two inputs, from ``cubed_tpu_torch.random.random`` (the
    Philox kernels on the card) with root seeds drawn after
    ``random.seed(SEED)``."""
    import cubed_tpu_torch

    random.seed(SEED)
    return [cubed_tpu_torch.random.random(config["shape"], chunks=config["chunks"], spec=spec) for _ in range(2)]


def array_api_oracle_inputs(config=ARRAY_API):
    """numpy's draws of the same Philox blocks as :func:`array_api_inputs`
    (``random.random`` draws its root seed with ``random.getrandbits(30)``)."""
    random.seed(SEED)
    return [oracle_random(config["shape"], config["chunks"], random.getrandbits(30)) for _ in range(2)]


class TaskPeaks:
    """A callback holding each task's memory-guard readings, read by the
    library's guard (which the compute arms with the spec's
    ``allowed_mem``), the largest of each kept: the device peak (the
    allocator's peak over the task's start, ``memory.last_readings``), §2's
    gate; and ``TaskEndEvent.guard_mem_peak``, the larger of that and the
    task's RSS growth, which also counts what the process loads the first
    time it uses a library kernel (corrcoef's elementwise task grew the RSS
    past its 25 MB bound while its device peak stayed under: PERF.md §6).
    It resets nothing: the guard owns the allocator's peak statistics
    (``runtime/memory.py``)."""

    def __init__(self, torch):
        self.torch = torch
        self.worst = self.worst_guard = 0
        self.worst_op = self.worst_guard_op = None
        self.tasks = 0

    def on_task_end(self, event):
        from cubed_tpu_torch.runtime import memory

        device = memory.last_readings()["device"]
        check(event.guard_mem_peak is not None and device is not None,
              f"{event.array_name}: a task without the guard's device reading")
        if device > self.worst:
            self.worst, self.worst_op = device, event.array_name
        if event.guard_mem_peak > self.worst_guard:
            self.worst_guard, self.worst_guard_op = event.guard_mem_peak, event.array_name
        self.tasks += 1

    def guard_note(self) -> str:
        return f"largest guard_mem_peak {self.worst_guard} B ({self.worst_guard_op})"


def compare_to_oracle(label: str, value, expected, how) -> float:
    """Hold *value* against its numpy oracle; returns the largest
    difference relative to the oracle (0 for an exact comparison)."""
    value = np.asarray(value)
    if how == "exact":
        check(value.dtype == expected.dtype and value.shape == expected.shape,
              f"{label}: {value.dtype}{value.shape}, numpy's oracle {expected.dtype}{expected.shape}")
        check(np.array_equal(value, expected), f"{label}: not equal to the numpy oracle")
        return 0.0
    kind = how[0]
    check(value.dtype == expected.dtype and value.shape == expected.shape,
          f"{label}: {value.dtype}{value.shape}, numpy's oracle {expected.dtype}{expected.shape}")
    if kind == "scan":
        n = value.shape[how[1]]
        atol = n * np.finfo(value.dtype).eps * float(np.max(np.abs(expected)))
        err = float(np.max(np.abs(value - expected)))
        check(err <= atol, f"{label}: scan differs from the numpy oracle by {err} > atol {atol}")
        return err / float(np.max(np.abs(expected)))
    rel = float(np.max(np.abs(value - expected) / np.abs(expected)))
    check(rel <= how[-1], f"{label}: differs from the numpy oracle by rtol {rel} > {how[-1]}")
    return rel


#: pieces of the names of the kernels whose device time a profiled compute
#: of the order-statistics phase reports: the sort kernels, and the
#: partner gather of a network round (``torch.index_select``, the device
#: executor's permuted leaves)
TIMED_KERNELS = ("merge_split_kernel", "sort_tiles_kernel", "sort_merge_kernel", "indexSelect")


def host_device_copies(torch, fn) -> dict:
    """H2D and D2H copies of at least 64 KiB made while *fn* runs, from
    torch.profiler's trace (each copy's bytes): data crossing between host
    and card, not Philox keys or scalars. Also the device time (microseconds)
    and records of the TIMED_KERNELS, and of every kernel ("all")."""
    _, events = profiled_session(torch, fn, cpu=True)
    out = {"HtoD": 0, "DtoH": 0, "HtoD_small": 0, "DtoH_small": 0, "unsized": 0}
    timed: dict = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "kernel" and SENTINEL_KERNEL not in name:
            for short in [k for k in TIMED_KERNELS if k in name] + ["all"]:
                t = timed.setdefault(short, [0.0, 0])
                t[0] += float(e.get("dur", 0.0))
                t[1] += 1
        kind = "HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name else None
        if e.get("ph") != "X" or kind is None or "Memcpy" not in name:
            continue
        nbytes = (e.get("args") or {}).get("bytes")
        if nbytes is None:
            out["unsized"] += 1
        elif int(nbytes) >= 64 * 1024:
            out[kind] += 1
        else:
            out[kind + "_small"] += 1
    if timed:
        out["kernels_us"] = timed
    return out


def run_array_api_phase(torch, config=ARRAY_API) -> dict:
    """The Array API phase (see the module docstring). Returns each op's
    numbers, printed as they come."""
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    ops = _array_api_ops(config["shape"])
    t0 = time.perf_counter()
    an, bn = array_api_oracle_inputs(config)
    print(f"array API phase: {config['shape']} float64 in {config['chunks']}-chunks, allowed_mem "
          f"{config['allowed_mem']}; numpy oracle inputs {time.perf_counter() - t0:.1f} s; {smi_tag()}")
    wrappers = kernel_wrappers()
    results = {}
    for name, (build, oracle, how, resident_read) in ops.items():
        if name in config.get("refused", ()):
            # the plan-time memory bound at work, in both packages
            spec = cubed_tpu_torch.Spec(work_dir=WORK_DIR, allowed_mem=config["allowed_mem"], reserved_mem=0)
            try:
                build(xp, *array_api_inputs(spec, config))
            except ValueError as e:
                print(f"{name}: refused at plan time under allowed_mem {config['allowed_mem']}: {e}")
                continue
            raise PhaseFailed(f"{name}: built under allowed_mem {config['allowed_mem']}; expected a refusal")
        if isinstance(how, tuple) and how[0] == "rows":
            k = how[1]
            rows = np.r_[0:k, an.shape[0] - k:an.shape[0]]
            expected = an[rows] @ bn
        else:
            expected = oracle(an, bn)
        # the sequential executor under allowed_mem = the plan's projected
        # memory, reserved_mem 0 (tests/test_mem_utilization.py's run_tight)
        work = os.path.join(WORK_DIR, f"array-api-{name}")
        probe = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"], reserved_mem=0)
        projected = build(xp, *array_api_inputs(probe, config)).plan.max_projected_mem()
        tight = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=projected, reserved_mem=0)
        arr = build(xp, *array_api_inputs(tight, config))
        peaks = TaskPeaks(torch)
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        value = arr.compute(callbacks=[peaks])
        seq_s = time.perf_counter() - t
        seq_launches = {k: w.launches for k, w in wrappers.items()}
        if isinstance(how, tuple) and how[0] == "rows":
            value = np.asarray(value)[rows]
        err = compare_to_oracle(f"{name} [sequential]", value, expected, how)
        ratio = peaks.worst / projected
        print(f"{name} [sequential]: compute() {seq_s:.3f} s, {peaks.tasks} tasks; largest task device peak "
              f"{peaks.worst} B ({peaks.worst_op}) / projected {projected} B = {ratio:.4f} ({peaks.guard_note()}); "
              f"launches {json.dumps(seq_launches)}; "
              f"max rel err {err:.3e}; {smi_tag()}")
        check(ratio <= 1.0, f"{name}: a task's device peak {peaks.worst} B is over its projected {projected} B")
        shutil.rmtree(work, ignore_errors=True)

        # the device executor: cold, then warm (a second compute captures
        # the segments and replays them), then a profiled warm compute
        spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"])
        arr = build(xp, *array_api_inputs(spec, config))
        ex = CudaExecutor()
        times, launches, stats = [], [], []
        for _ in range(2):
            for w in wrappers.values():
                w.launches = 0
            t = time.perf_counter()
            value = arr.compute(executor=ex)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches.append({k: w.launches for k, w in wrappers.items()})
            stats.append(dict(sorted(ex.stats.items())))
            if isinstance(how, tuple) and how[0] == "rows":
                value = np.asarray(value)[rows]
            compare_to_oracle(f"{name} [cuda]", value, expected, how)
            for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
                check(ex.stats.get(counter, 0) == 0, f"{name} [cuda]: {counter} = {ex.stats.get(counter)}")
        copies = host_device_copies(torch, lambda: arr.compute(executor=ex))
        out_chunks = int(np.prod(arr.numblocks)) if arr.shape else 1
        out_chunk_bytes = arr.chunkmem
        # the output's own write crosses to the host, chunk by chunk
        crossing = copies["HtoD"] + max(0, copies["DtoH"] - (out_chunks if out_chunk_bytes >= 64 * 1024 else 0))
        print(f"{name} [cuda]: compute() cold {times[0]:.3f} s, warm {times[1]:.3f} s; stats cold "
              f"{json.dumps(stats[0])}; warm {json.dumps(stats[1])}; launches cold {json.dumps(launches[0])}, "
              f"warm {json.dumps(launches[1])}; host<->card copies of a profiled warm compute "
              f"{json.dumps(copies)} (the output's write: {out_chunks} chunks), beyond it {crossing}; {smi_tag()}")
        check(copies["unsized"] == 0, f"{name} [cuda]: the profiler recorded copies without their bytes")
        if resident_read:
            check(crossing == 0, f"{name} [cuda]: a resident read crossed between host and card ({copies})")
        shutil.rmtree(work, ignore_errors=True)
        results[name] = dict(seq_s=seq_s, ratio=ratio, peak=peaks.worst, projected=projected, cold_s=times[0],
                             warm_s=times[1], stats=stats[1], launches=launches[0], seq_launches=seq_launches,
                             copies=crossing)
    print(f"array API phase: {time.perf_counter() - t0:.1f} s; {smi_tag()}")
    return results


# ---------------------------------------------------------------------------
# the Zarr and stencils phase: results written to Zarr (to_zarr compressed,
# store), the stencil (map_overlap), pad, random.normal and randint
# ---------------------------------------------------------------------------

#: vorticity's arrays (500, 450, 400) float64 in 100-chunks (720 MB each)
#: under 2GB; a pangeo stencil on them (a horizontal five-point Laplacian,
#: periodic in both horizontal axes) written to Zarr with zlib level 1, and
#: vorticity's product written uncompressed; pad of addsum's (5000, 5000) /
#: 1000 array; the sequential executor's run cut along the first axis to 100
ZARR_STENCIL = dict(shape=(500, 450, 400), chunks=100, allowed_mem="2GB", depth=(0, 1, 1),
                    compressor={"id": "zlib", "level": 1}, pad_shape=(5000, 5000), pad_chunks=1000,
                    seq_shape=(100, 450, 400), seq_pad_shape=(1000, 5000))


def laplacian(torch):
    """The stencil's block function: the horizontal five-point Laplacian of a
    block extended by one element along axes 1 and 2 (periodic rolls inside
    the extended block; the halo's rows are trimmed off by map_overlap)."""

    def laplacian(b):
        return (torch.roll(b, 1, 1) + torch.roll(b, -1, 1)) + (torch.roll(b, 1, 2) + torch.roll(b, -1, 2)) - 4.0 * b

    return laplacian


def laplacian_oracle(a: np.ndarray) -> np.ndarray:
    """numpy's periodic Laplacian of the whole array, the same five values
    summed in the same order as :func:`laplacian`."""
    return (np.roll(a, 1, 1) + np.roll(a, -1, 1)) + (np.roll(a, 1, 2) + np.roll(a, -1, 2)) - 4.0 * a


def oracle_draws(shape, chunks, root_seed, draw, dtype=np.float64) -> np.ndarray:
    """numpy's per-block streams of any distribution: the block at linear
    offset k is ``draw(Generator(Philox(root_seed + k)), block shape)``,
    blocks drawn in ORACLE_THREADS threads (numpy's draws release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    chunks = (chunks,) * len(shape) if isinstance(chunks, int) else tuple(chunks)
    nblocks = [len(range(0, s, c)) for s, c in zip(shape, chunks)]
    out = np.empty(shape, dtype=dtype)

    def fill(idx):
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        rng = np.random.Generator(np.random.Philox(seed=root_seed + int(np.ravel_multi_index(idx, nblocks))))
        out[sel] = draw(rng, tuple(s.stop - s.start for s in sel))

    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        list(pool.map(fill, np.ndindex(*nblocks)))
    return out


def zarr_stencil_inputs(spec, shape, chunks):
    """The phase's arrays in the order their root seeds are drawn after
    ``random.seed(SEED)``: vorticity's four uniform arrays, then a normal
    and a randint array of the same shape."""
    import cubed_tpu_torch

    random.seed(SEED)
    a, b, x, y = (cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec) for _ in range(4))
    n = cubed_tpu_torch.random.normal(shape, chunks=chunks, spec=spec)
    r = cubed_tpu_torch.random.randint(-1000, 1000, shape, chunks=chunks, spec=spec)
    return a, b, x, y, n, r


def zarr_stencil_oracles(shape, chunks) -> dict:
    random.seed(SEED)
    roots = [random.getrandbits(30) for _ in range(6)]
    a, b, x, y = (oracle_draws(shape, chunks, r, lambda g, s: g.random(s)) for r in roots[:4])
    return dict(
        stencil=laplacian_oracle(a),
        product=a[1:] * x[1:] + b[1:] * y[1:],
        normal=oracle_draws(shape, chunks, roots[4], lambda g, s: g.normal(size=s)),
        randint=oracle_draws(shape, chunks, roots[5], lambda g, s: g.integers(0, 2000, size=s, dtype=np.int64),
                             np.int64) - 1000)


class StoreTimes:
    """Times, while open, the two halves of every chunk write of the port's
    local Zarr stores: the codec's compression and the atomic, fsync'd file
    write (temp file, fsync, rename, fsync of the directory). The device
    executor writes a requested output after its tasks, outside any task
    scope, so its writes carry no ``storage_write`` span to read."""

    def __init__(self):
        self.compress_s = self.write_s = 0.0
        self.chunks = 0

    def __enter__(self):
        from cubed_tpu_torch.storage import store

        self._store = store
        self._codec_from_meta, self._write = store._codec_from_meta, store._LocalIO.write_bytes_atomic
        times = self

        def codec_from_meta(comp):
            codec = times._codec_from_meta(comp)
            if codec is None:
                return None

            def compress(data):
                t = time.perf_counter()
                try:
                    return codec[0](data)
                finally:
                    times.compress_s += time.perf_counter() - t

            return compress, codec[1]

        def write_bytes_atomic(io, name, data):
            t = time.perf_counter()
            try:
                return times._write(io, name, data)
            finally:
                times.write_s += time.perf_counter() - t
                times.chunks += name != ".zarray"

        store._codec_from_meta, store._LocalIO.write_bytes_atomic = codec_from_meta, write_bytes_atomic
        return self

    def __exit__(self, *exc):
        self._store._codec_from_meta, self._store._LocalIO.write_bytes_atomic = self._codec_from_meta, self._write


def stored_bytes(store: str) -> int:
    return sum(os.path.getsize(os.path.join(store, f)) for f in os.listdir(store) if not f.startswith("."))


def device_write(torch, label: str, write, store: str, ex, expected: np.ndarray, how, compressor,
                 attempts=("cold", "warm")) -> dict:
    """Run *write* (a to_zarr or store call on *ex*) once for each of
    *attempts*, cold then warm; read the cold store back with ``from_zarr``
    and hold it against *expected*, and the warm one's chunk files against
    the cold one's; print the times, the write's split, the bytes as stored,
    launches, path counters and peak reserved memory."""
    import cubed_tpu_torch
    from cubed_tpu_torch.observability.metrics import get_registry

    runs = []
    wrappers = kernel_wrappers()
    cold_store = store + ".cold"
    for attempt in attempts:
        shutil.rmtree(store, ignore_errors=True)
        torch.cuda.synchronize()
        reset_peaks()
        for w in wrappers.values():
            w.launches = 0
        before = get_registry().snapshot()
        with StoreTimes() as st:
            t = time.perf_counter()
            write(ex)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        launches = {k: w.launches for k, w in wrappers.items()}
        written = get_registry().snapshot_delta(before).get("bytes_written", 0)
        peak_reserved = read_peaks()["reserved"]
        on_disk = stored_bytes(store)
        t = time.perf_counter()
        z = cubed_tpu_torch.from_zarr(store)
        check(z.zarray.compressor == compressor, f"{label}: the store's compressor is {z.zarray.compressor}")
        if attempt == "cold":
            err = compare_to_oracle(f"{label} [cuda, {attempt}]", z.compute(), expected, how)
            os.rename(store, cold_store)
        else:
            # the warm compute's chunk files, byte for byte the cold one's
            # (read back and held against the oracle above)
            names = sorted(f for f in os.listdir(store) if not f.startswith("."))
            check(names == sorted(f for f in os.listdir(cold_store) if not f.startswith(".")),
                  f"{label}: the warm compute wrote other chunks than the cold one")
            for f in names:
                with open(os.path.join(store, f), "rb") as w, open(os.path.join(cold_store, f), "rb") as c:
                    check(w.read() == c.read(), f"{label}: chunk {f} of the warm compute differs from the cold one's")
            shutil.rmtree(cold_store, ignore_errors=True)
        read_s = time.perf_counter() - t
        stats = dict(sorted(ex.stats.items()))
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
            check(stats.get(counter, 0) == 0, f"{label} [cuda]: {counter} = {stats.get(counter)}")
        check(written == on_disk, f"{label}: bytes_written {written} B, the store holds {on_disk} B")
        print(f"{label} [cuda, {attempt}]: compute() {seconds:.3f} s; chunk writes {st.chunks}: compression "
              f"{st.compress_s:.3f} s, fsync'd writes {st.write_s:.3f} s, the rest {seconds - st.compress_s - st.write_s:.3f}"
              f" s; {written} B written as stored ({written / expected.nbytes:.4f} of {expected.nbytes} B); "
              f"{'read back and held against the oracle' if attempt == 'cold' else 'chunk files compared with the cold'}"
              f" {read_s:.3f} s, max rel err {err:.3e}; launches {json.dumps(launches)}; stats {json.dumps(stats)}; "
              f"peak reserved {peak_reserved} B; {smi_tag()}")
        runs.append(dict(seconds=seconds, compress_s=st.compress_s, write_s=st.write_s, chunks=st.chunks,
                         written=written, read_s=read_s, launches=launches, stats=stats,
                         peak_reserved=peak_reserved))
    shutil.rmtree(cold_store, ignore_errors=True)
    return dict(zip(attempts, runs))


def sequential_tight(torch, label: str, build, write, store: str, expected, how, work: str) -> dict:
    """*build(spec)* on the sequential executor under allowed_mem equal to its
    plan's projected memory (reserved_mem 0), written to *store* by
    *write(arr, callbacks)*, each task's device peak at most that bound; the
    value read back from the store against *expected*."""
    import cubed_tpu_torch
    from cubed_tpu_torch.core.ops import _store_op

    probe = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", reserved_mem=0)
    projected = _store_op(build(probe), os.path.join(work, "probe.zarr")).plan.max_projected_mem()
    tight = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=projected, reserved_mem=0)
    arr = build(tight)
    peaks = TaskPeaks(torch)
    with StoreTimes() as st:
        t = time.perf_counter()
        write(arr, [peaks])
        seconds = time.perf_counter() - t
    err = compare_to_oracle(f"{label} [sequential]", cubed_tpu_torch.from_zarr(store).compute(), expected, how)
    ratio = peaks.worst / projected
    print(f"{label} [sequential]: compute() {seconds:.3f} s, {peaks.tasks} tasks; compression {st.compress_s:.3f} s, "
          f"fsync'd writes {st.write_s:.3f} s ({st.chunks} chunks); largest task device peak {peaks.worst} B "
          f"({peaks.worst_op}) / projected {projected} B = {ratio:.4f} ({peaks.guard_note()}); max rel err "
          f"{err:.3e}; {smi_tag()}")
    check(ratio <= 1.0, f"{label}: a task's device peak {peaks.worst} B is over its projected {projected} B")
    return dict(seconds=seconds, ratio=ratio, peak=peaks.worst, projected=projected)


def run_zarr_stencil_phase(torch, config=ZARR_STENCIL) -> dict:
    """The Zarr and stencils phase (see the module docstring). Returns its
    numbers, printed as they come."""
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    t0 = time.perf_counter()
    shape, chunks, comp = config["shape"], config["chunks"], config["compressor"]
    oracles = zarr_stencil_oracles(shape, chunks)
    print(f"zarr and stencils phase: {shape} float64 in {chunks}-chunks, allowed_mem {config['allowed_mem']}; "
          f"numpy oracles {time.perf_counter() - t0:.1f} s; {smi_tag()}")
    work = os.path.join(WORK_DIR, "zarr-stencil")
    out = {}
    lap = laplacian(torch)

    def stencil(spec):
        return cubed_tpu_torch.map_overlap(lap, zarr_stencil_inputs(spec, shape, chunks)[0],
                                           depth=config["depth"], boundary="periodic")

    def product(spec):
        a, b, x, y = zarr_stencil_inputs(spec, shape, chunks)[:4]
        return xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:]))

    def mean_square(spec):
        sq = stencil(spec)
        return xp.mean(xp.multiply(sq, sq))

    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"])
    store_a, store_b = os.path.join(work, "stencil.zarr"), os.path.join(work, "product.zarr")
    # (a) the stencil, compressed by to_zarr, cold only: a warm compute
    # repeats its compression, 94% of the cold one (PERF.md §5); (b) the
    # product, uncompressed by store, cold and warm
    sa = stencil(spec)
    out["stencil_to_zarr"] = device_write(
        torch, "stencil to_zarr zlib-1", lambda ex: cubed_tpu_torch.to_zarr(sa, store_a, executor=ex, compressor=comp),
        store_a, CudaExecutor(), oracles["stencil"], ("rtol", 1e-12), comp, attempts=("cold",))
    sb = product(spec)
    out["product_store"] = device_write(
        torch, "product store", lambda ex: cubed_tpu_torch.store(sb, store_b, executor=ex), store_b, CudaExecutor(),
        oracles["product"], "exact", None)
    shutil.rmtree(work, ignore_errors=True)

    # a summary of the stencil, the mean of its square (the region_sum
    # kernel; its plain mean is zero up to rounding), and the normal and
    # randint arrays, drawn on the host, each on the device executor
    wrappers = kernel_wrappers()
    for name, build, expected, how in (
        ("stencil mean square", mean_square,
         np.mean(oracles["stencil"] * oracles["stencil"]), ("rtol", 1e-12)),
        ("normal", lambda s: zarr_stencil_inputs(s, shape, chunks)[4], oracles["normal"], "exact"),
        ("randint", lambda s: zarr_stencil_inputs(s, shape, chunks)[5], oracles["randint"], "exact"),
    ):
        arr = build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"]))
        ex = CudaExecutor()
        torch.cuda.synchronize()
        reset_peaks()
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        value = arr.compute(executor=ex)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: w.launches for k, w in wrappers.items()}
        err = compare_to_oracle(f"{name} [cuda]", np.asarray(value), np.asarray(expected), how)
        if name == "stencil mean square":
            check(launches["philox_uniform"] >= 1 and launches["region_sum"] >= 1,
                  f"{name}: launches {launches}; the phase runs Philox and region_sum")
        stats = dict(sorted(ex.stats.items()))
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
            check(stats.get(counter, 0) == 0, f"{name} [cuda]: {counter} = {stats.get(counter)}")
        print(f"{name} [cuda]: compute() {seconds:.3f} s; max rel err {err:.3e}; launches {json.dumps(launches)}; "
              f"stats {json.dumps(stats)}; peak reserved {read_peaks()['reserved']} B; {smi_tag()}")
        out[name] = dict(seconds=seconds, launches=launches, stats=stats)
        shutil.rmtree(work, ignore_errors=True)

    # pad, constant and edge, of addsum's array
    random.seed(SEED)
    pshape, pchunks = config["pad_shape"], config["pad_chunks"]
    pa = oracle_random(pshape, pchunks, random.getrandbits(30))
    for name, pad, np_pad in (
        ("pad constant", lambda a: xp.pad(a, 1), lambda a: np.pad(a, 1)),
        ("pad edge", lambda a: xp.pad(a, ((2, 1), (1, 2)), mode="edge"),
         lambda a: np.pad(a, ((2, 1), (1, 2)), mode="edge")),
    ):
        random.seed(SEED)
        arr = pad(cubed_tpu_torch.random.random(pshape, chunks=pchunks, spec=cubed_tpu_torch.Spec(
            work_dir=work, allowed_mem=config["allowed_mem"])))
        ex = CudaExecutor()
        t = time.perf_counter()
        value = arr.compute(executor=ex)
        seconds = time.perf_counter() - t
        compare_to_oracle(f"{name} [cuda]", value, np_pad(pa), "exact")
        print(f"{name} [cuda]: {pshape} / {pchunks} to {value.shape}, compute() {seconds:.3f} s; stats "
              f"{json.dumps(dict(sorted(ex.stats.items())))}; {smi_tag()}")
        out[name] = dict(seconds=seconds)
        shutil.rmtree(work, ignore_errors=True)

    # the same plans on the sequential executor, cut, under their projections
    seq_shape = config["seq_shape"]
    seq = zarr_stencil_oracles(seq_shape, chunks)
    seq_store = os.path.join(work, "out.zarr")
    cases = (
        ("stencil to_zarr zlib-1", lambda s: cubed_tpu_torch.map_overlap(
            lap, zarr_stencil_inputs(s, seq_shape, chunks)[0], depth=config["depth"], boundary="periodic"),
         lambda arr, cbs: cubed_tpu_torch.to_zarr(arr, seq_store, compressor=comp, callbacks=cbs),
         seq["stencil"], ("rtol", 1e-12)),
        ("product store", lambda s: (lambda a, b, x, y: xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))(
            *zarr_stencil_inputs(s, seq_shape, chunks)[:4]),
         lambda arr, cbs: cubed_tpu_torch.store(arr, seq_store, callbacks=cbs), seq["product"], "exact"),
        ("normal", lambda s: zarr_stencil_inputs(s, seq_shape, chunks)[4],
         lambda arr, cbs: cubed_tpu_torch.to_zarr(arr, seq_store, callbacks=cbs), seq["normal"], "exact"),
        ("randint", lambda s: zarr_stencil_inputs(s, seq_shape, chunks)[5],
         lambda arr, cbs: cubed_tpu_torch.to_zarr(arr, seq_store, callbacks=cbs), seq["randint"], "exact"),
    )
    random.seed(SEED)
    pa = oracle_random(config["seq_pad_shape"], pchunks, random.getrandbits(30))

    def padded(mode):
        def build(s):
            random.seed(SEED)
            a = cubed_tpu_torch.random.random(config["seq_pad_shape"], chunks=pchunks, spec=s)
            return xp.pad(a, 1) if mode == "constant" else xp.pad(a, ((2, 1), (1, 2)), mode="edge")

        return build

    cases += (
        ("pad constant", padded("constant"), lambda arr, cbs: cubed_tpu_torch.to_zarr(arr, seq_store, callbacks=cbs),
         np.pad(pa, 1), "exact"),
        ("pad edge", padded("edge"), lambda arr, cbs: cubed_tpu_torch.to_zarr(arr, seq_store, callbacks=cbs),
         np.pad(pa, ((2, 1), (1, 2)), mode="edge"), "exact"),
    )

    for name, build, write, expected, how in cases:
        out[f"{name} sequential"] = sequential_tight(torch, f"{name} {seq_shape if 'pad' not in name else ''}".strip(),
                                                     build, write, seq_store, expected, how, work)
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"zarr and stencils phase: {out['seconds']:.1f} s; {smi_tag()}")
    return out


# ---------------------------------------------------------------------------
# the linear algebra and spectra phase: einsum, fft and linalg (TSQR, the
# per-matrix solvers, the blocked Cholesky, norms)
# ---------------------------------------------------------------------------

#: each (shape, chunks), float64 under allowed_mem 2GB: einsum on
#: vorticity's arrays (a per-gridpoint covariance numerator, a weighted
#: time mean) and at matmul's 4000^2 / 1000 (float64, and float32 under
#: matmul_precision="bfloat16"), an int64 product of randint arrays; the
#: spectra of the order-statistics phase's climatology (2048 daily steps of
#: a 256 x 256 tile) with (512, 64, 64) chunks, so that the time axis
#: gathered for rfft is a 64 MB chunk, and rfftn/irfftn over vorticity's
#: horizontal axes; TSQR of an EOF data matrix (2^20 samples of 128
#: modes, 1.07 GB in 16 panels); the solvers on one 8 x 8 covariance
#: matrix per gridpoint of a 256 x 256 grid; the blocked Cholesky of an
#: 8192^2 matrix (5 n^2 8 B over 2GB: 3952 blocks, 3 panels, the last of
#: 288); the sequential executor's cuts under the tight bound
LINALG_FFT = dict(
    allowed_mem="2GB",
    vort=((500, 450, 400), 100), weights=((500,), 100), matmul=((4000, 4000), 1000), imatmul=((2000, 2000), 500),
    clim=((2048, 256, 256), (512, 64, 64)), tsqr=((1048576, 128), (65536, 128)), batch=((65536, 8, 8), (8192, 8, 8)),
    chol=(8192, 3952), chol_mem="2GB",
)
#: the sequential executor's cut: every op of the phase (but the float32
#: einsum, the float64 plan under the device executor's options) at these
#: sizes, under the tight bound; the blocked Cholesky planned under 4MB so
#: that it is blocked (5 n^2 8 B over the budget), its 100 blocks kept
#: (3 panels); the products' grids of two blocks a side (their task counts
#: rule the sequential time)
LINALG_FFT_SEQ = dict(
    allowed_mem="2GB",
    vort=((100, 90, 80), (25, 30, 40)), weights=((100,), 25), matmul=((200, 200), 100), imatmul=((100, 100), 50),
    clim=((256, 32, 32), (64, 16, 16)), tsqr=((16384, 32), (2048, 32)), batch=((1024, 8, 8), (256, 8, 8)),
    chol=(300, 100), chol_mem="1500KB",
)
#: the root seeds' order: each input of the phase draws its own after
#: ``random.seed`` of its own value
LINALG_SEEDS = dict(a=SEED + 100, b=SEED + 101, w=SEED + 102, m1=SEED + 103, m2=SEED + 104, i1=SEED + 105,
                    i2=SEED + 106, clim=SEED + 107, tsqr=SEED + 108, batch=SEED + 109, rhs=SEED + 110,
                    chol=SEED + 111)


def phase_random(spec, shape, chunks, key: str):
    """``random.random`` of the phase's input *key* (its own root seed)."""
    import cubed_tpu_torch

    random.seed(LINALG_SEEDS[key])
    return cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec)


def phase_randint(spec, shape, chunks, key: str):
    import cubed_tpu_torch

    random.seed(LINALG_SEEDS[key])
    return cubed_tpu_torch.random.randint(-9, 9, shape, chunks=chunks, spec=spec)


def phase_oracle(shape, chunks, key: str, integer: bool = False) -> np.ndarray:
    """numpy's draws of the phase's input *key*, block by block."""
    random.seed(LINALG_SEEDS[key])
    root = random.getrandbits(30)
    if integer:
        return oracle_draws(shape, chunks, root, lambda g, s: g.integers(0, 18, size=s, dtype=np.int64),
                            np.int64) - 9
    return oracle_draws(shape, chunks, root, lambda g, s: g.random(s))


def spd_stack(xp, b):
    """One SPD matrix per gridpoint: B B^T / n + n I (eigenvalues in [n, 2n])."""
    n = b.shape[-1]
    return xp.add(xp.divide(xp.matmul(b, xp.matrix_transpose(b)), float(n)),
                  xp.multiply(xp.eye(n, dtype=xp.float64, chunks=(b.chunks[-2], b.chunks[-1]), spec=b.spec),
                              float(n)))


def spd_oracle(bn: np.ndarray) -> np.ndarray:
    n = bn.shape[-1]
    return bn @ np.swapaxes(bn, -1, -2) / n + n * np.eye(n)


def nonpd_shift(xp, a, spec):
    """*a* with its first matrix shifted by -100 I (not positive definite)."""
    import cubed_tpu_torch

    shift = np.zeros((a.shape[0], 1, 1))
    shift[0] = 100.0
    s = cubed_tpu_torch.from_array(shift, chunks=(a.chunksize[0], 1, 1), spec=spec)
    return xp.subtract(a, xp.multiply(xp.eye(a.shape[-1], dtype=xp.float64, spec=spec), s))


def cholesky_failed(spd: np.ndarray) -> np.ndarray:
    """The JAX package's result for a batch whose first matrix is not
    positive definite: NaN on and below its diagonal, 0 above; the others
    numpy's factors."""
    n = spd.shape[-1]
    out = np.empty_like(spd)
    out[0] = np.where(np.tril(np.ones((n, n), bool)), np.nan, 0.0)
    out[1:] = np.linalg.cholesky(spd[1:])
    return out


def compare_norm(label: str, value, expected, tol: float) -> float:
    """The largest difference over the largest magnitude of the oracle (for
    values that cancel to about zero, as transforms' do); NaN where the
    oracle is NaN, and no other non-finite value."""
    value, expected = np.asarray(value), np.asarray(expected)
    check(value.dtype == expected.dtype and value.shape == expected.shape,
          f"{label}: {value.dtype}{value.shape}, numpy's oracle {expected.dtype}{expected.shape}")
    check(np.array_equal(np.isnan(value), np.isnan(expected)) and np.isfinite(value[~np.isnan(expected)]).all(),
          f"{label}: its NaN pattern is not the oracle's")
    finite = ~np.isnan(expected)
    err = float(np.max(np.abs(value[finite] - expected[finite]), initial=0.0)) / float(
        np.max(np.abs(expected[finite]), initial=1.0))
    check(err <= tol, f"{label}: differs from the numpy oracle by {err:.3e} of its largest magnitude > {tol}")
    return err


def canonical_rows(r: np.ndarray) -> np.ndarray:
    """R's rows scaled so that its diagonal is non-negative (a QR's R is
    defined up to these signs)."""
    d = np.sign(np.diagonal(r, axis1=-2, axis2=-1))
    return r * np.where(d == 0, 1, d)[..., :, None]


def canonical_cols(v: np.ndarray) -> np.ndarray:
    """Each column signed so that its largest entry is positive."""
    idx = np.argmax(np.abs(v), axis=-2)[..., None, :]
    s = np.sign(np.take_along_axis(v, idx, axis=-2))
    return v * np.where(s == 0, 1, s)


def numpy_tsqr_r(x: np.ndarray, rows: int) -> np.ndarray:
    """numpy's R of *x* by panels of *rows* (numpy's QR of each panel in
    ORACLE_THREADS threads, then of their stacked R factors): R up to the
    signs of its rows, as ``np.linalg.qr(x, mode="r")`` gives it, in a
    fraction of its time on a tall matrix."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        rs = list(pool.map(lambda i: np.linalg.qr(x[i:i + rows], mode="r"), range(0, x.shape[0], rows)))
    return np.linalg.qr(np.concatenate(rs), mode="r")


#: ops checked after the loop on the card at full size (Q R and Q^T Q; L
#: L^T, and numpy's Cholesky of the card's A), not by a host oracle
CHECKED_ON_THE_CARD = ("qr Q", "blocked cholesky")


def op_mem(config, name: str) -> str:
    """The budget an op of the phase is planned under."""
    return config["chol_mem"] if name == "blocked cholesky" else config["allowed_mem"]


#: ops whose output is large: each is computed cold and capturing (the
#: capture replays at once); a third, warm compute would repeat its output's
#: fsync'd writes (3.6-4.5 s a GB) and is cut
LINALG_BIG_OUTPUTS = ("rfft (time)", "rfftn/irfftn (y, x)", "qr Q", "blocked cholesky")


def linalg_fft_ops(config, cache: Optional[dict] = None) -> dict:
    """name -> (build(spec), oracle() -> expected, comparison, executor options):
    a comparison is ("norm", tol) (:func:`compare_norm`), a ("rtol", tol)
    or "exact" of :func:`compare_to_oracle`, or a function(value, expected)
    returning the error after checking."""
    import cubed_tpu_torch.array_api as xp

    (vshape, vch), (wshape, wch) = config["vort"], config["weights"]
    (mshape, mch), (ishape, ich) = config["matmul"], config["imatmul"]
    (cshape, cch), (tshape, tch), (bshape, bch) = config["clim"], config["tsqr"], config["batch"]
    n, nch = config["chol"]
    cache = {} if cache is None else cache

    def host(key, shape, chunks, integer=False):
        if key not in cache:
            cache[key] = phase_oracle(shape, chunks, key, integer)
        return cache[key]

    def rfft_host():
        if "rfft" not in cache:
            cache["rfft"] = np.fft.rfft(host("clim", cshape, cch), axis=0)
        return cache["rfft"]

    def tsqr_r_host():
        if "tsqr_r" not in cache:
            cache["tsqr_r"] = numpy_tsqr_r(host("tsqr", tshape, tch), tch[0])
        return cache["tsqr_r"]

    def solvers_host():
        if "spd" not in cache:
            cache["spd"] = spd_oracle(host("batch", bshape, bch))
        return cache["spd"]

    def rhs_host():
        return host("rhs", (bshape[0], bshape[1], 1), (bch[0], bch[1], 1))

    def tsqr_r_check(value, expected):
        # R against numpy's after the signs are made canonical
        return compare_norm("qr R", canonical_rows(value), canonical_rows(expected), 1e-10)

    def eigh_vecs_check(value, expected):
        return compare_norm("eigh eigenvectors", canonical_cols(value), canonical_cols(expected), 1e-9)

    def vort(s, key):
        return phase_random(s, vshape, vch, key)

    return {
        "einsum tyx,tyx->yx": (lambda s: xp.einsum("tyx,tyx->yx", vort(s, "a"), vort(s, "b")),
                               lambda: np.einsum("tyx,tyx->yx", host("a", vshape, vch), host("b", vshape, vch)),
                               ("rtol", 1e-12), {}),
        "einsum tyx,t->yx": (lambda s: xp.einsum("tyx,t->yx", vort(s, "a"), phase_random(s, wshape, wch, "w")),
                             lambda: np.einsum("tyx,t->yx", host("a", vshape, vch), host("w", wshape, wch)),
                             ("rtol", 1e-12), {}),
        "einsum ij,jk->ik": (lambda s: xp.einsum("ij,jk->ik", phase_random(s, mshape, mch, "m1"),
                                                 phase_random(s, mshape, mch, "m2")),
                             lambda: host("m1", mshape, mch) @ host("m2", mshape, mch), ("rtol", 1e-12), {}),
        "einsum ij,jk->ik f32 bf16": (
            lambda s: xp.einsum("ij,jk->ik", phase_random(s, mshape, mch, "m1"), phase_random(s, mshape, mch, "m2")),
            lambda: mode_model(host("m1", mshape, mch), host("m2", mshape, mch), "bfloat16"), ("rtol", 1e-5),
            dict(compute_dtype="float32", matmul_precision="bfloat16")),
        "einsum ij,jk->ik int64": (
            lambda s: xp.einsum("ij,jk->ik", phase_randint(s, ishape, ich, "i1"), phase_randint(s, ishape, ich, "i2")),
            # |sums| < 2000 * 81, exact in a float64 product
            lambda: (host("i1", ishape, ich, True).astype(np.float64) @ host("i2", ishape, ich, True)).astype(np.int64),
            "exact", {}),
        "rfft (time)": (lambda s: xp.fft.rfft(phase_random(s, cshape, cch, "clim"), axis=0), rfft_host,
                        ("norm", 1e-12), {}),
        "power spectrum mean": (
            lambda s: xp.mean(xp.square(xp.abs(xp.fft.rfft(phase_random(s, cshape, cch, "clim"), axis=0))),
                              axis=(1, 2)),
            lambda: np.mean(np.abs(rfft_host()) ** 2, axis=(1, 2)), ("rtol", 1e-12), {}),
        "rfftn/irfftn (y, x)": (
            lambda s: xp.fft.irfftn(xp.fft.rfftn(vort(s, "a"), axes=(1, 2)), s=vshape[1:], axes=(1, 2)),
            lambda: host("a", vshape, vch), ("norm", 1e-12), {}),
        "fftshift(fftfreq)": (lambda s: xp.fft.fftshift(xp.fft.fftfreq(cshape[0], d=1 / 365.25, spec=s)),
                              lambda: np.fft.fftshift(np.fft.fftfreq(cshape[0], d=1 / 365.25)), ("norm", 1e-15), {}),
        # Q R and Q^T Q are checked on the card (run_linalg_fft_phase); the
        # sequential cut's Q against numpy's after canonical signs
        "qr Q": (lambda s: xp.linalg.qr(phase_random(s, tshape, tch, "tsqr")).Q,
                 lambda: np.linalg.qr(host("tsqr", tshape, tch))[0],
                 lambda v, e: compare_norm("qr Q", canonical_cols(v), canonical_cols(e), 1e-10), {}),
        "qr R": (lambda s: xp.linalg.qr(phase_random(s, tshape, tch, "tsqr")).R, tsqr_r_host, tsqr_r_check, {}),
        # X's singular values are its R's: numpy's SVD of numpy's R (of X
        # whole, 6.7 s more)
        "svdvals": (lambda s: xp.linalg.svdvals(phase_random(s, tshape, tch, "tsqr")),
                    lambda: np.linalg.svd(tsqr_r_host(), compute_uv=False), ("rtol", 1e-10), {}),
        "matrix_norm fro": (lambda s: xp.linalg.matrix_norm(phase_random(s, tshape, tch, "tsqr"), ord="fro"),
                            lambda: np.linalg.norm(host("tsqr", tshape, tch)), ("rtol", 1e-12), {}),
        "cholesky": (lambda s: xp.linalg.cholesky(spd_stack(xp, phase_random(s, bshape, bch, "batch"))),
                     lambda: np.linalg.cholesky(solvers_host()), ("norm", 1e-12), {}),
        "solve": (lambda s: xp.linalg.solve(spd_stack(xp, phase_random(s, bshape, bch, "batch")),
                                            phase_random(s, (bshape[0], bshape[1], 1), (bch[0], bch[1], 1), "rhs")),
                  lambda: np.linalg.solve(solvers_host(), rhs_host()), ("norm", 1e-12), {}),
        "inv": (lambda s: xp.linalg.inv(spd_stack(xp, phase_random(s, bshape, bch, "batch"))),
                lambda: np.linalg.inv(solvers_host()), ("norm", 1e-12), {}),
        "slogdet": (lambda s: xp.linalg.slogdet(spd_stack(xp, phase_random(s, bshape, bch, "batch"))).logabsdet,
                    lambda: np.linalg.slogdet(solvers_host())[1], ("rtol", 1e-12), {}),
        "eigh eigenvalues": (lambda s: xp.linalg.eigh(spd_stack(xp, phase_random(s, bshape, bch, "batch"))).eigenvalues,
                             lambda: np.linalg.eigvalsh(solvers_host()), ("rtol", 1e-12), {}),
        "eigh eigenvectors": (
            lambda s: xp.linalg.eigh(spd_stack(xp, phase_random(s, bshape, bch, "batch"))).eigenvectors,
            lambda: np.linalg.eigh(solvers_host())[1], eigh_vecs_check, {}),
        "cholesky, one not positive definite": (
            lambda s: xp.linalg.cholesky(nonpd_shift(xp, spd_stack(xp, phase_random(s, bshape, bch, "batch")), s)),
            lambda: cholesky_failed(solvers_host()), ("norm", 1e-12), {}),
        "blocked cholesky": (lambda s: xp.linalg.cholesky(spd_stack(xp, phase_random(s, (n, n), nch, "chol"))),
                             lambda: np.linalg.cholesky(spd_oracle(host("chol", (n, n), nch))), ("norm", 1e-12), {}),
    }


def run_linalg_fft_phase(torch, config=LINALG_FFT) -> dict:
    """The linear algebra and spectra phase (see the module docstring).
    Returns its numbers, printed as they come."""
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch import contraction
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    t0 = time.perf_counter()
    print(f"linalg and fft phase: allowed_mem {config['allowed_mem']}; {smi_tag()}")
    work = os.path.join(WORK_DIR, "linalg-fft")
    wrappers = kernel_wrappers()
    host: dict = {}  # numpy's inputs and results, each drawn or computed once
    ops = linalg_fft_ops(config, host)
    out: dict = {"ops": {}, "launches": {"philox_uniform": 0, "region_sum": 0}}
    values: dict = {}
    # the process's first touch of cuBLAS, cuFFT and cuSOLVER (handles,
    # workspaces, module loads), on small plans, so that no op's cold
    # compute pays for it
    t = time.perf_counter()
    small = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"])
    x = phase_random(small, (64, 8, 8), (16, 8, 8), "batch")
    for warm in (xp.einsum("tyx,tyx->yx", x, x), xp.fft.rfft(x, axis=0), xp.linalg.qr(x[0]).R,
                 xp.linalg.cholesky(spd_stack(xp, x)), xp.linalg.inv(spd_stack(xp, x)),
                 xp.linalg.eigh(spd_stack(xp, x)).eigenvalues):
        warm.compute(executor=CudaExecutor())
    torch.cuda.synchronize()
    shutil.rmtree(work, ignore_errors=True)
    print(f"linalg and fft phase: the process's first library calls (small plans) {time.perf_counter() - t:.2f} s")
    for name, (build, oracle, how, options) in ops.items():
        spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=op_mem(config, name))
        arr = build(spec)
        ex = CudaExecutor(**options)
        seconds, stats, launches = [], [], []
        torch.cuda.synchronize()
        reset_peaks()
        for i in range(2 if name in LINALG_BIG_OUTPUTS else 3):
            for w in wrappers.values():
                w.launches = 0
            t = time.perf_counter()
            value = arr.compute(executor=ex)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            launches.append({k: w.launches for k, w in wrappers.items()})
            stats.append(dict(sorted(ex.stats.items())))
            for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
                check(ex.stats.get(counter, 0) == 0, f"{name} [cuda] compute {i}: {counter} = {ex.stats.get(counter)}")
            if i == 0:
                values[name] = value
        captured = stats[1].get("segments_compiled", 0) > 0
        uncapturable = stats[1].get("segments_uncapturable", 0) > 0
        if name not in CHECKED_ON_THE_CARD:
            t = time.perf_counter()
            expected = oracle()
            oracle_s = time.perf_counter() - t
            if callable(how):
                err = how(values[name], expected)
            elif how != "exact" and how[0] == "norm":
                err = compare_norm(name, values[name], expected, how[1])
            else:
                err = compare_to_oracle(name, values[name], expected, how)
        else:
            err, oracle_s = None, 0.0
        for k in out["launches"]:
            out["launches"][k] += launches[0][k]
        warm = f", warm {seconds[2]:.3f} s" if len(seconds) > 2 else " (warm cut)"
        print(f"{name} [cuda]: {arr.shape} {arr.dtype}; compute() cold {seconds[0]:.3f} s, capturing "
              f"{seconds[1]:.3f} s{warm}; captured {captured}"
              f"{' (a host-synchronising solver: op by op)' if uncapturable else ''}; stats cold "
              f"{json.dumps(stats[0])}, last {json.dumps(stats[-1])}; launches cold {json.dumps(launches[0])}; "
              f"peak reserved {read_peaks()['reserved']} B; max err {err}; oracle {oracle_s:.1f} s; "
              f"{smi_tag()}")
        out["ops"][name] = dict(cold_s=seconds[0], capturing_s=seconds[1], warm_s=seconds[2] if len(seconds) > 2 else None,
                                captured=captured, stats=stats[-1], launches=launches[0],
                                peak_reserved=read_peaks()["reserved"], err=err)
        shutil.rmtree(work, ignore_errors=True)

    # the float32 einsum under bf16 against contraction.matmul_plain on the
    # card (the same rounding, one float32 GEMM of the whole operands)
    a32 = torch.from_numpy(host["m1"].astype(np.float32)).cuda()
    b32 = torch.from_numpy(host["m2"].astype(np.float32)).cuda()
    plain = contraction.matmul_plain(a32, b32, "bfloat16").double().cpu().numpy()
    err = compare_to_oracle("einsum f32 bf16 against matmul_plain",
                            values["einsum ij,jk->ik f32 bf16"], plain, ("rtol", 1e-5))
    print(f"einsum ij,jk->ik f32 bf16 against contraction.matmul_plain on the card: max rel err {err:.3e}")

    # TSQR's Q and the blocked Cholesky's L held on the card: Q R against
    # the input and Q^T Q against I; L L^T against A (A computed on the
    # card, then numpy's Cholesky of it)
    (tshape, tch) = config["tsqr"]
    x = torch.from_numpy(host["tsqr"]).cuda()
    q = torch.from_numpy(np.asarray(values["qr Q"])).cuda()
    r = torch.from_numpy(np.asarray(values["qr R"])).cuda()
    qr_err = float((q @ r - x).abs().max()) / float(x.abs().max())
    orth_err = float((q.T @ q - torch.eye(tshape[1], dtype=q.dtype, device=q.device)).abs().max())
    print(f"qr on the card: max |Q R - X| / max |X| {qr_err:.3e}, max |Q^T Q - I| {orth_err:.3e}")
    check(qr_err <= 1e-12 and orth_err <= 1e-10, "qr: Q R is not X or Q is not orthonormal")
    del x, q, r
    host.clear()
    n, nch = config["chol"]
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"])
    a_np = np.asarray(spd_stack(xp, phase_random(spec, (n, n), nch, "chol")).compute(executor=CudaExecutor()))
    shutil.rmtree(work, ignore_errors=True)
    lo = torch.from_numpy(np.asarray(values["blocked cholesky"])).cuda()
    a = torch.from_numpy(a_np).cuda()
    llt_err = float((lo @ lo.T - a).abs().max()) / float(a.abs().max())
    del lo, a
    t = time.perf_counter()
    chol_err = compare_norm("blocked cholesky", values["blocked cholesky"], np.linalg.cholesky(a_np), 1e-12)
    print(f"blocked cholesky {n}^2: max |L L^T - A| / max |A| {llt_err:.3e} on the card; against numpy's "
          f"{chol_err:.3e} (numpy {time.perf_counter() - t:.1f} s)")
    check(llt_err <= 1e-12, "blocked cholesky: L L^T is not A")
    values.clear()
    check(out["launches"]["philox_uniform"] > 0 and out["launches"]["region_sum"] > 0,
          f"the phase launched {out['launches']}: it runs Philox and region_sum")

    # the sequential executor under the tight bound, cut
    out["sequential"] = linalg_fft_sequential(torch, LINALG_FFT_SEQ, work)
    out["seconds"] = time.perf_counter() - t0
    print(f"linalg and fft phase: {out['seconds']:.1f} s; {smi_tag()}")
    return out


def linalg_fft_sequential(torch, config, work) -> dict:
    """Every op of the phase (but the float32 einsum: the float64 plan under
    the device executor's options) at the cut sizes of *config* on the
    sequential executor, under allowed_mem equal to the plan's projected
    memory (reserved_mem 0; the plan built again under it until its
    projection holds still, as a planner's choices, the blocked Cholesky's
    block size, read the budget), each task's device peak at most that
    bound, each value against numpy's."""
    import cubed_tpu_torch

    out = {}
    for name, (build, oracle, how, options) in linalg_fft_ops(config).items():
        if options:
            continue
        projected = build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=op_mem(config, name),
                                               reserved_mem=0)).plan.max_projected_mem()
        for _ in range(4):
            arr = build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=projected, reserved_mem=0))
            again = arr.plan.max_projected_mem()
            if again == projected:
                break
            projected = again
        check(arr.plan.max_projected_mem() == projected, f"{name} [sequential]: its projection does not hold still")
        peaks = TaskPeaks(torch)
        t = time.perf_counter()
        value = np.asarray(arr.compute(callbacks=[peaks]))
        seconds = time.perf_counter() - t
        expected = oracle()
        if callable(how):
            err = how(value, expected)
        elif how != "exact" and how[0] == "norm":
            err = compare_norm(f"{name} [sequential]", value, expected, how[1])
        else:
            err = compare_to_oracle(f"{name} [sequential]", value, expected, how)
        ratio = peaks.worst / projected
        print(f"{name} [sequential]: {arr.shape}, compute() {seconds:.3f} s, {peaks.tasks} tasks; largest task "
              f"device peak {peaks.worst} B ({peaks.worst_op}) / projected {projected} B = {ratio:.4f} "
              f"({peaks.guard_note()}); max err {err:.3e}; {smi_tag()}")
        check(ratio <= 1.0, f"{name}: a task's device peak {peaks.worst} B is over its projected {projected} B")
        out[name] = dict(seconds=seconds, ratio=ratio, peak=peaks.worst, projected=projected)
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the reliability phase: the memory guard, classified retries, checksums,
# resume and cancellation
# ---------------------------------------------------------------------------

#: the phase's cells: vorticity's product a[1:]*x[1:] + b[1:]*y[1:] (the
#: operand of BASELINE config 5's mean), written by ``to_zarr``, and the mean
#: itself; at full width on the device executor; on the sequential one cut
#: to (160, 160, 120) / 40 (48 blocks an array: about 20 ms a task there,
#: most of it the fsync'd chunk writes), from the spilled cut (200, 180, 160)
#: / 40 that took the phase to 134 s. Faults: the chaos check's seeded profile
RELIABILITY = dict(full=VORTICITY, seq=dict(shape=(160, 160, 120), chunks=40), allowed_mem="2GB", seed=SEED + 15,
                   faults=dict(seed=15, storage_write_failure_rate=0.1, storage_write_leaves_tmp=True,
                               storage_corrupt_rate=0.05, task_failure_rate=0.05),
                   names=915_000_000, cancel_after=37, guard_turns=200)


def product_build(spec, config):
    import cubed_tpu_torch

    shape, chunks = config["shape"], config["chunks"]
    a, b, x, y = [cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec) for _ in range(4)]
    return a[1:] * x[1:] + b[1:] * y[1:]


def product_oracle(config) -> np.ndarray:
    shape, chunks = config["shape"], config["chunks"]
    a, b, x, y = [oracle_random(shape, chunks, random.getrandbits(30)) for _ in range(4)]
    return a[1:] * x[1:] + b[1:] * y[1:]


@contextlib.contextmanager
def pinned_names(base: int):
    """Plan names drawn from *base* on while open, then the counter moves on
    past them: the fault injector hashes chunk keys, which hold array names,
    so a pinned plan gets the same seeded faults in every process."""
    from cubed_tpu_torch import utils

    saved = utils.sym_counter
    utils.sym_counter = itertools.count(base)
    try:
        yield
    finally:
        used = next(utils.sym_counter) - base
        utils.sym_counter = itertools.count(next(saved) + used)


def read_store(store: str) -> np.ndarray:
    from cubed_tpu_torch.storage.store import open_zarr_array

    return open_zarr_array(store, mode="r")[...]


def middle_chunk(store: str) -> str:
    """The middle one of a store's chunk files, in name order."""
    names = sorted(f for f in os.listdir(store) if not f.startswith(".") and not f.endswith(".tmp"))
    return names[len(names) // 2]


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def store_writer(arr, store: str) -> tuple:
    """(name, task count) of the op of *arr*'s finalized plan that writes
    *store*, and the create-arrays op's task count."""
    from cubed_tpu_torch.core.plan import iter_op_nodes

    dag = arr.plan._finalize(array_names=(arr.name,)).dag
    ops = dict(iter_op_nodes(dag))
    name = next(n for n, d in ops.items() if getattr(d["primitive_op"].target_array, "store", None) == store)
    return name, ops[name]["primitive_op"].num_tasks, ops["create-arrays"]["primitive_op"].num_tasks


def op_projections(arr, array_names=None) -> dict:
    """op name -> projected memory of the finalized plan's ops."""
    from cubed_tpu_torch.core.plan import iter_op_nodes

    dag = arr.plan._finalize(array_names=array_names or (arr.name,)).dag
    return {name: d["primitive_op"].projected_mem for name, d in iter_op_nodes(dag)}


class GuardPeaks:
    """Each task's memory-guard reading (``TaskEndEvent.guard_mem_peak``)
    over the plan's bound (its largest projection: §2's gate), the largest
    kept, and the largest device reading over its own op's projection;
    with *compare*, also the reading ``TaskPeaks`` used to take itself (the
    allocator's peak from the task's start, its statistics reset there)
    beside the guard's two readings apart (``memory.last_readings``)."""

    def __init__(self, torch, projections: dict, bound: int, compare: bool = False):
        self.torch, self.projections, self.bound, self.compare = torch, projections, bound, compare
        self.tasks = self.equal = 0
        self.worst = self.worst_device = 0.0
        self.worst_op = self.worst_device_op = None
        self.worst_device_bytes = (0, 0)
        self.diffs: list = []
        self.start = 0

    def on_task_start(self, event):
        if self.compare:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()
            self.start = self.torch.cuda.memory_allocated()

    def on_task_end(self, event):
        from cubed_tpu_torch.runtime import memory

        self.tasks += 1
        check(event.guard_mem_peak is not None, f"{event.array_name}: a task without a guard reading")
        ratio = event.guard_mem_peak / self.bound
        if ratio > self.worst:
            self.worst, self.worst_op = ratio, event.array_name
        projected = self.projections.get(event.array_name)
        device = memory.last_readings()["device"]
        if projected and device / projected > self.worst_device:
            self.worst_device, self.worst_device_op = device / projected, event.array_name
            self.worst_device_bytes = (device, projected)
        if self.compare:
            self.torch.cuda.synchronize()
            old = self.torch.cuda.max_memory_allocated() - self.start
            if old == event.guard_mem_peak:
                self.equal += 1
            else:
                self.diffs.append((event.array_name, event.chunk_key, old, event.guard_mem_peak, device,
                                   memory.last_readings()["host"]))


class CancelAfter:
    """Cancels *token* once *n* tasks of the op named *op* have ended."""

    def __init__(self, token, op: str, n: int):
        self.token, self.op, self.n, self.seen = token, op, n, 0

    def on_task_end(self, event):
        if event.array_name == self.op:
            self.seen += 1
            if self.seen == self.n:
                self.token.cancel("the phase's client asked")


class UnitPeaks:
    """The device executor's guard readings: each op's task event carries
    the reading of the segment or eager op it ran in."""

    def __init__(self):
        self.units: dict = {}

    def on_task_end(self, event):
        self.units.setdefault(event.guard_mem_peak, []).append(event.array_name)


class OpTasks:
    """Counts the ended tasks of each op."""

    def __init__(self):
        from collections import Counter

        self.by_op = Counter()

    def on_task_end(self, event):
        self.by_op[event.array_name] += event.num_tasks


def reliability_guard_checks(torch, config, work, timings) -> dict:
    """Checks 1-3: the guard under the bound, an under-modelled op, a real
    CUDA out-of-memory (the sequential executor)."""
    import cubed_tpu_torch
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
    from cubed_tpu_torch.runtime.memory import MemoryGuardExceededError

    out = {}
    seq = config["seq"]
    # 1. every task under the bound, enforced: allowed_mem = the plan's
    # projected memory, reserved_mem 0; the kernels and the host's buffers
    # warmed first by a compute of 8 blocks of the same plan (observed)
    t0 = time.perf_counter()
    random.seed(config["seed"])
    probe = vorticity_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", reserved_mem=0), seq)
    bound = probe.plan.max_projected_mem()
    random.seed(config["seed"])
    expected = vorticity_oracle(seq)
    warm = dict(seq, shape=tuple(2 * seq["chunks"] for _ in seq["shape"]))
    vorticity_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=bound, reserved_mem=0), warm).compute()
    random.seed(config["seed"])
    arr = vorticity_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=bound, reserved_mem=0,
                                               memory_guard="enforce"), seq)
    peaks = GuardPeaks(torch, op_projections(arr), bound, compare=True)
    before = get_registry().snapshot()
    value = float(arr.compute(callbacks=[peaks]))
    delta = get_registry().snapshot_delta(before)
    rel = abs(value - expected) / abs(expected)
    seconds = time.perf_counter() - t0
    print(f"reliability 1 (guard under the bound, sequential, enforce) {seq['shape']} / {seq['chunks']}: "
          f"{peaks.tasks} tasks all passed in {seconds:.3f} s; largest guard_mem_peak / the bound "
          f"(allowed_mem {bound} B) {peaks.worst:.4f} ({peaks.worst_op}); largest device reading / its op's "
          f"projection {peaks.worst_device:.4f} ({peaks.worst_device_op}: {peaks.worst_device_bytes[0]} B of the "
          f"allocator's blocks / {peaks.worst_device_bytes[1]} B); guard readings equal to the "
          f"reset-based reading in {peaks.equal} of {peaks.tasks} tasks; rel err {rel:.3e}; "
          f"mem_guard_soft_exceeded {delta.get('mem_guard_soft_exceeded', 0)}; {smi_tag()}")
    for name, key, old, new, device, host in peaks.diffs[:8]:
        print(f"  differs: {name} {key}: reset-based {old} B, guard {new} B (device {device} B, host RSS growth "
              f"{host} B): {'the host RSS growth is the larger' if (host or 0) > (device or 0) else 'the device'}")
    check(rel <= 1e-12, f"reliability 1: value off by rtol {rel}")
    check(peaks.worst <= 1.0, f"reliability 1: a task's guard_mem_peak is {peaks.worst:.4f} of the bound")
    check(all(device == old for _, _, old, _, device, _ in peaks.diffs),
          "reliability 1: the guard's device reading differs from the reset-based reading")
    out["guard"] = dict(seconds=seconds, tasks=peaks.tasks, worst=peaks.worst, worst_device=peaks.worst_device,
                        equal=peaks.equal, host_larger=len(peaks.diffs))
    timings["1"] = seconds

    # 2. an under-modelled op: a hidden temporary of four blocks on the card
    t0 = time.perf_counter()
    block = seq["chunks"] ** 3

    def hidden(x):
        tmp = torch.empty(4 * block, dtype=x.dtype, device=x.device)
        tmp.fill_(1.0)
        return x * 2.0 + (tmp[0] - 1.0)

    def under_modelled(mode, retries=0):
        random.seed(config["seed"])
        probe = cubed_tpu_torch.random.random(seq["shape"], chunks=seq["chunks"],
                                              spec=cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB",
                                                                        reserved_mem=0))
        allowed = cubed_tpu_torch.map_blocks(hidden, probe, dtype=np.float64).plan.max_projected_mem()
        random.seed(config["seed"])
        spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=allowed, reserved_mem=0, memory_guard=mode)
        a = cubed_tpu_torch.random.random(seq["shape"], chunks=seq["chunks"], spec=spec)
        return cubed_tpu_torch.map_blocks(hidden, a, dtype=np.float64, extra_projected_mem=0), allowed

    t = time.perf_counter()
    r, allowed = under_modelled("observe")
    plans_s = time.perf_counter() - t
    tasks = int(np.prod(r.numblocks))
    random.seed(config["seed"])
    expected = oracle_random(seq["shape"], seq["chunks"], random.getrandbits(30)) * 2.0
    before = get_registry().snapshot()
    t = time.perf_counter()
    value = r.compute()
    observe_s = time.perf_counter() - t
    soft = get_registry().snapshot_delta(before).get("mem_guard_soft_exceeded", 0)
    compare_to_oracle("reliability 2 [observe]", value, expected, "exact")
    print(f"reliability 2 (under-modelled op, observe): plans built in {plans_s:.3f} s (map_blocks traces its "
          f"function at plan time); {tasks} tasks in {observe_s:.3f} s, mem_guard_soft_exceeded {soft}; allowed_mem "
          f"{allowed} B, the hidden temporary {4 * block * 8} B; {smi_tag()}")
    check(soft == tasks, f"reliability 2: mem_guard_soft_exceeded {soft}, expected {tasks}")
    r, allowed = under_modelled("enforce")

    class Attempts:
        n = 0

        def on_task_start(self, event):
            if event.array_name != "create-arrays":
                Attempts.n += 1

    t = time.perf_counter()
    try:
        r.compute(executor=PythonDagExecutor(retries=2), callbacks=[Attempts()])
        raise PhaseFailed("reliability 2: the enforced under-modelled op did not raise")
    except MemoryGuardExceededError as e:
        print(f"reliability 2 (enforce, retries=2): raised after {Attempts.n} attempts, "
              f"{time.perf_counter() - t:.3f} s: {e}")
        check(Attempts.n <= 3, f"reliability 2: {Attempts.n} attempts of the first task")
        check(e.op_name is not None and e.measured is not None and e.allowed == allowed
              and "measured" in str(e) and "allowed_mem" in str(e),
              f"reliability 2: the abort does not name the op, measured and allowed bytes: {e}")
    seconds = time.perf_counter() - t0
    out["under_modelled"] = dict(seconds=seconds, tasks=tasks, soft=soft, attempts=Attempts.n)
    timings["2"] = seconds

    # 3. a real CUDA out-of-memory: allocate past the card's free memory
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())

    def too_big(x):
        if x.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(x.device)
            torch.empty(free + 2**30, dtype=torch.uint8, device=x.device)
        return x

    random.seed(config["seed"])
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB")
    a = cubed_tpu_torch.random.random(seq["shape"], chunks=seq["chunks"], spec=spec)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(dev)
    before = get_registry().snapshot()
    try:
        cubed_tpu_torch.map_blocks(too_big, a, dtype=np.float64).compute(executor=PythonDagExecutor(retries=2))
        raise PhaseFailed("reliability 3: the out-of-memory task did not raise")
    except MemoryGuardExceededError as e:
        cause = type(e.__cause__).__name__
        print(f"reliability 3 (CUDA out of memory): {cause} classified RESOURCE "
              f"(task_resource_failures {get_registry().snapshot_delta(before).get('task_resource_failures', 0)}); "
              f"the abort: {str(e)[:160]}")
        check(isinstance(e.__cause__, torch.OutOfMemoryError), f"reliability 3: caused by {cause}")
    # the caught error is gone (its traceback held the failed task's block)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    print(f"reliability 3: memory_allocated {allocated} B before, {after} B after")
    check(after == allocated, f"reliability 3: memory_allocated {after} B after the abort, {allocated} B before")
    random.seed(config["seed"])
    expected = oracle_random(seq["shape"], seq["chunks"], random.getrandbits(30)) * 2.0
    random.seed(config["seed"])
    a = cubed_tpu_torch.random.random(seq["shape"], chunks=seq["chunks"], spec=spec)
    compare_to_oracle("reliability 3 [the next compute]", cubed_tpu_torch.map_blocks(
        lambda x: x * 2.0, a, dtype=np.float64).compute(), expected, "exact")
    seconds = time.perf_counter() - t0
    print(f"reliability 3: the next compute equals its oracle; {seconds:.3f} s")
    out["oom"] = dict(seconds=seconds, allocated_before=allocated, allocated_after=after, cause=cause)
    timings["3"] = seconds
    return out


def reliability_store_checks(torch, config, work, timings) -> dict:
    """Checks 4 and 5 on the sequential executor: chaos into a verified
    store, then a cancelled compute resumed (and a rotten chunk repaired)."""
    import cubed_tpu_torch
    from cubed_tpu_torch.core.array import execute
    from cubed_tpu_torch.core.ops import _store_op
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime.cancellation import CancellationToken, ComputeCancelledError
    from cubed_tpu_torch.runtime import faults
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
    from cubed_tpu_torch.runtime.faults import FaultConfig
    from cubed_tpu_torch.runtime.resilience import RetryPolicy

    out = {}
    seq = config["seq"]
    random.seed(config["seed"])
    expected = product_oracle(seq)

    # 4. chaos: the same plan under seeded faults (every op's output
    # stored: the intermediates are read, and verified, by the ops after
    # them), armed for that compute alone; nothing reads the output store
    # in it, so a resume of the plan with the faults disarmed (a repeat
    # would repeat the injector's decisions) verifies the store and re-runs
    # the tasks of any chunk corrupted on its way there. The fault-free
    # store: the same plan on the device executor
    t0 = time.perf_counter()
    clean = os.path.join(work, "clean.zarr")
    random.seed(config["seed"])
    cubed_tpu_torch.to_zarr(product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB"), seq), clean,
                            executor=CudaExecutor())
    chaos = os.path.join(work, "chaos.zarr")
    random.seed(config["seed"])
    with pinned_names(config["names"]):
        out_arr = _store_op(product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", integrity="verify"),
                                          seq), chaos)
    executor = PythonDagExecutor(retry_policy=RetryPolicy(retries=6, backoff_base=0.0, seed=0))
    before = get_registry().snapshot()
    with faults.scoped(FaultConfig(**config["faults"])):
        execute(out_arr, executor=executor, optimize_graph=False)
    repaired = OpTasks()
    execute(out_arr, executor=executor, optimize_graph=False, resume=True, callbacks=[repaired])
    delta = get_registry().snapshot_delta(before)
    counters = {k: delta.get(k, 0) for k in ("faults_injected", "faults_injected_storage_write",
                                              "faults_injected_storage_corrupt", "faults_injected_task",
                                              "task_retries", "chunks_corrupt_detected", "chunks_quarantined",
                                              "chunks_recomputed", "tasks_skipped_resume")}
    tmps = sum(f.endswith(".tmp") for _, _, names in os.walk(work) for f in names)
    got = read_store(chaos)
    seconds = time.perf_counter() - t0
    print(f"reliability 4 (chaos, sequential, verify, retries=6) {seq['shape']} / {seq['chunks']}: {seconds:.3f} s; "
          f"{json.dumps(counters)}; .tmp litter {tmps}; the resume with the faults disarmed ran "
          f"{json.dumps(dict(repaired.by_op))}; {smi_tag()}")
    check(np.array_equal(got.view(np.uint64), read_store(clean).view(np.uint64)),
          "reliability 4: the chaos store differs from the fault-free store")
    compare_to_oracle("reliability 4 [fault-free store]", read_store(clean), expected, "exact")
    for k in ("faults_injected", "task_retries", "chunks_corrupt_detected", "chunks_quarantined"):
        check(counters[k] > 0, f"reliability 4: {k} is {counters[k]}")
    out["chaos"] = dict(seconds=seconds, **counters)
    timings["4"] = seconds

    # 5. resume: cancel after 37 tasks of the product op, resume, then rot
    # one chunk and resume again
    t0 = time.perf_counter()
    store = os.path.join(work, "resume.zarr")
    random.seed(config["seed"])
    out_arr = _store_op(product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB"), seq), store)
    op, product_tasks, create_tasks = store_writer(out_arr, store)
    token = CancellationToken()
    try:
        execute(out_arr, cancellation=token, callbacks=[CancelAfter(token, op, config["cancel_after"])])
        raise PhaseFailed("reliability 5: the cancelled compute did not raise")
    except ComputeCancelledError as e:
        print(f"reliability 5: cancelled after {config['cancel_after']} tasks of {op}: {e}")
    total = out_arr.plan.num_tasks()
    pending = out_arr.plan.num_tasks(resume=True)
    tasks = OpTasks()
    execute(out_arr, resume=True, callbacks=[tasks])
    ran = sum(tasks.by_op.values())
    compare_to_oracle("reliability 5 [resumed store]", read_store(store), expected, "exact")
    print(f"reliability 5: num_tasks {total}, num_tasks(resume=True) {pending} (create-arrays {create_tasks} + "
          f"{pending - create_tasks} of {product_tasks} tasks of {op} not done); the resumed compute ran {ran} "
          f"tasks ({dict(tasks.by_op)})")
    check(pending == create_tasks + product_tasks - config["cancel_after"],
          f"reliability 5: num_tasks(resume=True) {pending}")
    check(ran == pending, f"reliability 5: the resumed compute ran {ran} tasks, num_tasks(resume=True) {pending}")
    chunk = middle_chunk(store)
    flip_byte(os.path.join(store, chunk), 1000)
    before = get_registry().snapshot()
    tasks = OpTasks()
    execute(out_arr, resume=True, callbacks=[tasks])
    delta = get_registry().snapshot_delta(before)
    compare_to_oracle("reliability 5 [repaired store]", read_store(store), expected, "exact")
    seconds = time.perf_counter() - t0
    print(f"reliability 5: chunk {chunk} rotted; the second resume quarantined {delta.get('chunks_quarantined', 0)} "
          f"and ran {tasks.by_op[op]} task(s) of {op} ({dict(tasks.by_op)}); {seconds:.3f} s")
    check(delta.get("chunks_quarantined", 0) == 1 and tasks.by_op[op] == 1,
          f"reliability 5: the second resume quarantined {delta.get('chunks_quarantined', 0)}, ran {tasks.by_op[op]}")
    out["resume"] = dict(seconds=seconds, pending=pending, ran=ran, repaired=tasks.by_op[op])
    timings["5"] = seconds
    return out


def reliability_device_checks(torch, config, work, timings, launches) -> dict:
    """Checks 6-9 on the device executor at full width: resume and
    cancellation, what checksums cost, what the guard costs, and the
    guard's reading without a synchronize against the synchronized one."""
    import zlib

    import cubed_tpu_torch
    from cubed_tpu_torch.backend_array_api import get_device
    from cubed_tpu_torch.core.array import execute
    from cubed_tpu_torch.core.ops import _store_op
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime import memory
    from cubed_tpu_torch.runtime.cancellation import ComputeDeadlineExceededError
    from cubed_tpu_torch.runtime.executors import cuda as cuda_module
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.storage.store import open_zarr_array

    out = {}
    full = config["full"]
    wrappers = kernel_wrappers()
    paths = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops", "eager_fallbacks",
             "batched_errors")

    # 6. resume of the to-Zarr product: whole (the product op skipped), then
    # with one chunk corrupt (quarantined by the scan, the op re-run)
    t0 = time.perf_counter()
    store = os.path.join(work, "product.zarr")
    random.seed(config["seed"])
    expected = product_oracle(full)
    random.seed(config["seed"])
    out_arr = _store_op(product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"]), full),
                        store)
    memory.reset_device_peaks()
    for w in wrappers.values():
        w.launches = 0
    ex = CudaExecutor()
    units = UnitPeaks()
    t = time.perf_counter()
    execute(out_arr, executor=ex, callbacks=[units])
    write_s = time.perf_counter() - t
    cold = {c: ex.stats.get(c, 0) for c in paths}
    launches["product"] = {k: w.launches for k, w in wrappers.items()}
    # the guard's reading of each unit beside the residency budget and the
    # segment's resident inputs (none: its random arrays are drawn in it)
    # and kept outputs (the stored product)
    kept = int(np.prod(out_arr.shape)) * out_arr.dtype.itemsize
    print(f"reliability 6 (the device executor's units, the product's first write): "
          + "; ".join(f"{len(names)} op(s) ({names[0]}...) read {peak} B" for peak, names in units.units.items())
          + f"; residency budget {ex._budget(out_arr.spec, get_device())} B; the segment's resident inputs "
          f"0 B, kept outputs {kept} B (the four random arrays it draws: {4 * int(np.prod(full['shape'])) * 8} B); "
          f"{smi_tag()}")
    check(all(peak is not None for peak in units.units), "reliability 6: a unit without a guard reading")
    first = read_store(store)
    compare_to_oracle("reliability 6 [product store]", first, expected, "exact")
    # vorticity's mean on the same seeds
    expected = float(np.mean(expected))
    runs = {}
    for label, damage in (("whole", None), ("one chunk corrupt", middle_chunk(store))):
        if damage:
            flip_byte(os.path.join(store, damage), 4096)
        ex = CudaExecutor()
        before = get_registry().snapshot()
        t = time.perf_counter()
        execute(out_arr, executor=ex, resume=True)
        seconds = time.perf_counter() - t
        delta = get_registry().snapshot_delta(before)
        counters = {c: ex.stats.get(c, 0) for c in paths}
        valid, corrupt, verified = open_zarr_array(store, mode="r").verify_chunks(quarantine=False)
        same = np.array_equal(read_store(store).view(np.uint64), first.view(np.uint64))
        print(f"reliability 6 (resume, cuda, {label}): {seconds:.3f} s; path counters {json.dumps(counters)}; "
              f"quarantined {delta.get('chunks_quarantined', 0)}; the store verifies: {verified and not corrupt} "
              f"({len(valid)} chunks), equal to the first write: {same}; {smi_tag()}")
        check(same and verified and not corrupt, f"reliability 6 ({label}): the store does not verify")
        # as JaxExecutor's on this plan in the CPU parity test
        # (tests/test_torch_resume.py): a whole store skips the product op
        # alone (the random ops persisted nothing and run again), a corrupt
        # chunk re-runs it: the first compute's counters less one op on one
        # route, or all of them
        fewer = {c: cold[c] - counters[c] for c in paths}
        skipped_one = sorted(fewer.values()) == [0] * (len(paths) - 1) + [1]
        check(skipped_one if damage is None else counters == cold,
              f"reliability 6 ({label}): path counters {counters}, the first compute's {cold}")
        runs[label] = dict(seconds=seconds, counters=counters, quarantined=delta.get("chunks_quarantined", 0))
    del first

    # the deadline: vorticity's cold compute (a first sighting of its plan
    # shape: op by op), then the same with deadline_s at half its time
    def vorticity(seed):
        random.seed(seed)
        return vorticity_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"]), full)

    dev = torch.device("cuda", torch.cuda.current_device())
    cuda_module._SEEN.clear()
    cuda_module._GRAPHS.shrink(dev, 0)
    memory.reset_device_peaks()
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    value = float(vorticity(config["seed"]).compute(executor=CudaExecutor()))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches["vorticity"] = {k: w.launches for k, w in wrappers.items()}
    check(abs(value - expected) <= 1e-12 * abs(expected), f"reliability 6: vorticity {value}, oracle {expected}")
    # the process's first compute of the plan shape paid its one-time costs,
    # and a cold compute's time varies twofold: the cold time the deadline
    # halves is the shortest of three more first sightings
    colds = []
    for _ in range(3):
        cuda_module._SEEN.clear()
        t = time.perf_counter()
        vorticity(config["seed"] + 1).compute(executor=CudaExecutor())
        torch.cuda.synchronize()
        colds.append(time.perf_counter() - t)
    first_s, cold_s = cold_s, min(colds)
    cuda_module._SEEN.clear()
    deadline = cold_s / 2
    arr = vorticity(config["seed"] + 1)
    t = time.perf_counter()
    try:
        arr.compute(executor=CudaExecutor(), deadline_s=deadline)
        raise PhaseFailed(f"reliability 6: a compute with deadline {deadline:.4f} s did not raise")
    except ComputeDeadlineExceededError as e:
        late = time.perf_counter() - t - deadline
        print(f"reliability 6 (deadline): the process's first compute {first_s:.4f} s, cold computes "
              f"{', '.join(f'{c:.4f}' for c in colds)} s; "
              f"deadline_s {deadline:.4f} s raised {type(e).__name__} {late * 1e3:.2f} ms past the deadline (at a "
              f"segment boundary)")
    torch.cuda.synchronize()
    value = float(vorticity(config["seed"]).compute(executor=CudaExecutor()))
    check(abs(value - expected) <= 1e-12 * abs(expected), f"reliability 6: the next compute {value}, oracle {expected}")
    seconds = time.perf_counter() - t0
    print(f"reliability 6: the next compute equals its oracle; {seconds:.3f} s in all")
    out["resume_cancel"] = dict(seconds=seconds, first_write_s=write_s, first_counters=cold, runs=runs,
                                unit_readings={str(k): len(v) for k, v in units.units.items()},
                                first_s=first_s, cold_s=cold_s,
                                deadline_s=deadline, late_ms=late * 1e3)
    timings["6"] = seconds

    # 7. what checksums cost: the product written three times
    t0 = time.perf_counter()
    buf = np.random.default_rng(0).random(8 * 2**20).tobytes()
    t = time.perf_counter()
    zlib.crc32(buf)
    crc_mb_s = len(buf) / 1e6 / (time.perf_counter() - t)
    writes = {}
    for mode, read_back in (("off", False), ("write", False), ("write", True)):
        raw = os.path.join(work, f"raw-{mode}-{read_back}.zarr")
        random.seed(config["seed"])
        arr = product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"], integrity=mode),
                            full)
        t = time.perf_counter()
        cubed_tpu_torch.to_zarr(arr, raw, executor=CudaExecutor())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t
        verify_s = None
        if read_back:
            t = time.perf_counter()
            valid, corrupt, verified = open_zarr_array(raw, mode="r").verify_chunks(quarantine=False)
            verify_s = time.perf_counter() - t
            check(verified and not corrupt and len(valid) == open_zarr_array(raw, mode="r").nchunks,
                  "reliability 7: the verified read-back failed")
        nbytes = sum(os.path.getsize(os.path.join(raw, f)) for f in os.listdir(raw) if not f.startswith("."))
        label = f"integrity={mode}" + (" + verify read-back" if read_back else "")
        writes[label] = dict(write_s=write_s, verify_s=verify_s, bytes=nbytes)
        shutil.rmtree(raw, ignore_errors=True)
    off_s = writes["integrity=off"]["write_s"]
    print(f"reliability 7 (checksums, cuda, {full['shape']}): the host's zlib.crc32 {crc_mb_s:.0f} MB/s; "
          + "; ".join(f"{k}: write {v['write_s']:.3f} s"
                      + (f", verify read-back {v['verify_s']:.3f} s" if v["verify_s"] is not None else "")
                      for k, v in writes.items())
          + f"; CRC of the {writes['integrity=off']['bytes']} B written at {crc_mb_s:.0f} MB/s predicts "
          f"{writes['integrity=off']['bytes'] / 1e6 / crc_mb_s:.3f} s over off's {off_s:.3f} s; {smi_tag()}")
    seconds = time.perf_counter() - t0
    out["checksums"] = dict(seconds=seconds, crc_mb_s=crc_mb_s, writes=writes)
    timings["7"] = seconds

    # 8. what the guard costs: vorticity's warm (replayed) compute, guard off
    # and observe in turns
    t0 = time.perf_counter()
    arrays = {}
    for mode in ("off", "observe"):
        random.seed(config["seed"] + 3)
        arrays[mode] = vorticity_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"],
                                                            memory_guard=mode), full)
    ex = CudaExecutor()
    for _ in range(2):  # the first sighting, then the capture
        for mode in ("off", "observe"):
            arrays[mode].compute(executor=ex)
    times = {"off": [], "observe": []}
    for i in range(config["guard_turns"]):
        for mode in (("off", "observe") if i % 2 == 0 else ("observe", "off")):
            t = time.perf_counter()
            arrays[mode].compute(executor=ex)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t)
            check(ex.stats.get("segment_struct_hits", 0) == 1, f"reliability 8: a {mode} compute did not replay")
    q = {m: [float(np.percentile(v, p)) for p in (25, 50, 75)] for m, v in times.items()}
    diff = q["observe"][1] - q["off"][1]
    limit = max(1e-3, 0.05 * q["off"][1])
    print(f"reliability 8 (the guard's cost, cuda, warm vorticity, {config['guard_turns']} each in turns): "
          f"off median {q['off'][1] * 1e3:.3f} ms (quartiles {q['off'][0] * 1e3:.3f}-{q['off'][2] * 1e3:.3f}), "
          f"observe median {q['observe'][1] * 1e3:.3f} ms (quartiles {q['observe'][0] * 1e3:.3f}-"
          f"{q['observe'][2] * 1e3:.3f}); difference {diff * 1e3:.3f} ms, the observers' limit {limit * 1e3:.3f} ms: "
          f"{'within' if diff <= limit else 'NOT within'}; {smi_tag()}")
    seconds = time.perf_counter() - t0
    out["guard_cost"] = dict(seconds=seconds, quartiles_ms={m: [x * 1e3 for x in v] for m, v in q.items()},
                             diff_ms=diff * 1e3, limit_ms=limit * 1e3)
    timings["8"] = seconds

    # 9. the guard reads the allocator without synchronizing: each unit's
    # reading against the synchronized reading at the same points, for
    # every kind of unit: vorticity's cold (op by op), capturing and
    # replayed computes, a matmul plan's ops each eager (a cuBLAS product
    # in each), and a unit that frees a block used on a side stream
    # (record_stream) before it allocates another
    t0 = time.perf_counter()
    units: dict = {}
    cuda_module._SEEN.clear()
    cuda_module._GRAPHS.shrink(dev, 0)
    ex = CudaExecutor()
    for i, kind in enumerate(("cold", "capturing", "replayed")):
        with guard_readings(torch) as rows:
            vorticity(config["seed"] + 20 + i).compute(executor=ex)
        units[kind] = rows
        check(ex.stats.get("segments_compiled", 0) == (kind == "capturing")
              and ex.stats.get("segment_struct_hits", 0) == (kind == "replayed"),
              f"reliability 9: the {kind} compute's segment counters {dict(ex.stats)}")
    random.seed(config["seed"])
    product = matmul_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"]))
    with guard_readings(torch) as rows:
        product.compute(executor=CudaExecutor(fuse_plan=False))
    units["eager, cuBLAS"] = rows
    nbytes = 64 * 2**20
    with memory.scoped("observe", allowed_mem=10**12), guard_readings(torch) as rows:
        with memory.task_guard("record_stream", observe_only=True):
            x = torch.ones(nbytes // 8, dtype=torch.float64, device=dev)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                y = x * 2.0
                for _ in range(50):
                    y.mul_(1.0)
            x.record_stream(side)
            del x
            z = torch.full((nbytes // 8,), 3.0, dtype=torch.float64, device=dev)
            del z
            torch.cuda.current_stream().wait_stream(side)
            del y
    units["record_stream"] = rows
    for kind, rows in units.items():
        same = sum(r == synced and base for _, r, synced, base in rows)
        print(f"reliability 9 (the guard's reading without a synchronize, cuda, {kind}): {len(rows)} unit(s) "
              + ", ".join(f"{key[:40]} {r} B" for key, r, _, _ in rows[:4]) + f"; equal to the synchronized "
              f"reading at the same points in {same} of {len(rows)}")
        check(rows and same == len(rows), f"reliability 9 ({kind}): readings differ: "
              f"{[row for row in rows if row[1] != row[2] or not row[3]][:3]}")
    seconds = time.perf_counter() - t0
    out["unsynced_readings"] = {k: len(v) for k, v in units.items()}
    timings["9"] = seconds
    return out


def run_reliability_phase(torch, config=RELIABILITY) -> dict:
    """The reliability phase (see the module docstring); returns its
    numbers, printed as they come."""
    started = time.perf_counter()
    work = os.path.join(WORK_DIR, "reliability")
    timings: dict = {}
    launches: dict = {}
    out = {}
    shutil.rmtree(work, ignore_errors=True)
    try:
        out.update(reliability_guard_checks(torch, config, work, timings))
        shutil.rmtree(work, ignore_errors=True)
        out.update(reliability_store_checks(torch, config, work, timings))
        shutil.rmtree(work, ignore_errors=True)
        out.update(reliability_device_checks(torch, config, work, timings, launches))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - started
    print(f"reliability phase: {seconds:.1f} s (" + ", ".join(f"check {k} {v:.1f} s" for k, v in timings.items())
          + f"); launches {json.dumps(launches)}; {smi_tag()}")
    return dict(out, seconds=seconds, timings=timings, launches=launches)


# ---------------------------------------------------------------------------
# the threaded executor: AsyncPythonDagExecutor with the chunk-level dataflow
# scheduler, speculative backups and the compute journal
# ---------------------------------------------------------------------------

#: the threads phase, in a process of its own (``--threads-phase``):
#: vorticity at full width (config 5) and at the spilled cut (200, 180, 160)
#: / 40, where each of 921 tasks takes about 9 ms of fsync'd writes; the
#: chaos and journal checks at the reliability phase's sequential cut (160,
#: 160, 120) / 40 (447 tasks). ``rounds`` is check 6's timing rounds. Alone
#: the phase takes 3 rounds at the spilled cut; the whole run
#: (``THREADS_WHOLE_RUN``) takes 1 round, checks 2, 3 and 6 at the
#: smaller cut, and check 1 under dataflow alone (oplevel stays checked at
#: the cut by check 2), to stay near its 1050 s aim (PERF.md §5)
THREADS = dict(full=VORTICITY, cut=SPILL, small=RELIABILITY["seq"], allowed_mem="2GB", seed=SEED,
               workers=(1, 4, 8), timing_workers=(1, 4, 8, 16), rounds=3, full_workers=8,
               full_modes=("dataflow", "oplevel"), names=916_000_000,
               faults=dict(seed=16, storage_write_failure_rate=0.05, storage_write_leaves_tmp=True,
                           task_failure_rate=0.05, straggler_rate=0.02, straggler_delay_s=1.0),
               cancel_after=12)
THREADS_WHOLE_RUN = dict(rounds=1, cut=RELIABILITY["seq"], full_modes=["dataflow"])
#: the kernels whose launches the threads phase counts (their per-block and
#: chunked routes: the threaded executor runs each task's block function)
THREADS_LAUNCHES = ("philox_uniform", "philox_uniform:block", "region_sum", "fma_sum_blocks")


class StatsCapture:
    """The compute's ``executor_stats``, kept at its end."""

    stats: dict = {}

    def on_compute_end(self, event):
        self.stats = event.executor_stats or {}


def counted_compute(torch, arr, executor, callbacks=(), **kwargs) -> tuple:
    """``arr.compute(executor=...)`` with every kernel's count set to 0 just
    before and read just after: (value, seconds, launches, executor_stats)."""
    wrappers = kernel_wrappers()
    zero_launches()
    cap = StatsCapture()
    t = time.perf_counter()
    value = arr.compute(executor=executor, callbacks=[cap, *callbacks], **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["philox_uniform:block"] = wrappers["philox_uniform"].paths["block"]
    return value, seconds, {k: launches[k] for k in THREADS_LAUNCHES}, cap.stats


def threads_executor(workers: int, **kw):
    from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor

    return AsyncPythonDagExecutor(max_workers=workers, **kw)


def vorticity_arr(config, work, seed, **spec_kw):
    import cubed_tpu_torch

    random.seed(seed)
    spec = cubed_tpu_torch.Spec(work_dir=work, **dict(dict(allowed_mem="2GB"), **spec_kw))
    return vorticity_build(spec, config)


@contextlib.contextmanager
def guard_readings(torch):
    """While active, each guarded task's or unit's device reading (taken
    without a synchronization) is recorded with the synchronized reading at
    the same points: at entry, a synchronize and the bytes allocated; at
    exit, a synchronize and the allocator's peak less that start (the peak
    statistics having been reset where the unit's window opened, as they
    were at every task when the guard reset at each). Yields a list of
    ``(key, reading, synced, base_equal)``, in the order the units ended."""
    from cubed_tpu_torch.runtime import memory

    start_inner, end_inner = memory._start_device_reading, memory._end_device_reading
    exit_inner = memory.task_guard.__exit__
    local = threading.local()
    rows: list = []
    rows_lock = threading.Lock()

    def start(dev):
        base = start_inner(dev)
        torch.cuda.synchronize(dev)
        local.synced_start = torch.cuda.memory_allocated(dev)
        local.base = base
        return base

    def end(dev, base):
        reading = end_inner(dev, base)
        torch.cuda.synchronize(dev)
        local.synced = torch.cuda.max_memory_allocated(dev) - local.synced_start
        return reading

    def exit_(self, *exc):
        try:
            return exit_inner(self, *exc)
        finally:
            if self.device_measured is not None:
                with rows_lock:
                    rows.append((self._key, self.device_measured, local.synced,
                                 local.base == local.synced_start))

    memory._start_device_reading, memory._end_device_reading = start, end
    memory.task_guard.__exit__ = exit_
    try:
        yield rows
    finally:
        memory._start_device_reading, memory._end_device_reading = start_inner, end_inner
        memory.task_guard.__exit__ = exit_inner


def journal_frontier(arr, path: str, op_granular: bool = False) -> dict:
    """What a resume of *arr* from the journal at *path* must run: op ->
    tasks, for every op whose tasks are not all both journaled complete and
    verified on disk (each output chunk read back against the checksum
    manifest); op-granular, an op runs whole or not at all. Computed from
    the journal file and the stores, apart from the executors' resume."""
    from cubed_tpu_torch.core.plan import iter_op_nodes
    from cubed_tpu_torch.runtime.journal import load_journal
    from cubed_tpu_torch.runtime.pipeline import _task_chunk_key
    from cubed_tpu_torch.runtime.utils import chunk_key
    from cubed_tpu_torch.storage.store import open_zarr_array

    completed = load_journal(path)["completed"]
    dag = arr.plan._finalize(optimize_graph=False, array_names=(arr.name,)).dag
    out = {}
    for name, node in iter_op_nodes(dag):
        op = node["primitive_op"]
        if name == "create-arrays":
            out[name] = op.num_tasks
            continue
        valid = set()
        try:
            valid, _corrupt, _verified = open_zarr_array(op.target_array.store, mode="r").verify_chunks(
                quarantine=False, count=False)
        except FileNotFoundError:
            pass
        pending = [m for m in op.pipeline.mappable
                   if not ((name, chunk_key(m)) in completed and _task_chunk_key(m) in valid)]
        if pending:
            out[name] = op.num_tasks if op_granular else len(pending)
    return out


def threads_values(torch, config, work, timings, sequential_full, out) -> dict:
    """Checks 1 and 2: values, launches and overlap on the schedulers of
    ``full_modes`` at full width and on oplevel at the cut (after check 6,
    whose first run is the cut's sequential one)."""
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor

    full, cut = config["full"], config["cut"]
    # 1. full width on 8 threads, each scheduler: the oracle at rtol 1e-12,
    # the launches the sequential executor's on the same plan
    t0 = time.perf_counter()
    expected = cached_oracle(f"vorticity {full['shape']}", lambda: vorticity_oracle(full), config["seed"])
    if sequential_full is None:
        value, seconds, sequential_full, _ = counted_compute(
            torch, vorticity_arr(full, work, config["seed"]), PythonDagExecutor())
        print(f"threads 1: the sequential executor's launches on the full-width plan {json.dumps(sequential_full)} "
              f"({seconds:.3f} s)")
    runs = {}
    for mode in config["full_modes"]:
        arr = vorticity_arr(full, work, config["seed"], scheduler=mode)
        value, seconds, launches, stats = counted_compute(torch, arr, threads_executor(config["full_workers"]))
        rel = abs(float(value) - expected) / abs(expected)
        early = stats.get("tasks_dispatched_early", 0)
        print(f"threads 1 ({mode}, {config['full_workers']} workers) {full['shape']} / {full['chunks']}: "
              f"{seconds:.3f} s; rel err {rel:.3e}; launches {json.dumps(launches)} (sequential "
              f"{json.dumps(sequential_full)}); tasks {stats.get('tasks_completed', 0)}, dispatched early {early}, "
              f"op barrier waits {stats.get('op_barrier_waits', 0)}; {smi_tag()}")
        check(rel <= 1e-12, f"threads 1 ({mode}): rel err {rel}")
        check(launches == sequential_full, f"threads 1 ({mode}): launches {launches}, sequential {sequential_full}")
        check(mode == "oplevel" or early > 0, "threads 1: no task dispatched early under dataflow")
        runs[mode] = dict(seconds=seconds, rel=rel, launches=launches, early=early)
    out["full"] = dict(runs, sequential_launches=sequential_full)
    timings["1"] = time.perf_counter() - t0

    # 2. the spilled cut, bitwise against the sequential executor (check
    # 6's first run) at 1, 4 and 8 workers on both schedulers: check 6's
    # dataflow runs, and here the oplevel ones
    t0 = time.perf_counter()
    value, launches = out["cut_sequential"]["value"], out["cut_sequential"]["launches"]
    for workers in config["workers"]:
        v, s, lc, _ = counted_compute(torch, vorticity_arr(cut, work, config["seed"], scheduler="oplevel"),
                                      threads_executor(workers))
        same = float(v).hex() == value
        print(f"threads 2 (oplevel, {workers} workers) {cut['shape']} / {cut['chunks']}: {s:.3f} s; "
              f"{float(v).hex()} against the sequential {value}: {'equal' if same else 'DIFFERENT'}; "
              f"launches {json.dumps(lc)}")
        check(same and lc == launches, f"threads 2 (oplevel, {workers}): value or launches differ")
    timings["2"] = time.perf_counter() - t0
    return out


def threads_guard(torch, config, work, timings, sequential_value: str) -> dict:
    """Check 3: the guard at the plan's bound under enforce, at 1 and 8
    workers, each value bit for bit the sequential executor's."""
    from cubed_tpu_torch.runtime.resilience import RetryPolicy

    t0 = time.perf_counter()
    cut = config["cut"]
    bound = vorticity_arr(cut, work, config["seed"]).plan.max_projected_mem()
    arr = vorticity_arr(cut, work, config["seed"], allowed_mem=bound, reserved_mem=0, memory_guard="enforce")
    readings, out = {}, {}
    for workers in (1, 8):
        with guard_readings(torch) as rows:
            value, seconds, _, stats = counted_compute(
                torch, arr, threads_executor(workers, retry_policy=RetryPolicy(retries=10, backoff_base=0.0, seed=0)))
        last = {}
        for key, reading, synced, base_equal in rows:
            last[key] = (reading, synced, base_equal)
        readings[workers] = last
        counters = {k: stats.get(k, 0) for k in ("tasks_throttled", "mem_pressure_stepdowns",
                                                 "mem_guard_hard_exceeded", "task_retries", "tasks_completed")}
        equal = sum(r == s and b for r, s, b in last.values())
        print(f"threads 3 (enforce at the plan's bound {bound} B, {workers} workers) {cut['shape']} / "
              f"{cut['chunks']}: {seconds:.3f} s; {len(rows)} guarded attempts, {len(last)} tasks; readings equal "
              f"to the synchronized reading at the same points in {equal} of {len(last)}; largest "
              f"{max(r for r, _, _ in last.values())} B; {json.dumps(counters)}; {smi_tag()}")
        check(float(value).hex() == sequential_value, f"threads 3 ({workers}): the value differs")
        if workers == 1:
            check(equal == len(last), "threads 3: at one worker a reading differs from the reset-based one")
        out[workers] = dict(seconds=seconds, tasks=len(last), equal=equal, **counters)
    below = [k for k, (r, _, _) in readings[8].items() if r < readings[1][k][0]]
    higher = sum(r > readings[1][k][0] for k, (r, _, _) in readings[8].items())
    print(f"threads 3: at 8 workers {higher} of {len(readings[8])} readings above their one-worker reading, "
          f"{len(below)} below")
    check(set(readings[8]) == set(readings[1]) and not below,
          f"threads 3: readings below their one-worker reading: {below[:4]}")
    out["above_one_worker"] = higher
    timings["3"] = time.perf_counter() - t0
    return out


def threads_chaos(torch, config, work, timings) -> dict:
    """Check 4: seeded storage and task faults with speculative backups;
    the store bit for bit the fault-free one's."""
    import cubed_tpu_torch
    from cubed_tpu_torch.core.array import execute
    from cubed_tpu_torch.core.ops import _store_op
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime import faults
    from cubed_tpu_torch.runtime.faults import FaultConfig
    from cubed_tpu_torch.runtime.resilience import RetryPolicy

    t0 = time.perf_counter()
    cut = config["small"]
    clean = os.path.join(work, "clean.zarr")
    random.seed(config["seed"])
    cubed_tpu_torch.to_zarr(product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB"), cut), clean,
                            executor=threads_executor(8))
    chaos = os.path.join(work, "chaos.zarr")
    random.seed(config["seed"])
    with pinned_names(config["names"]):
        out_arr = _store_op(product_build(cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", integrity="verify"),
                                          cut), chaos)
    executor = threads_executor(8, use_backups=True, retry_policy=RetryPolicy(retries=6, backoff_base=0.0, seed=0))
    before = get_registry().snapshot()
    with faults.scoped(FaultConfig(**config["faults"])):
        execute(out_arr, executor=executor, optimize_graph=False)
    # nothing reads the output store in the compute: a resume with the
    # faults disarmed verifies it
    repaired = OpTasks()
    execute(out_arr, executor=executor, optimize_graph=False, resume=True, callbacks=[repaired])
    delta = get_registry().snapshot_delta(before)
    counters = {k: delta.get(k, 0) for k in ("faults_injected", "faults_injected_storage_write",
                                              "faults_injected_task", "faults_injected_straggler", "task_retries",
                                              "speculative_backups", "tasks_dispatched_early",
                                              "tasks_skipped_resume")}
    same = np.array_equal(read_store(chaos).view(np.uint64), read_store(clean).view(np.uint64))
    seconds = time.perf_counter() - t0
    print(f"threads 4 (chaos, 8 workers, backups, verify, retries=6) {cut['shape']} / {cut['chunks']}: "
          f"{seconds:.3f} s; {json.dumps(counters)}; the resume ran {json.dumps(dict(repaired.by_op))}; the store "
          f"{'equals' if same else 'DIFFERS FROM'} the fault-free one bit for bit; {smi_tag()}")
    check(same, "threads 4: the chaos store differs from the fault-free store")
    for k in ("faults_injected", "task_retries", "speculative_backups"):
        check(counters[k] > 0, f"threads 4: {k} is {counters[k]}")
    timings["4"] = seconds
    return dict(seconds=seconds, **counters)


def threads_journal(torch, config, work, timings) -> dict:
    """Check 5: a journaled compute cancelled partway, resumed from its
    journal on threads (chunk-granular) and on ``CudaExecutor``
    (op-granular)."""
    import cubed_tpu_torch
    from cubed_tpu_torch.core.array import execute
    from cubed_tpu_torch.core.ops import _store_op
    from cubed_tpu_torch.runtime.cancellation import CancellationToken, ComputeCancelledError
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    t0 = time.perf_counter()
    cut = config["small"]
    random.seed(config["seed"])
    expected = product_oracle(cut)
    out = {}
    for name in ("threads", "cuda"):
        store = os.path.join(work, f"journal-{name}.zarr")
        path = os.path.join(work, f"{name}.journal.jsonl")
        random.seed(config["seed"])
        arr = _store_op(product_build(cubed_tpu_torch.Spec(work_dir=os.path.join(work, name), allowed_mem="2GB",
                                                           journal=path), cut), store)
        op, _tasks, _create = store_writer(arr, store)
        token = CancellationToken()
        try:
            execute(arr, executor=threads_executor(8), optimize_graph=False, cancellation=token,
                    callbacks=[CancelAfter(token, op, config["cancel_after"])])
            raise PhaseFailed("threads 5: the cancelled compute did not raise")
        except ComputeCancelledError:
            pass
        frontier = journal_frontier(arr, path, op_granular=name == "cuda")
        ran = OpTasks()
        execute(arr, executor=threads_executor(8) if name == "threads" else CudaExecutor(), optimize_graph=False,
                resume_from_journal=path, callbacks=[ran])
        compare_to_oracle(f"threads 5 [{name}]", read_store(store), expected, "exact")
        print(f"threads 5 (journal, cancelled after {config['cancel_after']} tasks of {op}, resumed on {name}): "
              f"the resume ran {json.dumps(dict(ran.by_op))}; not both journaled and verified "
              f"{json.dumps(frontier)}")
        check(dict(ran.by_op) == frontier, f"threads 5 ({name}): the resume ran {dict(ran.by_op)}, "
              f"the frontier {frontier}")
        out[name] = dict(ran=sum(ran.by_op.values()), ops=len(ran.by_op))
    timings["5"] = time.perf_counter() - t0
    return out


def threads_timings(torch, config, work, timings) -> dict:
    """Check 6: wall times in turns, ``rounds`` rounds: the sequential
    executor against threads (dataflow) at 1, 4, 8 and 16 workers on the
    spilled cut, each value and its launches bit for bit the first
    sequential run's (check 2's dataflow runs); and threads at 8 workers at
    full width, whose last round check 1 takes. Returns the times and that
    first sequential run."""
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor

    t0 = time.perf_counter()
    cut, full = config["cut"], config["full"]
    arr = vorticity_arr(cut, work, config["seed"])
    settings = ["sequential"] + [f"threads {w}" for w in config["timing_workers"]]
    times = {s: [] for s in settings}
    sequential = None
    for r in range(config["rounds"]):
        for setting in (settings if r % 2 == 0 else list(reversed(settings))):
            executor = PythonDagExecutor() if setting == "sequential" else threads_executor(int(setting.split()[1]))
            value, seconds, launches, _ = counted_compute(torch, arr, executor)
            times[setting].append(seconds)
            if sequential is None:
                sequential = dict(value=float(value).hex(), launches=launches)
            check(float(value).hex() == sequential["value"] and launches == sequential["launches"],
                  f"threads 2 ({setting}, dataflow): value {float(value).hex()} or launches {launches} differ "
                  f"from the sequential {sequential['value']}, {sequential['launches']}")
    full_arr = vorticity_arr(full, work, config["seed"])
    times["threads 8, full width"] = [counted_compute(torch, full_arr, threads_executor(8))[1]
                                      for _ in range(config["rounds"] - 1)]
    timings["6"] = time.perf_counter() - t0
    return dict(times=times, sequential=sequential)


def print_threads_timings(config, times: dict) -> dict:
    cut, full = config["cut"], config["full"]
    for setting, v in times.items():
        where = full if "full" in setting else cut
        print(f"threads 6 ({setting}) {where['shape']} / {where['chunks']}: "
              + ", ".join(f"{x:.3f}" for x in v) + f" s (median {float(np.median(v)):.3f}); {smi_tag()}")
    return {k: [float(x) for x in v] for k, v in times.items()}


def run_threads_phase(torch, config=THREADS, sequential_full=None) -> dict:
    """The threads phase (see the module docstring); returns its numbers,
    printed as they come."""
    started = time.perf_counter()
    work = os.path.join(WORK_DIR, "threads")
    timings: dict = {}
    out = {}
    shutil.rmtree(work, ignore_errors=True)
    try:
        six = threads_timings(torch, config, work, timings)
        out["cut_sequential"] = dict(six["sequential"], seconds=six["times"]["sequential"][0])
        threads_values(torch, config, work, timings, sequential_full, out)
        six["times"]["threads 8, full width"].append(out["full"]["dataflow"]["seconds"])
        out["timings_s"] = print_threads_timings(config, six["times"])
        shutil.rmtree(work, ignore_errors=True)
        out["guard"] = threads_guard(torch, config, work, timings, out["cut_sequential"]["value"])
        shutil.rmtree(work, ignore_errors=True)
        out["chaos"] = threads_chaos(torch, config, work, timings)
        shutil.rmtree(work, ignore_errors=True)
        out["journal"] = threads_journal(torch, config, work, timings)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - started
    print(f"threads phase: {seconds:.1f} s (" + ", ".join(f"check {k} {v:.1f} s" for k, v in sorted(timings.items()))
          + f"); launches at full width {json.dumps(out['full']['dataflow']['launches'])}; {smi_tag()}")
    return dict(out, seconds=seconds, timings=timings, launches=out["full"]["dataflow"]["launches"])


# ---------------------------------------------------------------------------
# the fleet phase: the process pool and the TCP fleet on this card
# ---------------------------------------------------------------------------

#: the fleet phase, in a process of its own (``--fleet-phase``): one pool
#: compute, vorticity at full width under ``enforce`` at the plan's bound
#: with a worker SIGKILLed after ``pool_kill_after`` of its 921 tasks (a
#: pool pays its workers' start, 12-18 s, in every compute, so the pool's
#: checks share one); then the fleet of as many workers at full width and
#: at the reliability phase's cut (the bit-for-bit, guard, rechunk and kill
#: checks); one CUDA context a worker on the one card
FLEET = dict(full=VORTICITY, cut=RELIABILITY["seq"], seed=SEED, workers=4, threads=4, pool_kill_after=800,
             fleet_kill_after=60, rechunk=(160, 20, 120), peer_faults=dict(seed=18, peer_corrupt_rate=0.3))
#: the kernels whose worker launches check 1 sums against the sequential run's
FLEET_LAUNCHES = ("philox_uniform", "region_sum", "fma_sum_blocks")


class TaskLog:
    """Each completed task's guard reading, and when the first ended."""

    def __init__(self, on_end=None):
        self.readings: list = []
        self.first_end: Optional[float] = None
        self.on_end = on_end

    def on_task_end(self, event):
        if self.first_end is None:
            self.first_end = time.perf_counter()
        self.readings.append(event.guard_mem_peak)
        if self.on_end is not None:
            self.on_end(len(self.readings))


def child_pids() -> list:
    """This process's live children: (pid, command line)."""
    me = os.getpid()
    out = []
    for tid in os.listdir(f"/proc/{me}/task"):
        try:
            with open(f"/proc/{me}/task/{tid}/children") as f:
                pids = [int(p) for p in f.read().split()]
        except OSError:
            continue
        for pid in pids:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read()
                with open(f"/proc/{pid}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if state != "Z":
                out.append((pid, cmd))
    return out


def pool_worker_pids() -> list:
    """The live process-pool workers among this process's children."""
    return [pid for pid, cmd in child_pids() if b"spawn_main" in cmd]


def live_children() -> list:
    """This process's live children, multiprocessing's resource tracker
    (which lives as long as this process, by design) aside."""
    return [pid for pid, cmd in child_pids() if b"resource_tracker" not in cmd]


def fleet_compute(torch, arr, executor, log=None) -> tuple:
    """``arr.compute(executor=...)`` with this process's kernel counts set
    to 0 just before and read just after: (value, seconds, this process's
    launches, executor_stats)."""
    value, seconds, launches, stats = counted_compute(torch, arr, executor, callbacks=[log] if log else ())
    return value, seconds, {k: v for k, v in launches.items() if k in FLEET_LAUNCHES}, stats


def worker_launches(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in FLEET_LAUNCHES}


def check_workers(label: str, reports: dict, expected: int) -> None:
    """Every worker ran on the card and launched a kernel."""
    devices = {name: r["device"] for name, r in reports.items()}
    launched = {name: sum(r["launches"].values()) for name, r in reports.items()}
    print(f"{label}: workers {json.dumps(devices)}, tasks "
          f"{json.dumps({n: r['tasks'] for n, r in reports.items()})}, launches {json.dumps(launched)}")
    check(len(reports) >= expected, f"{label}: {len(reports)} workers reported, {expected} expected")
    check(all(d.startswith("cuda") for d in devices.values()), f"{label}: a worker not on cuda: {devices}")
    check(all(n > 0 for n in launched.values()), f"{label}: a worker launched nothing: {launched}")


def fleet_yardsticks(torch, config, work, given: dict) -> dict:
    """What the phase holds its executors to: the numpy oracle at full
    width (``expected``), the sequential executor's value and launches
    there (``full_sequential``), its value and time at the cut
    (``cut_sequential``) and 4 threads' time there (``cut_threads_s``). The
    whole run passes them on from phase 4 and the threads phase (the same
    plans and seed on the same card); alone the phase computes them."""
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor

    full, cut, seed = config["full"], config["cut"], config["seed"]
    out = dict(given)
    if "expected" not in out:
        out["expected"] = cached_oracle(f"vorticity {full['shape']}", functools.partial(vorticity_oracle, full), seed)
    if "full_sequential" not in out:
        value, seconds, launches, _ = fleet_compute(torch, vorticity_arr(full, work, seed), PythonDagExecutor())
        out["full_sequential"] = dict(value=float(value).hex(), launches=launches)
        print(f"fleet: the sequential executor on the full-width plan: {float(value).hex()}, launches "
              f"{json.dumps(launches)} ({seconds:.3f} s)")
    if "cut_sequential" not in out:
        value, seconds, _, _ = fleet_compute(torch, vorticity_arr(cut, work, seed), PythonDagExecutor())
        out["cut_sequential"] = dict(value=float(value).hex(), seconds=seconds)
        v, out["cut_threads_s"], _, _ = fleet_compute(torch, vorticity_arr(cut, work, seed),
                                                      threads_executor(config["threads"]))
        check(float(v).hex() == out["cut_sequential"]["value"], "fleet: 4 threads differ from the sequential")
    return out


def guarded(torch, config, where: str, work: str, log, ex) -> tuple:
    """Vorticity at *where* ("full" or "cut") under ``enforce`` at its
    plan's bound on *ex*: (value, seconds, this process's launches, stats,
    bound). Each task's guard reading, taken in its worker, is held within
    the bound, and no attempt may have crossed it (check 5)."""
    shape = config[where]
    bound = vorticity_arr(shape, work, config["seed"]).plan.max_projected_mem()
    arr = vorticity_arr(shape, work, config["seed"], allowed_mem=bound, reserved_mem=0, memory_guard="enforce")
    value, seconds, here, stats = fleet_compute(torch, arr, ex, log)
    largest = max(r or 0 for r in log.readings)
    over = stats.get("mem_guard_hard_exceeded", 0)
    print(f"fleet 5 ({ex.name}, {where}, enforce at the plan's bound {bound} B): {len(log.readings)} tasks, guard "
          f"readings taken in the workers, largest {largest} B ({largest / bound:.4f} of the bound), "
          f"{sum(r is None for r in log.readings)} unread; attempts over the bound {over}, retries "
          f"{stats.get('task_retries', 0)}, step-downs {stats.get('mem_pressure_stepdowns', 0)}")
    check(all(r is not None for r in log.readings), f"fleet 5 ({ex.name}): a task without a guard reading")
    check(largest <= bound, f"fleet 5 ({ex.name}): a reading {largest} B over the bound {bound} B")
    check(over == 0, f"fleet 5 ({ex.name}): {over} attempts over the bound")
    return value, seconds, here, stats, dict(largest=largest, bound=bound, tasks=len(log.readings), over_bound=over)


def fleet_pool(torch, config, work, ys, out) -> None:
    """Checks 1, 2, 3 and 5 on the pool, in one compute: vorticity at full
    width under ``enforce`` at the plan's bound, a worker SIGKILLed after
    ``pool_kill_after`` tasks; the value at rtol 1e-12 of the oracle and bit
    for bit the sequential executor's, the workers' launches summed equal
    to its launches, the pool rebuilt with half its workers."""
    import signal

    from cubed_tpu_torch.observability.collect import decisions_since
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime.executors.multiprocess import MultiprocessDagExecutor

    full, workers = config["full"], config["workers"]
    sequential = ys["full_sequential"]
    killed: list = []

    def kill_a_worker(n):
        if n == config["pool_kill_after"] and not killed:
            victims = pool_worker_pids()
            if victims:
                os.kill(victims[0], signal.SIGKILL)
                killed.append(victims[0])

    reg = get_registry()
    ex = MultiprocessDagExecutor(max_workers=workers)
    log = TaskLog(kill_a_worker)
    before, t_dec, t0 = reg.snapshot(), time.time(), time.perf_counter()
    value, seconds, here, _, guard = guarded(torch, config, "full", work, log, ex)
    delta = reg.snapshot_delta(before)
    rebuilds = [d for d in decisions_since(t_dec) if d["kind"] == "pool_rebuild"]
    rel = abs(float(value) - ys["expected"]) / abs(ys["expected"])
    summed = worker_launches({}, ex.stats["worker_launches"])
    expected_launches = {k: sequential["launches"][k] for k in FLEET_LAUNCHES}
    print(f"fleet 1, 2, 3 (pool of {workers}) {full['shape']} / {full['chunks']}: {seconds:.3f} s, first task ended "
          f"{log.first_end - t0:.3f} s in; worker {killed} SIGKILLed after {config['pool_kill_after']} tasks: "
          f"pool_rebuilds {delta.get('pool_rebuilds', 0)}, worker_oom_kills {delta.get('worker_oom_kills', 0)}, "
          f"rebuilt with {[d.get('workers') for d in rebuilds]} workers (exit codes "
          f"{[d.get('exitcodes') for d in rebuilds]}); {float(value).hex()} against the sequential "
          f"{sequential['value']}, rel err {rel:.3e}; workers' launches {json.dumps(summed)} (sequential "
          f"{json.dumps(expected_launches)}); this process's {json.dumps(here)}; {smi_tag()}")
    check(rel <= 1e-12, f"fleet 1 (pool): rel err {rel}")
    check(float(value).hex() == sequential["value"], "fleet 2 (pool): the value differs from the sequential")
    check(summed == expected_launches, f"fleet 1 (pool): workers' launches {summed}, sequential {expected_launches}")
    check(sum(here.values()) == 0, f"fleet 1 (pool): kernels launched in the client {here}")
    check_workers("fleet 1 (pool)", ex.stats["workers"], workers)
    check(bool(killed), "fleet 3: no pool worker found to kill")
    check(delta.get("pool_rebuilds", 0) >= 1, "fleet 3: the pool was not rebuilt")
    check(rebuilds and rebuilds[0].get("workers") == workers // 2, f"fleet 3: rebuilt pool {rebuilds}")
    out["pool"] = dict(seconds=seconds, rel=rel, launches=summed, first_task_s=log.first_end - t0, guard=guard,
                       rebuilds=delta.get("pool_rebuilds", 0), workers_after=rebuilds[0].get("workers"))


def fleet_values(torch, config, work, ys, fl, out) -> None:
    """Checks 1, 2 and 5 on the fleet: vorticity at full width (the oracle
    at rtol 1e-12, the workers' launches summed equal to the sequential
    run's), then the cut under ``enforce`` at its plan's bound, bit for bit
    the sequential executor's."""
    full, workers = config["full"], config["workers"]
    sequential = {k: ys["full_sequential"]["launches"][k] for k in FLEET_LAUNCHES}
    before = dict(fl.stats["worker_launches"])
    value, seconds, here, stats = fleet_compute(torch, vorticity_arr(full, work, config["seed"]), fl)
    rel = abs(float(value) - ys["expected"]) / abs(ys["expected"])
    summed = worker_launches(before, fl.stats["worker_launches"])
    print(f"fleet 1 (fleet of {workers}) {full['shape']} / {full['chunks']}: {seconds:.3f} s; rel err {rel:.3e}; "
          f"workers' launches {json.dumps(summed)}; this process's {json.dumps(here)}; tasks sent "
          f"{fl.stats['tasks_sent']}; peer hits {stats.get('peer_hits', 0)}; {smi_tag()}")
    check(rel <= 1e-12, f"fleet 1 (fleet): rel err {rel}")
    check(summed == sequential, f"fleet 1 (fleet): workers' launches {summed}, sequential {sequential}")
    check(sum(here.values()) == 0, f"fleet 1 (fleet): kernels launched in the client {here}")
    check_workers("fleet 1 (fleet)", fl.stats["worker_reports"], workers)
    out["fleet_full"] = dict(seconds=seconds, rel=rel, launches=summed)

    cut, value_cut = config["cut"], ys["cut_sequential"]["value"]
    value, seconds, _, _, guard = guarded(torch, config, "cut", work, TaskLog(), fl)
    print(f"fleet 2 (fleet of {workers}) {cut['shape']} / {cut['chunks']}: {seconds:.3f} s; {float(value).hex()} "
          f"against the sequential {value_cut}; {smi_tag()}")
    check(float(value).hex() == value_cut, "fleet 2 (fleet): the value differs from the sequential")
    out["fleet_cut"] = dict(seconds=seconds, guard=guard)
    out["round_s"] = {"sequential": ys["cut_sequential"]["seconds"], f"threads {config['threads']}":
                      ys["cut_threads_s"], f"fleet {workers}": seconds}
    print("fleet 7: one round at the cut (s): " + ", ".join(f"{k} {v:.3f}" for k, v in out["round_s"].items())
          + f" (the pool's one compute is check 1's at full width, {out['pool']['seconds']:.3f} s with a worker "
          f"killed); {smi_tag()}")


def fleet_peer(torch, config, work, fl, out) -> None:
    """Check 4: a rechunk of the cut on the fleet reads peers, equal to a
    store-only run, and again under seeded peer corruption."""
    import cubed_tpu_torch
    from cubed_tpu_torch.observability.metrics import get_registry

    cut = config["cut"]

    def rechunked(**spec_kw):
        random.seed(config["seed"] + 4)
        spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB", **spec_kw)
        a = cubed_tpu_torch.random.random(cut["shape"], chunks=cut["chunks"], spec=spec)
        return cubed_tpu_torch.map_blocks(lambda t: t * 2.0, a, dtype=np.float64).rechunk(config["rechunk"])

    reg = get_registry()
    runs = {}
    for label, kw in (("peers", dict(peer_transfer=True)), ("store only", dict(peer_transfer=False)),
                      ("peers, corrupt", dict(peer_transfer=True, fault_injection=config["peer_faults"]))):
        before = reg.snapshot()
        t0 = time.perf_counter()
        value = np.asarray(rechunked(**kw).compute(executor=fl))
        seconds = time.perf_counter() - t0
        delta = reg.snapshot_delta(before)
        counters = {k: delta.get(k, 0) for k in ("peer_hits", "peer_misses", "peer_range_fetches",
                                                 "shuffle_bytes_peer", "peer_bytes_fetched",
                                                 "store_read_bytes_saved", "peer_fetch_fallbacks", "task_retries")}
        runs[label] = value
        print(f"fleet 4 ({label}) rechunk {cut['shape']} / {cut['chunks']} -> {config['rechunk']}: {seconds:.3f} s; "
              f"{json.dumps(counters)}")
        if label == "store only":
            check(counters["peer_hits"] == 0, "fleet 4: a store-only run read a peer")
            check(np.array_equal(value, runs["peers"]), "fleet 4 (peers): differs from the store-only run")
        else:
            check(counters["peer_hits"] > 0 or counters["shuffle_bytes_peer"] > 0, f"fleet 4 ({label}): no peer read")
            check(counters["task_retries"] == 0, f"fleet 4 ({label}): a peer fault drew a retry")
        if label == "peers, corrupt":
            check(np.array_equal(value, runs["store only"]), f"fleet 4 ({label}): differs from the store-only run")
            check(counters["peer_fetch_fallbacks"] > 0, "fleet 4: no seeded corruption fell back to the store")
        out[f"peer {label}"] = dict(seconds=seconds, **counters)


def fleet_kill(torch, config, work, ys, fl, out) -> None:
    """Check 3 on the fleet: a worker SIGKILLed mid-compute at the cut, one
    worker lost, its tasks requeued, the value bit for bit the sequential
    one's."""
    import signal

    from cubed_tpu_torch.observability.metrics import get_registry

    cut, workers, sequential = config["cut"], config["workers"], ys["cut_sequential"]["value"]
    victim = fl._procs[0]
    fired: list = []

    def kill_fleet_worker(n):
        if n == config["fleet_kill_after"] and not fired:
            os.kill(victim.pid, signal.SIGKILL)
            fired.append(victim.pid)

    reg = get_registry()
    lost = fl.stats["workers_lost"]
    before = reg.snapshot()
    v, seconds, _, _ = fleet_compute(torch, vorticity_arr(cut, work, config["seed"]), fl, TaskLog(kill_fleet_worker))
    delta = reg.snapshot_delta(before)
    requeues = delta.get("worker_loss_requeues", 0)
    print(f"fleet 3 (fleet of {workers}, local-0 SIGKILLed after {config['fleet_kill_after']} tasks): {seconds:.3f} s; "
          f"{float(v).hex()} against {sequential}; workers_lost {fl.stats['workers_lost'] - lost}, requeued "
          f"{requeues}, workers left {fl._coordinator.n_workers}; {smi_tag()}")
    check(fl.stats["workers_lost"] - lost == 1, "fleet 3: the fleet did not lose exactly one worker")
    check(requeues >= 1, "fleet 3: no task of the killed worker was requeued")
    check(float(v).hex() == sequential, "fleet 3 (fleet): the value differs")
    out["fleet_kill"] = dict(seconds=seconds, requeued=requeues)


def run_fleet_phase(torch, config=FLEET, given=None) -> dict:
    """The fleet phase (see the module docstring); returns its numbers,
    printed as they come."""
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

    started = time.perf_counter()
    work = os.path.join(WORK_DIR, "fleet")
    shutil.rmtree(work, ignore_errors=True)
    out, timings = {}, {}
    ys = fleet_yardsticks(torch, config, work, given or {})
    timings["yardsticks"] = time.perf_counter() - started
    fl = DistributedDagExecutor(n_local_workers=config["workers"])
    try:
        for name, part in (("pool", lambda: fleet_pool(torch, config, work, ys, out)),
                           ("fleet start", fl._ensure_fleet),
                           ("fleet 1, 2, 5", lambda: fleet_values(torch, config, work, ys, fl, out)),
                           ("fleet 4", lambda: fleet_peer(torch, config, work, fl, out)),
                           ("fleet 3", lambda: fleet_kill(torch, config, work, ys, fl, out))):
            t0 = time.perf_counter()
            part()
            shutil.rmtree(work, ignore_errors=True)
            timings[name] = time.perf_counter() - t0
    finally:
        fl.close()
        shutil.rmtree(work, ignore_errors=True)
    out["fleet_start_s"] = timings["fleet start"]
    print(f"fleet 7: the fleet of {config['workers']} started in {out['fleet_start_s']:.3f} s; {smi_tag()}")
    left = live_children()
    print(f"fleet 6: after close(), live children {left}")
    check(left == [], f"fleet 6: live child processes after close(): {left}")
    seconds = time.perf_counter() - started
    print(f"fleet phase: {seconds:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items())
          + f"); {smi_tag()}")
    return dict(out, seconds=seconds, timings=timings)


# ---------------------------------------------------------------------------
# the service phase: the multi-tenant compute service on the device executor
# and over an autoscaled fleet, live coordinator failover under it, and the
# invariant auditor
# ---------------------------------------------------------------------------

#: the service phase, in a process of its own (``--service-phase``): check 1
#: vorticity at full width (phase 4's plan and seed) from two tenants on one
#: ``CudaExecutor``; checks 2 and 4 a backlog of ``backlog`` requests at the
#: reliability phase's cut (447 tasks) under ``enforce`` at the plan's bound
#: on a fleet of one local worker that the autoscaler may grow to
#: ``max_workers``; check 3 one request at the cut on ``failover_workers``
#: workers whose coordinator is SIGKILLed after ``kill_fraction`` of its
#: tasks; ``timing_rounds`` warm requests each way for check 6. One task
#: slot a worker: with two tasks in flight a worker's guard reading covers
#: both (an upper bound, not a task's own), and ``enforce`` at one task's
#: bound then fails tasks that fit it (PERF.md §6, run W6); and the store
#: alone (``peer_transfer=False``): a worker serving its cached chunks to
#: peers grows its RSS inside another task's reading
SERVICE = dict(full=VORTICITY, cut=RELIABILITY["seq"], seed=SEED, backlog=4, max_workers=3, worker_threads=1,
               failover_workers=2, kill_fraction=0.5, timing_rounds=3,
               policy=dict(min_workers=1, max_workers=3, interval_s=0.5, scale_up_queue_per_thread=1.0,
                           cooldown_up_s=1.0, idle_rounds_before_down=2, cooldown_down_s=1.0, drain_grace_s=5.0,
                           spawn_pending_timeout_s=60.0))
#: the kernels whose launches check 1 holds against phase 4's first compute
SERVICE_LAUNCHES = ("philox_uniform", "region_sum", "fma_sum_blocks")


def read_launches() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items() if k in SERVICE_LAUNCHES}


class TaskSpy:
    """Each task's guard reading and when the first task ended, fed by the
    executor's events (wrapped around its ``execute_dag``: the service
    passes its own callbacks)."""

    def __init__(self):
        self.readings: list = []
        self.first_end: Optional[float] = None

    def on_task_end(self, event):
        if self.first_end is None:
            self.first_end = time.time()
        self.readings.append(event.guard_mem_peak)


def spy_on(executor, spy) -> None:
    """Add *spy* to the callbacks of every compute *executor* runs."""
    run = executor.execute_dag

    def execute_dag(dag, callbacks=None, **kwargs):
        return run(dag, callbacks=list(callbacks or []) + [spy], **kwargs)

    executor.execute_dag = execute_dag


def service_yardsticks(torch, config, work, given: dict) -> dict:
    """Phase 4's device value and launches of vorticity at full width, and
    the sequential executor's value at the cut: passed on by the whole run
    (the same plans and seed on the same card), computed here alone."""
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor

    out = dict(given)
    if "device_value" not in out:
        arr = vorticity_arr(config["full"], work, config["seed"])
        zero_launches()
        value = arr.compute(executor=CudaExecutor())
        torch.cuda.synchronize()
        out["device_value"], out["device_launches"] = float(value).hex(), read_launches()
    if "cut_sequential" not in out:
        value = vorticity_arr(config["cut"], work, config["seed"]).compute(executor=PythonDagExecutor())
        out["cut_sequential"] = dict(value=float(value).hex())
    print(f"service yardsticks: phase 4's device value {out['device_value']}, launches "
          f"{json.dumps(out['device_launches'])}; the sequential value at the cut {out['cut_sequential']['value']}")
    return out


def service_tenants(torch, config, work, ys, out) -> None:
    """Check 1: two tenants at once on one ``CudaExecutor``, each value and
    their launches against phase 4's; a rebuilt identical plan a plan-cache
    hit; with the result cache, an identical submit a hit with no task run.
    Check 6's first time: warm requests through the service against the
    bare executor, in turns."""
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.service import ComputeService

    full, seed, want = config["full"], config["seed"], ys["device_value"]
    ex = CudaExecutor()
    reg = get_registry()
    with ComputeService(executor=ex, tenants={"gold": 4.0, "free": 1.0}, max_concurrent=2,
                        result_cache=False) as svc:
        arrays = {t: vorticity_arr(full, work, seed) for t in ("gold", "free")}
        zero_launches()
        t0 = time.perf_counter()
        handles = {t: svc.submit(a, tenant=t) for t, a in arrays.items()}
        values = {t: float(h.result(600)).hex() for t, h in handles.items()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        twice = {k: 2 * ys["device_launches"][k] for k in SERVICE_LAUNCHES}
        rows = svc.stats_snapshot()["tenants"]
        print(f"service 1 (two tenants on CudaExecutor) {full['shape']} / {full['chunks']}: {seconds:.3f} s for both; "
              f"values {json.dumps(values)} against phase 4's {want}; launches {json.dumps(launches)} (twice phase "
              f"4's {json.dumps(twice)}); completed {json.dumps({t: r['completed'] for t, r in rows.items()})}; "
              f"{smi_tag()}")
        check(all(v == want for v in values.values()), f"service 1: {values} differ from phase 4's {want}")
        check(launches == twice, f"service 1: launches {launches}, twice phase 4's {twice}")
        rebuilt = svc.submit(vorticity_arr(full, work, seed), tenant="gold")
        check(float(rebuilt.result(600)).hex() == want, "service 1: the rebuilt plan's value differs")
        check(rebuilt.plan_cache_hit, "service 1: a rebuilt identical plan missed the plan cache")
        # check 6: a warm request through the service against the bare
        # executor, in turns (the plan cache serves the service's)
        svc_s, bare_s = [], []
        for _ in range(config["timing_rounds"]):
            arr = vorticity_arr(full, work, seed)
            t0 = time.perf_counter()
            svc.submit(arr, tenant="gold").result(600)
            svc_s.append(time.perf_counter() - t0)
            arr = vorticity_arr(full, work, seed)
            t0 = time.perf_counter()
            arr.compute(executor=ex)
            torch.cuda.synchronize()
            bare_s.append(time.perf_counter() - t0)
    with ComputeService(executor=ex, max_concurrent=1) as svc:
        first = svc.submit(vorticity_arr(full, work, seed), tenant="gold")
        check(float(first.result(600)).hex() == want, "service 1: the cached service's value differs")
        before = reg.snapshot()
        again = svc.submit(vorticity_arr(full, work, seed), tenant="free")
        value = float(again.result(600)).hex()
        delta = reg.snapshot_delta(before)
        print(f"service 1: an identical submit with the result cache: hit {again.result_cache_hit}, tasks run "
              f"{delta.get('tasks_completed', 0)}, value {value}; rebuilt plan: plan-cache hit {rebuilt.plan_cache_hit}")
        check(again.result_cache_hit and delta.get("tasks_completed", 0) == 0 and value == want,
              "service 1: an identical submit was not a result-cache hit with no task run")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    print(f"service 6: a warm vorticity request through the service {med(svc_s):.4f} s against the bare CudaExecutor "
          f"{med(bare_s):.4f} s (medians of {config['timing_rounds']}, in turns: service {json.dumps(svc_s)}, bare "
          f"{json.dumps(bare_s)}); {smi_tag()}")
    out["tenants"] = dict(seconds=seconds, launches=launches, service_s=svc_s, bare_s=bare_s,
                          overhead_s=med(svc_s) - med(bare_s))


def service_fleet(torch, config, work, ys, out) -> None:
    """Checks 2 and 4 (and 6's spawn time): a durable service over a fleet of
    one worker with the autoscaler, a backlog at the cut under ``enforce``
    at the plan's bound: every value bit for bit the sequential one's; the
    autoscaler spawns a worker and retires one after idle; every worker on
    ``cuda`` with a launch; every task's reading within the bound."""
    from cubed_tpu_torch.observability.collect import decisions_since
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime import distributed
    from cubed_tpu_torch.runtime.autoscale import AutoscalePolicy
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor
    from cubed_tpu_torch.runtime.journal import control_log_path
    from cubed_tpu_torch.service import ComputeService
    from cubed_tpu_torch.service.durability import service_control_dir

    cut, seed, want = config["cut"], config["seed"], ys["cut_sequential"]["value"]
    sdir = os.path.join(work, "svc-fleet")
    bound = vorticity_arr(cut, work, seed).plan.max_projected_mem()
    ex = DistributedDagExecutor(n_local_workers=1, max_workers=config["max_workers"],
                                worker_threads=config["worker_threads"],
                                autoscale_policy=AutoscalePolicy(**config["policy"]))
    spy = TaskSpy()
    spy_on(ex, spy)
    reg = get_registry()
    first_task: dict = {}
    stop = threading.Event()

    def watch():
        while not stop.wait(0.05):
            for name, row in list((ex.stats.get("worker_reports") or {}).items()):
                if row.get("tasks") and name not in first_task:
                    first_task[name] = time.time()

    watcher = threading.Thread(target=watch, daemon=True)
    # the root type and last line of every attempt that failed in a worker
    remote: list = []
    fail_future = distributed._fail_future

    def spy_failure(fut, exc):
        if isinstance(exc, distributed.RemoteTaskError):
            lines = str(exc).strip().splitlines() or [""]
            remote.append((exc.remote_type, lines[-1][:300]))
        return fail_future(fut, exc)

    distributed._fail_future = spy_failure
    try:
        t_dec = time.time()
        t0 = time.perf_counter()
        with ComputeService(executor=ex, service_dir=sdir, max_concurrent=2, result_cache=False) as svc:
            ex._ensure_fleet()
            start_s = time.perf_counter() - t0
            watcher.start()
            arrays = [vorticity_arr(cut, work, seed, allowed_mem=bound, reserved_mem=0, memory_guard="enforce",
                                    peer_transfer=False) for _ in range(config["backlog"])]
            before = reg.snapshot()
            t1 = time.perf_counter()
            handles = [svc.submit(a, tenant=f"t{i % 2}") for i, a in enumerate(arrays)]
            values = [float(h.result(900)).hex() for h in handles]
            backlog_s = time.perf_counter() - t1
            delta = reg.snapshot_delta(before)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and ex.stats["autoscale"]["workers_scaled_down"] < 1:
                time.sleep(0.25)
            scale = dict(ex.stats["autoscale"])
            reports = dict(ex.stats["worker_reports"])
        decisions = decisions_since(t_dec)
        spawned = {d["worker"]: d["ts"] for d in decisions if d["kind"] == "scale_up"}
        retired = [d["worker"] for d in decisions if d["kind"] == "scale_down"]
        records = [json.loads(line) for line in open(control_log_path(service_control_dir(sdir)))]
    finally:
        stop.set()
        distributed._fail_future = fail_future
        ex.close()
    largest = max(r or 0 for r in spy.readings)
    # a worker's guard trip reaches the client as a remote failure, whose
    # root type the spy on the coordinator's failures kept
    trips = [r for r in remote if r[0] == "MemoryGuardExceededError"]
    over = delta.get("mem_guard_hard_exceeded", 0) + len(trips)
    spawn_to_task = {n: first_task[n] - ts for n, ts in spawned.items() if n in first_task}
    per_request = {k: sum(1 for r in records if r["kind"] == k) / config["backlog"]
                   for k in ("dispatch", "done", "chunk_loc")}
    print(f"service 2 (durable service over an autoscaled fleet) {cut['shape']} / {cut['chunks']}: fleet start "
          f"{start_s:.3f} s, backlog of {config['backlog']} in {backlog_s:.3f} s; values {json.dumps(values)} against "
          f"the sequential {want}; autoscaler {json.dumps(scale)}, spawned {sorted(spawned)}, retired {retired}; "
          f"{smi_tag()}")
    ran = sorted(set(spawned) & set(reports))
    check_workers("service 2", reports, 1 + len(ran))
    check(all(v == want for v in values), "service 2: a value differs from the sequential one")
    check(len(spawned) >= 1, "service 2: the autoscaler spawned no worker")
    check(len(ran) >= 1, f"service 2: no spawned worker ran a task: spawned {sorted(spawned)}, ran {sorted(reports)}")
    check(len(retired) >= 1, "service 2: the autoscaler retired no worker after idle")
    halves = sum(1 for r in spy.readings if (r or 0) > bound / 2)
    print(f"service 4 (enforce at the plan's bound {bound} B): {len(spy.readings)} tasks, readings taken in the "
          f"workers ({config['worker_threads']} tasks in flight a worker), largest {largest} B ({largest / bound:.4f} "
          f"of the bound), {halves} over half of it, {sum(r is None for r in spy.readings)} unread; attempts over "
          f"the bound {over}; failed attempts {len(remote)} (resource {delta.get('task_resource_failures', 0)}), "
          f"retries {delta.get('task_retries', 0)}")
    for kind, last in remote:
        print(f"service 4: a failed attempt in a worker: {kind}: {last}")
    check(spy.readings and all(r is not None for r in spy.readings), "service 4: a task without a guard reading")
    check(largest <= bound, f"service 4: a reading {largest} B over the bound {bound} B")
    check(over == 0, f"service 4: {over} attempts over the bound")
    print(f"service 6: spawn to first task (s) {json.dumps({n: round(s, 3) for n, s in spawn_to_task.items()})}; "
          f"control-log records a request at the cut {json.dumps(per_request)}; {smi_tag()}")
    out["fleet"] = dict(start_s=start_s, backlog_s=backlog_s, autoscale=scale, spawned=sorted(spawned),
                        retired=retired, spawn_to_first_task_s=spawn_to_task, guard=dict(largest=largest, bound=bound,
                        tasks=len(spy.readings), over_bound=over), control_records_per_request=per_request)


def control_log_cost(work: str, records: dict, n: int = 4000) -> dict:
    """Check 6's control-log cost at the cut: the time of *n* appends of each
    kind a request writes (flushed, not fsync'd) in a scratch log, times the
    records of each kind a request wrote."""
    from cubed_tpu_torch.runtime.journal import ControlLog

    log = ControlLog(os.path.join(work, "cost-ctrl"))
    per = {}
    try:
        t0 = time.perf_counter()
        for i in range(n):
            log.record_dispatch(i, ("op-a", f"{i}.0.0"), "local-0")
        per["dispatch"] = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for i in range(n):
            log.record_done(i)
        per["done"] = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for i in range(n):
            log.record_chunk_locations("local-0", [("store", f"{i}.0.0", 1_536_000)])
        per["chunk_loc"] = (time.perf_counter() - t0) / n
    finally:
        log.close()
    total = sum(per[k] * records.get(k, 0) for k in per)
    return dict(per_record_s=per, per_request_s=total)


def service_failover(torch, config, work, ys, out, spares: list) -> None:
    """Checks 3 and 5 (and 6's takeover time): a service process and its
    coordinator over a fleet on one ``service_dir``, SIGKILLed after
    ``kill_fraction`` of a request's tasks; a successor service process
    adopts the orphaned workers (one takeover, no worker lost), resumes
    fewer tasks than the plan's, the value bit for bit; the auditor clean
    over the journal, the control dir and the work dir; the orphans reaped
    by the control log's pids, none left."""
    import signal

    from cubed_tpu_torch.runtime.audit import InvariantAuditor
    from cubed_tpu_torch.runtime.journal import control_log_path
    from cubed_tpu_torch.service.durability import load_requests, service_control_dir

    cut, want = config["cut"], ys["cut_sequential"]["value"]
    fdir = os.path.join(work, "failover")
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir)
    job = dict(work=os.path.join(fdir, "work"), sdir=os.path.join(fdir, "svc"), journal=os.path.join(fdir, "c.jsonl"),
               seed=config["seed"], cut=cut, workers=config["failover_workers"], threads=config["worker_threads"])
    tasks = vorticity_arr(cut, os.path.join(fdir, "plan"), config["seed"]).plan.num_tasks()
    first = feed(spares[0], ["--service-failover", "run", json.dumps(job)])
    killed_at = None
    deadline = time.monotonic() + 300
    done = 0
    while time.monotonic() < deadline:
        try:
            with open(job["journal"]) as f:
                done = sum(1 for line in f if '"kind": "complete"' in line)
        except OSError:
            done = 0
        if done >= config["kill_fraction"] * tasks:
            os.kill(first[0].pid, signal.SIGKILL)
            killed_at = time.time()
            break
        if first[0].poll() is not None:
            break
        time.sleep(0.05)
    if killed_at is None:
        proc = drain(first, 60, "--service-failover run")
        raise PhaseFailed(f"service 3: the service process ended before its kill ({done} of {tasks} tasks):\n"
                          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    # its orphaned workers keep the killed process's output pipe open: the
    # reader goes on reading it, and only the process's end is waited for
    first[0].wait(timeout=30)
    control_dir = service_control_dir(job["sdir"])
    pids = sorted({r["pid"] for r in map(json.loads, open(control_log_path(control_dir)))
                   if r.get("kind") == "worker" and r.get("pid")})
    # the successor is told which request the journal holds
    job["request"] = [r["request_id"] for recs in load_requests(job["sdir"]).values() for r in recs]
    second = drain(feed(spares[1], ["--service-failover", "recover", json.dumps(job)]), 300, "--service-failover recover")
    lines = second.stdout.strip().splitlines()
    check(second.returncode == 0 and lines, f"service 3: the successor failed:\n{second.stderr[-4000:]}")
    r = json.loads(lines[-1])
    takeover_s = r["first_end"] - killed_at if r.get("first_end") else None
    report = InvariantAuditor(journal=job["journal"], control_dir=control_dir, work_dir=job["work"]).audit()
    print(f"service 3 (live failover under the service) {cut['shape']} / {cut['chunks']}: SIGKILLed after {done} of "
          f"{tasks} tasks; successor: {r['value']} against {want}, coordinator_takeovers {r['takeovers']}, "
          f"workers_lost {r['workers_lost']}, tasks_readopted {r['readopted']}, tasks resumed {r['tasks']} of "
          f"{tasks}; {smi_tag()}")
    print(f"service 3: invariant audit {'clean' if report.ok else 'VIOLATED'}: checked {report.checked}; "
          + "; ".join(v.render() for v in report.violations))
    check(r["value"] == want, "service 3: the recovered value differs")
    check(r["takeovers"] == 1 and r["workers_lost"] == 0, f"service 3: takeovers {r['takeovers']}, lost "
          f"{r['workers_lost']}")
    check(0 < r["tasks"] < tasks, f"service 3: {r['tasks']} tasks resumed of the plan's {tasks}")
    check(report.ok and "single_ownership" in report.checked, "service 3: the invariant audit is not clean")
    left = []
    deadline = time.monotonic() + 15
    while pids and time.monotonic() < deadline:
        left = [p for p in pids if pid_alive(p)]
        if not left:
            break
        time.sleep(0.2)
    for p in left:
        os.kill(p, signal.SIGKILL)
    print(f"service 5: the control log's worker pids {pids}, alive after the successor's close {left} (reaped); "
          f"takeover from the kill to the successor's first completion {takeover_s if takeover_s is None else round(takeover_s, 3)} s")
    check(left == [], f"service 5: orphaned workers alive after the successor's close: {left}")
    check(len(pids) == config["failover_workers"], f"service 3: control log names {pids}")
    out["failover"] = dict(killed_after=done, tasks=tasks, resumed=r["tasks"], readopted=r["readopted"],
                           takeover_s=takeover_s, audit=report.checked, orphans_left=len(left))


def pid_alive(pid: int) -> bool:
    """True while *pid* runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def service_failover_child(mode: str, job: dict) -> int:
    """One side of check 3, in a process of its own. ``run``: a durable
    service over a fleet, one request at the cut, until it is killed.
    ``recover``: the successor service on the same ``service_dir``, with a
    coordinator that adopts the fleet; its summary on the last line."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor
    from cubed_tpu_torch.service import ComputeService

    if mode == "run":
        # the orphaned workers wait out the kill and the successor's start
        os.environ["CUBED_TPU_TORCH_RECONNECT_GIVE_UP_S"] = "120"
        ex = DistributedDagExecutor(n_local_workers=job["workers"], worker_threads=job["threads"])
        svc = ComputeService(executor=ex, service_dir=job["sdir"], result_cache=False, plan_cache=False).start()
        random.seed(job["seed"])
        spec = cubed_tpu_torch.Spec(work_dir=job["work"], allowed_mem="2GB", journal=job["journal"])
        arr = vorticity_build(spec, dict(job["cut"], shape=tuple(job["cut"]["shape"])))
        print(json.dumps({"request": svc.submit(arr, tenant="gold").request_id}), flush=True)
        svc.wait_idle(600)
        print(json.dumps({"finished": True}), flush=True)
        return 0
    ex = DistributedDagExecutor(n_local_workers=0, min_workers=1)
    spy = TaskSpy()
    spy_on(ex, spy)
    svc = ComputeService(executor=ex, service_dir=job["sdir"], result_cache=False, plan_cache=False)
    try:
        svc.start()
        check(svc.wait_idle(300), "service 3: the successor did not finish")
        check(len(job["request"]) == 1, f"service 3: the journal holds {job['request']}")
        handle = svc.handle(job["request"][0])
        check(handle is not None, "service 3: the successor did not recover the request")
        value = float(handle.result(60)).hex()
        stats = ex._coordinator.stats
        summary = dict(value=value, takeovers=stats["coordinator_takeovers"], workers_lost=stats["workers_lost"],
                       readopted=stats["tasks_readopted"], tasks=(handle.cost or {}).get("tasks"),
                       first_end=spy.first_end)
    finally:
        svc.close()
        ex.close()
    print(json.dumps(summary))
    return 0


def run_service_phase(torch, config=SERVICE, given=None) -> dict:
    """The service phase (see the module docstring); returns its numbers,
    printed as they come."""
    started = time.perf_counter()
    work = os.path.join(WORK_DIR, "service")
    shutil.rmtree(work, ignore_errors=True)
    out, timings = {}, {}
    # check 3's two processes import torch and the port while checks 1-2 run
    spares = [_spawn_spare(), _spawn_spare()]
    try:
        ys = service_yardsticks(torch, config, work, given or {})
        timings["yardsticks"] = time.perf_counter() - started
        for name, part in (("service 1", lambda: service_tenants(torch, config, work, ys, out)),
                           ("service 2, 4", lambda: service_fleet(torch, config, work, ys, out)),
                           ("service 3, 5", lambda: service_failover(torch, config, work, ys, out, spares))):
            t0 = time.perf_counter()
            part()
            timings[name] = time.perf_counter() - t0
    finally:
        for proc in spares:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    out["control_log_cost"] = control_log_cost(work, out["fleet"]["control_records_per_request"])
    shutil.rmtree(work, ignore_errors=True)
    print(f"service 6: the control log's cost a request at the cut {out['control_log_cost']['per_request_s']:.6f} s "
          f"(per record {json.dumps({k: round(v * 1e6, 3) for k, v in out['control_log_cost']['per_record_s'].items()})} "
          f"us, flushed, not fsync'd); {smi_tag()}")
    left = live_children()
    print(f"service 5: after close(), live children {left}")
    check(left == [], f"service 5: live child processes after close(): {left}")
    seconds = time.perf_counter() - started
    print(f"service phase: {seconds:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items())
          + f"); {smi_tag()}")
    return dict(out, seconds=seconds, timings=timings)


# ---------------------------------------------------------------------------
# the analytics phase: the flight recorder, run history, explain, analyze,
# regress, live telemetry and the dispatch profiler around the device path
# ---------------------------------------------------------------------------

#: the analytics phase, in a process of its own (``--analytics-phase``):
#: part 1 vorticity at full width on ``CudaExecutor``, cold, capturing and
#: warm, all of one seed (so the three run records share a fingerprint);
#: part 2 the reliability phase's sequential cut (160, 160, 120) / 40 (447
#: tasks) on the threads executor, against the sequential executor's run;
#: part 3 a failing compute at a small cut; part 4 arming's cost,
#: ``cost_rounds`` warm computes each way in turns
ANALYTICS = dict(full=VORTICITY, cut=RELIABILITY["seq"], seed=SEED, workers=8, cost_rounds=30,
                 failing=dict(shape=(40, 36, 32), chunks=8), faults=dict(seed=17, task_failure_rate=1.0), retries=2)
#: the kernels whose launches part 1 holds against phase 4's unobserved computes
ANALYTICS_LAUNCHES = ("philox_uniform", "region_sum", "fma_sum_blocks")
#: the buckets the sequential and the threaded computes' split is printed in
SPLIT_BUCKETS = ("storage_read", "storage_write", "kernel", "queue_wait", "ready_wait", "dispatch_overhead",
                 "uninstrumented", "other")


def http_get(port: int, path: str) -> tuple:
    """(status, body) of ``GET http://127.0.0.1:<port><path>``."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def bucket_split(collector, label: str, seconds: float) -> dict:
    """``analyze()`` of a compute's collector, printed: the critical path's
    split into :data:`SPLIT_BUCKETS` and the busy seconds per bucket over
    every task (the per-op rows summed)."""
    from cubed_tpu_torch.observability import analyze

    d = analyze(collector).to_dict()
    busy: dict = {}
    for row in (d.get("per_op") or {}).values():
        for k, v in row["buckets"].items():
            busy[k] = busy.get(k, 0.0) + v
    split = dict(seconds=seconds, source=d["critical_path_source"], tasks=d["tasks_analyzed"],
                 path={k: d["attribution"].get(k, 0.0) for k in SPLIT_BUCKETS},
                 busy={k: busy.get(k, 0.0) for k in SPLIT_BUCKETS})
    print(f"{label}: compute() {seconds:.3f} s, {d['tasks_analyzed']} task spans, critical path "
          f"{len(d['critical_path'])} tasks from the {d['critical_path_source']}; critical-path split (s) "
          + ", ".join(f"{k} {split['path'][k]:.4f}" for k in SPLIT_BUCKETS) + "; busy split over every task (s) "
          + ", ".join(f"{k} {split['busy'][k]:.4f}" for k in SPLIT_BUCKETS) + f"; {smi_tag()}")
    return split


def started_cli(module: str, *args) -> tuple:
    """``python -m <module> <args>`` started from the checkout's root."""
    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)
    return proc, time.perf_counter()


def finished_cli(started: tuple, timeout: float = 120) -> tuple:
    """(exit code, stdout, stderr, seconds since it started) of a
    :func:`started_cli` process, waited for."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, stdout, stderr, time.perf_counter() - t0


def analytics_device(torch, config, work, given, out) -> tuple:
    """Part 1: vorticity at full width on ``CudaExecutor``, observed by a
    ``FlightRecorder`` with run history, telemetry and the dispatch
    profiler armed by the Spec. Returns the executor (its graph captured)
    and a callable that checks the top frame taken beside the next part."""
    import io

    import cubed_tpu_torch
    from cubed_tpu_torch import regress
    from cubed_tpu_torch.observability import FlightRecorder, analyze, export
    from cubed_tpu_torch.observability.dispatchprofile import profile_for
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.observability.runhistory import load_runs
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.service.cache import structural_fingerprint

    hist = os.path.join(work, "history")
    wrappers = kernel_wrappers()
    ex = CudaExecutor()
    fp_bytes = get_registry().snapshot().get("fingerprint_device_bytes", 0)
    ids = []
    for i, label in enumerate(("cold", "capturing", "warm")):
        spec = cubed_tpu_torch.Spec(work_dir=os.path.join(work, f"device-{i}"), allowed_mem="2GB", run_history=hist,
                                    telemetry_port=0, dispatch_profile=True)
        random.seed(config["seed"])
        x = vorticity_build(spec, config["full"])
        plan = x.plan._finalize(array_names=(x.name,))
        fr = FlightRecorder(bundle_dir=os.path.join(work, "bundles"), always=True)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        value = float(x.compute(executor=ex, callbacks=[fr]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: wrappers[k].launches for k in ANALYTICS_LAUNCHES}
        d = analyze(fr).to_dict()
        expl = x.explain().to_dict()
        es = fr.executor_stats or {}
        prof = profile_for(fr.compute_id)
        rel = abs(value - given["expected"]) / abs(given["expected"])
        tag = f"analytics [cuda, {label}, seed {config['seed']}]"
        print(f"{tag}: compute() {seconds:.4f} s, value {value!r}, numpy oracle {given['expected']!r}, rel err "
              f"{rel:.3e}; launches {json.dumps(launches)} (phase 4's unobserved {json.dumps(given['launches'][i])}); "
              f"{smi_tag()}")
        print(f"{tag}: analyze(): {d['tasks_analyzed']} task spans (plan: {plan.num_ops()} ops, {plan.num_tasks()} "
              f"tasks), critical path {len(d['critical_path'])} ops from the {d['critical_path_source']}, attribution "
              f"coverage {d['attribution_coverage']}, wall clock {d['wall_clock_s']:.4f} s, buckets "
              f"{json.dumps({k: v for k, v in d['attribution'].items() if v})}; explain(): {expl['totals']['tasks']} "
              f"tasks, bytes written {expl['totals']['bytes_written']} B predicted through storage, the output op's "
              f"{expl['ops'][-1]['bytes_written']} B; executor_stats bytes_written {es.get('bytes_written')} B, "
              f"tasks_completed {es.get('tasks_completed')}; dispatch profiler {prof.samples if prof else None} samples")
        check(rel <= 1e-12, f"{tag}: value differs from the numpy oracle beyond rtol 1e-12")
        check(launches == {k: given["launches"][i][k] for k in ANALYTICS_LAUNCHES},
              f"{tag}: launches {launches}, phase 4's unobserved {given['launches'][i]}")
        check(d["tasks_analyzed"] == plan.num_ops() and d["critical_path"] and d["critical_path_source"] == "op_graph",
              f"{tag}: analyze() read {d['tasks_analyzed']} task spans, path {d['critical_path']}")
        check(abs(d["attribution_coverage"] - 1.0) <= 0.01, f"{tag}: coverage {d['attribution_coverage']}")
        check(expl["totals"]["tasks"] == es.get("tasks_completed") == plan.num_tasks(),
              f"{tag}: explain {expl['totals']['tasks']} tasks, executor_stats {es.get('tasks_completed')}")
        # the device executor writes only the output: the output op's
        # predicted bytes, all that reached storage
        check(expl["ops"][-1]["bytes_written"] == es.get("bytes_written") == 8,
              f"{tag}: predicted {expl['ops'][-1]['bytes_written']} B, written {es.get('bytes_written')} B")
        check(prof is not None and prof._thread is None, f"{tag}: the dispatch profiler was not armed and stopped")
        ids.append((fr.compute_id, plan.num_tasks()))
        out.setdefault("device", []).append(dict(seconds=seconds, value=value, launches=launches,
                                                 buckets=d["attribution"], coverage=d["attribution_coverage"]))
        shutil.rmtree(spec.work_dir, ignore_errors=True)
    # run history: three records of one fingerprint, no card bytes copied
    # for it (the plan holds no tensor), and regress's diff of the last two
    records, bad = load_runs(hist)
    fps = {r.get("fingerprint") for r in records}
    copied = get_registry().snapshot().get("fingerprint_device_bytes", 0) - fp_bytes
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = regress.main(["--history", hist])
    print(f"analytics [run history]: {len(records)} records ({bad} unreadable), fingerprints {sorted(fps)}, card "
          f"bytes copied to fingerprint {copied}; python -m cubed_tpu_torch.regress exited {rc}:\n{buf.getvalue()}")
    check(len(records) == 3 and bad == 0 and len(fps) == 1 and None not in fps and copied == 0,
          f"analytics [run history]: records {records}")
    check(rc in (0, 1) and "REGRESSION" in buf.getvalue() and all(r.get("buckets") for r in records),
          f"analytics [run history]: regress exited {rc}")
    # a plan that holds a tensor on the card: two builds fingerprint equal,
    # another tensor differs, each hash copying the tensor's bytes once
    a = cubed_tpu_torch.random.random((64, 64), chunks=32, spec=cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB"))
    ws = [torch.ones(1 << 16, device="cuda", dtype=torch.float64) for _ in range(2)]
    ws.append(torch.zeros(1 << 16, device="cuda", dtype=torch.float64))
    before = get_registry().snapshot().get("fingerprint_device_bytes", 0)
    held = [structural_fingerprint(cubed_tpu_torch.map_blocks(lambda b, w=w: b * w[0], a, dtype=np.float64).plan.dag)[0]
            for w in ws]
    copied = get_registry().snapshot().get("fingerprint_device_bytes", 0) - before
    print(f"analytics [fingerprint]: a block function holding a CUDA tensor of {ws[0].numel() * 8} B, three builds: "
          f"equal {held[0] == held[1]}, another tensor differs {held[0] != held[2]}, card bytes copied {copied}")
    check(held[0] == held[1] != held[2] and copied == 3 * ws[0].numel() * 8, "analytics [fingerprint]: fingerprints")
    # the live endpoints over loopback, and top rendering from them
    rt = export.get_runtime()
    check(rt is not None, "analytics [telemetry]: not armed")
    rt.sampler.sample_once()
    metrics_code, metrics_body = http_get(rt.port, "/metrics")
    health_code, health_body = http_get(rt.port, "/healthz")
    snap_code, snap_body = http_get(rt.port, "/snapshot.json")
    snap = json.loads(snap_body)
    rows = {c["compute_id"]: c for c in snap["computes"]}
    done = [(rows[c]["tasks_done"], rows[c]["tasks_total"], n, rows[c]["status"]) for c, n in ids if c in rows]
    families = sum(line.startswith("# TYPE ") for line in metrics_body.splitlines())
    print(f"analytics [telemetry]: 127.0.0.1:{rt.port} /metrics {metrics_code} ({families} families, "
          f"{len(metrics_body)} B), /healthz {health_code} {health_body}, /snapshot.json {snap_code}: computes "
          f"(done, total, plan's tasks, status) {done}")
    check(metrics_code == 200 and "cubed_tpu_torch_tasks_completed " in metrics_body,
          "analytics [telemetry]: /metrics")
    check(health_code == 200 and json.loads(health_body)["status"] == "ok", "analytics [telemetry]: /healthz")
    check(len(done) == 3 and all(dn == tot == n and st == "succeeded" for dn, tot, n, st in done),
          f"analytics [telemetry]: progress {done}")
    # top in a process of its own, run beside part 2 (the endpoint serves
    # on); its frame is checked by the returned callable
    top = started_cli("cubed_tpu_torch.top", f"127.0.0.1:{rt.port}", "--once")

    def finish_top() -> None:
        rc, stdout, stderr, seconds = finished_cli(top)
        print(f"analytics [top]: python -m cubed_tpu_torch.top --once exited {rc} after {seconds:.1f} s:\n"
              f"{stdout}{stderr[-2000:]}")
        check(rc == 0 and "COMPUTES" in stdout and f"{ids[-1][1]}/{ids[-1][1]}" in stdout,
              "analytics [top]: no frame from the endpoint")

    ticks = []
    for _ in range(30):
        t = time.perf_counter()
        rt.sampler.sample_once()
        ticks.append(time.perf_counter() - t)
    out["sampler_tick_ms"] = float(np.median(ticks)) * 1e3
    print(f"analytics [telemetry]: one sampler tick (the registry into the store, the alert rules) median "
          f"{out['sampler_tick_ms']:.4f} ms of 30, once a second; {smi_tag()}")
    return ex, finish_top


def sequential_cut_observed(torch, config) -> dict:
    """The cut on the sequential executor with a ``TraceCollector``: its
    value (``float.hex``) and bucket split, what part 2 holds the threads
    executor to (the whole run passes in the observability phase's run of
    this plan instead)."""
    from cubed_tpu_torch.observability import TraceCollector
    from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor

    work = os.path.join(WORK_DIR, "analytics-sequential")
    cut = config["cut"]
    col = TraceCollector(trace_dir=None)
    x = vorticity_arr(cut, work, config["seed"])
    t = time.perf_counter()
    value = float(x.compute(executor=PythonDagExecutor(), callbacks=[col]))
    seconds = time.perf_counter() - t
    shutil.rmtree(work, ignore_errors=True)
    return dict(value=value.hex(), split=bucket_split(col, f"analytics [sequential, {cut['shape']} / "
                                                           f"{cut['chunks']}]", seconds))


def analytics_threads(torch, config, work, sequential, out) -> None:
    """Part 2: the cut on the threads executor under dataflow with a
    ``FlightRecorder`` and the dispatch profiler: a chunk graph recorded and
    read as the critical path's source, a "dispatch profile" lane, the
    value bit for bit the sequential executor's (*sequential*: its value
    and bucket split), and the compute's bucket split."""
    from cubed_tpu_torch.observability import FlightRecorder

    cut = config["cut"]
    fr = FlightRecorder(bundle_dir=os.path.join(work, "bundles-threads"), always=True)
    x = vorticity_arr(cut, os.path.join(work, "thr"), config["seed"], scheduler="dataflow", dispatch_profile=True)
    t = time.perf_counter()
    value = float(x.compute(executor=threads_executor(config["workers"]), callbacks=[fr]))
    split = bucket_split(fr, f"analytics [threads, {cut['shape']} / {cut['chunks']}]", time.perf_counter() - t)
    graph = fr.chunk_graph()
    lanes = {e["args"]["name"] for e in fr.merged_tracer().chrome_events() if e.get("ph") == "M"}
    print(f"analytics [threads]: chunk graph of {len(graph or {})} tasks recorded, merged trace lanes "
          f"{sorted(lanes)}; value {value.hex()}, the sequential executor's {sequential['value']}")
    check(value.hex() == sequential["value"], "analytics [threads]: the value differs from the sequential one")
    check(graph is not None and len(graph) == split["tasks"], "analytics [threads]: no chunk graph")
    check(split["source"] == "chunk_graph", f"analytics [threads]: source {split['source']}")
    check("dispatch profile" in lanes, f"analytics [threads]: no dispatch profile lane in {sorted(lanes)}")
    out["split"] = dict(sequential=sequential["split"], threads=split)


def analytics_failing(config, work, out):
    """Part 3: a seeded task fault exhausting its retries with the flight
    recorder armed by ``CUBED_TPU_TORCH_FLIGHT_RECORDER``: one bundle,
    naming the failing op and chunk, and ``diagnose --analyze`` on it (in a
    process of its own, run beside the next part; the returned callable
    checks it)."""
    from cubed_tpu_torch.observability.flightrecorder import FLIGHT_RECORDER_ENV_VAR, load_bundle

    bundles = os.path.join(work, "bundles-failed")
    x = vorticity_arr(config["failing"], os.path.join(work, "failing"), config["seed"],
                      fault_injection=config["faults"])
    os.environ[FLIGHT_RECORDER_ENV_VAR] = bundles
    try:
        try:
            x.compute(executor=threads_executor(4, retries=config["retries"]))
        except Exception as e:
            error = e
        else:
            error = None
    finally:
        del os.environ[FLIGHT_RECORDER_ENV_VAR]
    made = sorted(os.listdir(bundles)) if os.path.isdir(bundles) else []
    check(error is not None and len(made) == 1, f"analytics [failing]: error {error!r}, bundles {made}")
    path = os.path.join(bundles, made[0])
    m = load_bundle(path)["manifest"]
    err = m.get("error") or {}
    print(f"analytics [failing]: {type(error).__name__} after {config['retries']} retries; bundle {made[0]}: "
          f"{sorted(os.listdir(path))}, error {err.get('type')} in op {err.get('op')} chunk {err.get('chunk')}")
    check(err.get("type") == "FaultInjectedTaskError" and err.get("op") and err.get("chunk"),
          f"analytics [failing]: manifest error {err}")
    diagnose = started_cli("cubed_tpu_torch.diagnose", path, "--analyze")

    def finish_diagnose() -> None:
        rc, stdout, stderr, seconds = finished_cli(diagnose)
        print(f"analytics [failing]: python -m cubed_tpu_torch.diagnose --analyze exited {rc} after {seconds:.1f} "
              f"s:\n" + "\n".join(stdout.splitlines()[:12]) + f"\n{stderr[-2000:]}")
        check(rc == 0 and "[failed]" in stdout and err["op"] in stdout and "== analysis" in stdout,
              "analytics [failing]: diagnose")
        out["failing"] = dict(op=err["op"], chunk=err["chunk"], diagnose_rc=rc)

    return finish_diagnose


def analytics_cost(torch, config, work, ex, out) -> None:
    """Part 4: vorticity's warm (replayed) compute in turns, unobserved and
    with telemetry, the dispatch profiler and run history armed by the
    Spec; medians and quartiles. The telemetry sampler, once armed in part
    1, ticks beside both ways (a process keeps its endpoint)."""
    import cubed_tpu_torch

    ways = {"unobserved": {}, "armed": dict(run_history=os.path.join(work, "history-cost"), telemetry_port=0,
                                            dispatch_profile=True)}
    times: dict = {way: [] for way in ways}
    for r in range(config["cost_rounds"]):
        order = list(ways) if r % 2 == 0 else list(ways)[::-1]
        for j, way in enumerate(order):
            random.seed(config["seed"] + 200 + 2 * r + j)
            spec = cubed_tpu_torch.Spec(work_dir=os.path.join(work, f"cost-{r}-{j}"), allowed_mem="2GB", **ways[way])
            x = vorticity_build(spec, config["full"])
            torch.cuda.synchronize()
            t = time.perf_counter()
            value = float(x.compute(executor=ex))
            torch.cuda.synchronize()
            times[way].append(time.perf_counter() - t)
            check(np.isfinite(value) and ex.stats["segment_struct_hits"] == 1,
                  f"analytics [cost, {way}]: value {value}, stats {dict(ex.stats)}")
            shutil.rmtree(spec.work_dir, ignore_errors=True)
    q = {way: [float(np.percentile(np.asarray(t) * 1e3, p)) for p in (25, 50, 75)] for way, t in times.items()}
    extra = q["armed"][1] - q["unobserved"][1]
    print(f"analytics [cost]: warm compute() over {config['cost_rounds']} turns each (ms, quartiles 25/50/75): "
          + "; ".join(f"{way} {a:.4f} / {m:.4f} / {b:.4f}" for way, (a, m, b) in q.items())
          + f"; arming costs {extra:+.4f} ms a compute ({extra / q['unobserved'][1]:+.1%}; the limit 1 ms or 5% is "
          f"not a gate); {smi_tag()}")
    out["cost_ms"] = q


def run_analytics_phase(torch, config=ANALYTICS, given=None) -> dict:
    """The analytics phase (see :data:`ANALYTICS`); *given* carries phase 4's
    oracle value and unobserved launches, and the observability phase's
    sequential run of the cut (the whole run passes them in; alone they are
    worked out first). Returns its summary."""
    from cubed_tpu_torch.observability import export

    t0 = time.perf_counter()
    work = os.path.join(WORK_DIR, f"analytics-{os.getpid()}")
    out: dict = {}
    try:
        ex, finish_top = analytics_device(torch, config, work, given, out)
        sequential = given.get("sequential") or sequential_cut_observed(torch, config)
        analytics_threads(torch, config, work, sequential, out)
        finish_top()
        finish_diagnose = analytics_failing(config, work, out)
        analytics_cost(torch, config, work, ex, out)
        finish_diagnose()
    finally:
        export.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"analytics phase: {out['seconds']:.1f} s in its process; {smi_tag()}")
    return out


def analytics_unobserved(torch) -> dict:
    """``--analytics-unobserved``: vorticity's oracle value and the launches
    of three unobserved computes of its seed on a new ``CudaExecutor`` in a
    process of its own (cold, capturing, warm), what the phase alone is held
    to."""
    expected = cached_oracle("vorticity", vorticity_oracle, ANALYTICS["seed"])
    runs = run_device_repeats(torch, "vorticity", vorticity_build, vorticity_oracle, {},
                              seeds=(ANALYTICS["seed"],) * 3, footprint=0)
    return dict(expected=expected, launches=[r["launches"] for r in runs])


# ---------------------------------------------------------------------------
# the order-statistics phase: sorts, quantiles, top-k, searches, histograms,
# cov/corrcoef and the nan reductions
# ---------------------------------------------------------------------------

#: pangeo's per-gridpoint climatology over the time axis: 4096 daily steps
#: (about 11 years) of a 256 x 256 tile, float64 (2.1 GB), in (512, 256,
#: 256) chunks (268 MB) under allowed_mem 2GB: the single-chunk slab along
#: time (2.1 GB, projected 4x) is over the budget, so ``auto`` routes sort
#: and argsort through the network (sort's chunks fit its merge as they are:
#: 8 chunks, 7 rounds; argsort's shrink to 171: 32 padded chunks, 16
#: rounds). (256, 128, 128) chunks under 500MB are refused at plan time by
#: both packages: sort's coarsening rechunk projects 604 MB, the histogram's
#: flatten 604 MB, top-k's merge 549 MB. searchsorted: a sorted 1-d array of
#: 2**24 against 2**20 queries; cov/corrcoef: (64, 2**20)
ORDER_STATS_FULL = dict(shape=(4096, 256, 256), chunks=(512, 256, 256), allowed_mem="2GB",
                        search=((2**24,), (2**21,), (2**20,), (2**17,)), cov=((64, 2**20), (64, 2**17)))
#: the phase in the whole run: the time axis cut to 2048 steps (1.07 GB;
#: sort 4 chunks, 4 rounds; argsort 12 chunks padded to 16, 11 rounds), the
#: chunk widths as they are, so the phase stays near 120 s of the run (225 s
#: at full depth alone, chip_smoke.py --order-stats-phase full)
ORDER_STATS = dict(ORDER_STATS_FULL, shape=(2048, 256, 256))
#: the sequential check's cut: each network round there is a full fsync'd
#: pass through storage (2.1 GB at full size); the depth of time and the
#: tile cut by 4 and 2, chunks (64, 64, 64)
ORDER_STATS_SEQ = dict(shape=(1024, 128, 128), chunks=(64, 64, 64), allowed_mem="500MB",
                       search=((2**20,), (2**17,), (2**16,), (2**13,)), cov=((64, 2**16), (64, 2**13)))
#: the network forced on the sequential executor: the cut array in (128,
#: 64, 64) chunks (8 along time: 7 rounds, where 16 chunks give 11 and
#: argsort's 791 tasks take 15 s)
ORDER_STATS_SEQ_NETWORK = dict(ORDER_STATS_SEQ, chunks=(128, 64, 64))
#: a time axis longer than 4096 steps (45 years of daily steps) in one chunk
#: (auto keeps it there: 33.5 MB blocks under 500MB), where torch.sort
#: leaves its in-place sort of short lanes for CUB's segmented sort: sort
#: and argsort gated with the merge kernels, then read with the plain
#: torch.sort bodies (the reason the kernels exist)
ORDER_STATS_SEQ_LONG = dict(ORDER_STATS_SEQ, shape=(16384, 32, 32), chunks=(16384, 16, 16))
ORDER_K = 16
ORDER_NAN_BELOW = 0.01
#: threads for the numpy oracles (numpy's sorts release the GIL)
ORACLE_THREADS = 8


def lanes_parallel(fn, a: np.ndarray) -> np.ndarray:
    """``fn(a)`` of a function along axis 0 (its result keeps the trailing
    axes), computed on slices of the last axis in threads."""
    n = a.shape[-1]
    step = -(-n // ORACLE_THREADS)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        parts = list(pool.map(lambda j: fn(a[..., j:j + step]), range(0, n, step)))
    return np.concatenate(parts, axis=-1)


#: each input's root seed: ``random.getrandbits(30)`` after
#: ``random.seed(SEED + ORDER_SEEDS[name])``, so each is drawn alike
#: whichever others an op builds
ORDER_SEEDS = {"x": 10, "x1": 11, "q": 12, "m": 13}


class order_stats_inputs:
    """The phase's random arrays (``cubed_tpu_torch.random.random``, the
    Philox kernels on the card), each made at an op's first use of it: x,
    its NaN-masked form xn, searchsorted's values x1 and queries q, cov's
    observations m (so an op's plan holds its own inputs alone)."""

    def __init__(self, spec, config):
        self.spec, self.config, self.made = spec, config, {}

    def __getitem__(self, name):
        import cubed_tpu_torch
        import cubed_tpu_torch.array_api as xp

        if name not in self.made:
            cfg = self.config
            if name == "xn":
                x = self["x"]
                nan = xp.asarray(float("nan"), dtype=xp.float64, spec=self.spec)
                self.made[name] = xp.where(xp.less(x, ORDER_NAN_BELOW), nan, x)
            else:
                shape, chunks = {"x": (cfg["shape"], cfg["chunks"]), "x1": (cfg["search"][0], cfg["search"][1]),
                                 "q": (cfg["search"][2], cfg["search"][3]), "m": cfg["cov"]}[name]
                random.seed(SEED + ORDER_SEEDS[name])
                self.made[name] = cubed_tpu_torch.random.random(shape, chunks=chunks, spec=self.spec)
        return self.made[name]


class OrderOracle:
    """numpy's draws of the same Philox blocks as :class:`order_stats_inputs`,
    and each op's expected value, computed at first use (the lane-wise
    sorts in threads)."""

    def __init__(self, config):
        def draw(name, shape, chunks):
            random.seed(SEED + ORDER_SEEDS[name])
            return oracle_random(shape, chunks, random.getrandbits(30))

        self.x = draw("x", config["shape"], config["chunks"])
        self.x1 = draw("x1", config["search"][0], config["search"][1])
        self.q = draw("q", config["search"][2], config["search"][3])
        self.m = draw("m", *config["cov"])
        self._cache = {}

    def get(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    @property
    def xn(self):
        return self.get("xn", lambda: np.where(self.x < ORDER_NAN_BELOW, np.nan, self.x))

    @property
    def sorted(self):
        return self.get("sorted", lambda: lanes_parallel(lambda a: np.sort(a, axis=0), self.x))

    @property
    def argsorted(self):
        return self.get("argsorted", lambda: lanes_parallel(lambda a: np.argsort(a, axis=0, kind="stable"),
                                                            self.x))

    def quantile(self, q):
        s = self.sorted
        pos = q * (s.shape[0] - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac


def _order_stats_ops(oracle: OrderOracle) -> dict:
    """name -> (build(xp, ct, inputs), expected(), comparison). A comparison
    is "exact", ("rtol", r), ("atol", a) or ("histogram", rtol)."""
    k = ORDER_K
    return {
        "sort": (lambda xp, ct, i: xp.sort(i["x"], axis=0), lambda: oracle.sorted, "exact"),
        "argsort": (lambda xp, ct, i: xp.argsort(i["x"], axis=0), lambda: oracle.argsorted, "exact"),
        "median": (lambda xp, ct, i: xp.median(i["x"], axis=0), lambda: np.median(oracle.sorted, axis=0),
                   ("rtol", 1e-12)),
        "quantile": (lambda xp, ct, i: xp.quantile(i["x"], 0.9, axis=0), lambda: oracle.quantile(0.9),
                     ("rtol", 1e-12)),
        "topk": (lambda xp, ct, i: xp.topk(i["x"], k, axis=0), lambda: oracle.sorted[::-1][:k], "exact"),
        "argtopk": (lambda xp, ct, i: xp.argtopk(i["x"], k, axis=0), lambda: oracle.argsorted[::-1][:k], "exact"),
        "nanmedian": (lambda xp, ct, i: xp.nanmedian(i["xn"], axis=0),
                      lambda: lanes_parallel(lambda a: np.nanmedian(a, axis=0), oracle.xn), ("rtol", 1e-12)),
        "nanmean": (lambda xp, ct, i: ct.nanmean(i["xn"], axis=0), lambda: np.nanmean(oracle.xn, axis=0),
                    ("rtol", 1e-12)),
        "nansum": (lambda xp, ct, i: ct.nansum(i["xn"], axis=0), lambda: np.nansum(oracle.xn, axis=0),
                   ("rtol", 1e-12)),
        "nanmax": (lambda xp, ct, i: ct.nanmax(i["xn"], axis=0), lambda: np.nanmax(oracle.xn, axis=0), "exact"),
        "nanmin": (lambda xp, ct, i: ct.nanmin(i["xn"], axis=0), lambda: np.nanmin(oracle.xn, axis=0), "exact"),
        "searchsorted": (lambda xp, ct, i: xp.searchsorted(xp.sort(i["x1"]), i["q"]),
                         lambda: np.searchsorted(np.sort(oracle.x1), oracle.q), "exact"),
        "histogram": (lambda xp, ct, i: xp.histogram(i["x"], bins=64), None, ("histogram", None)),
        "histogram_weighted": (lambda xp, ct, i: xp.histogram(i["x"], bins=64, weights=i["x"]), None,
                               ("histogram", HISTOGRAM_WEIGHTED_RTOL)),
        "cov": (lambda xp, ct, i: xp.cov(i["m"]), lambda: np.cov(oracle.m), ("atol", 1e-12)),
        "corrcoef": (lambda xp, ct, i: xp.corrcoef(i["m"]), lambda: np.corrcoef(oracle.m), ("atol", 1e-12)),
    }


#: the weighted histogram's counts add a bin's weights in the atomics'
#: order on the card (index_add_), about 4M of them a bin at full size: a
#: random walk of roundings, about sqrt(n) eps = 2e-13 of the bin; the
#: oracle sums each piece of 2**20 with bincount and the pieces with fsum
HISTOGRAM_WEIGHTED_RTOL = 1e-11


def histogram_oracle(x: np.ndarray, edges: np.ndarray, weighted: bool) -> np.ndarray:
    """numpy's histogram of *x* over the port's *edges* (held against
    numpy's own linspace edges separately): bin i is [e_i, e_i+1), the last
    closed; weighted by x itself, each bin summed piecewise (bincount over
    pieces of 2**20, the pieces' sums added exactly)."""
    flat = x.reshape(-1)
    n = len(edges) - 1
    if not weighted:
        return np.histogram(flat, bins=edges)[0]
    parts = []
    piece = 1 << 20
    for s in range(0, flat.size, piece):
        seg = flat[s:s + piece]
        idx = np.searchsorted(edges, seg, side="right")
        idx[seg == edges[-1]] = n
        parts.append(np.bincount(idx, weights=seg, minlength=n + 2)[1:n + 1])
    import math

    return np.array([math.fsum(p[i] for p in parts) for i in range(n)])


def compare_order(label, value, expected, how) -> float:
    """*value* against *expected* (numpy's): exact, rtol, or atol (cov,
    whose entries cancel). Returns the largest difference (relative for
    rtol, absolute for atol, 0 when exact)."""
    value = np.asarray(value)
    check(value.dtype == expected.dtype and value.shape == expected.shape,
          f"{label}: {value.dtype}{value.shape}, numpy's oracle {expected.dtype}{expected.shape}")
    if how == "exact":
        check(np.array_equal(value, expected, equal_nan=value.dtype.kind == "f"),
              f"{label}: not equal to the numpy oracle")
        return 0.0
    kind, tol = how
    if kind == "atol":
        err = float(np.max(np.abs(value - expected)))
        check(err <= tol, f"{label}: differs from the numpy oracle by {err} > atol {tol}")
        return err
    both_nan = np.isnan(value) & np.isnan(expected)
    check(bool(np.array_equal(np.isnan(value), np.isnan(expected))), f"{label}: NaNs differ from the oracle's")
    rel = float(np.max(np.where(both_nan, 0.0, np.abs(value - expected) / np.abs(expected))))
    check(rel <= tol, f"{label}: differs from the numpy oracle by rtol {rel} > {tol}")
    return rel


def check_order_value(label, out, expected_fn, how, oracle) -> float:
    """Hold one op's value against its oracle; a histogram's edges against
    numpy's linspace of the data's extent (rtol 1e-12) and its counts
    against numpy's over the same edges."""
    if isinstance(how, tuple) and how[0] == "histogram":
        counts, edges = (np.asarray(v) for v in out)
        lo, hi = float(oracle.x.min()), float(oracle.x.max())
        compare_order(f"{label} edges", edges, np.linspace(lo, hi, 65), ("rtol", 1e-12))
        expected = histogram_oracle(oracle.x, edges, weighted=how[1] is not None)
        return compare_order(f"{label} counts", counts, expected, "exact" if how[1] is None else ("rtol", how[1]))
    return compare_order(label, out, expected_fn(), how)


#: ragged, NaN-holding and integer cases of the merge kernels beside the
#: main path's shapes: (label, shape, axis, dtype)
MERGE_CASES = [
    ("nan, -0.0, ties", (37, 5, 3), 0, "float64"),
    ("inner axis", (6, 4, 65), 2, "float64"),
    ("float32", (33, 70), 0, "float32"),
    ("int64 extremes", (41, 9), 0, "int64"),
    ("uint8", (5, 130), 1, "uint8"),
    ("one element", (1, 4), 0, "float64"),
    ("contiguous lanes, 16-byte loads", (4, 1000), 1, "float32"),
    ("contiguous lanes past the tile, 16-byte loads", (2, 20000), 1, "int16"),
    # the last case has no merge-split check (its plain sorts take seconds)
    ("one long lane in one chunk", (16384, 32, 32), 0, "float64"),
]
MERGE_DTYPES = ("float64", "float32", "int64", "int32", "int16", "int8", "uint8")
#: lanes along axis 0 of a block with this many lanes beside them (not a
#: multiple of a tile's lane count), and lanes along the innermost axis
MERGE_INNER = 20


def merge_cases_past_tile() -> list:
    """Lanes of T + 1 and 3T + 5 elements, T the tile of the values sort's
    plan for the dtype and layout (a longer lane has merge passes), along
    axis 0 beside MERGE_INNER lanes and along the innermost axis, for every
    dtype of the kernels."""
    from cubed_tpu_torch.kernels import _geometry

    cases = []
    for dtype in MERGE_DTYPES:
        itemsize = np.dtype(dtype).itemsize
        for axis, inner in ((0, MERGE_INNER), (1, 1)):
            t = _geometry.sort_plan(1, 1 << 20, inner, itemsize, "values").tile
            for n in (t + 1, 3 * t + 5):
                shape = (n, MERGE_INNER) if axis == 0 else (3, n)
                cases.append((f"past the tile ({t}) along axis {axis}", shape, axis, dtype))
    return cases


def sort_launches(shape, axis: int, dtype: str, mode: str) -> int:
    """Launches of one sort call as its plan has them: the tile sort, then a
    merge pass a doubling of the tile up to the lane."""
    from cubed_tpu_torch.kernels import _geometry

    shape = tuple(shape)
    outer, n, inner = math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])
    return _geometry.sort_plan(outer, n, inner, np.dtype(dtype).itemsize, mode).launches


def _merge_data(torch, gen, shape, dtype):
    """Values with ties, NaNs and -0.0 (floats) or the dtype's extremes."""
    dev = torch.device("cuda")
    if dtype.startswith("float"):
        v = torch.randint(0, 7, shape, generator=gen, device=dev).to(getattr(torch, dtype)) * 0.5
        v[torch.rand(shape, generator=gen, device=dev) < 0.1] = float("nan")
        v[torch.rand(shape, generator=gen, device=dev) < 0.05] = -0.0
        return v
    info = torch.iinfo(getattr(torch, dtype))
    pool = torch.tensor([info.min, info.max, 0, 1, 2, 3], dtype=getattr(torch, dtype), device=dev)
    return pool[torch.randint(0, len(pool), shape, generator=gen, device=dev)]


def _same(a, b) -> bool:
    """Equal bit for bit (a float's -0.0 and NaN bits included)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]
        a, b = a.view(bits), b.view(bits)
    return bool(a.eq(b).all())


def check_merge_sort(torch, config=ORDER_STATS) -> list:
    """The merge kernels (csrc/merge_sort.cu) against their plain versions:
    at the order-statistics phase's shapes (a block of sort's network at its
    coarsened chunk, a block of argsort's, top-k's per-block order), at
    ragged, NaN-holding, integer and one-element cases, one long lane in
    one chunk, and lanes past a tile for every dtype along axis 0 and the
    innermost axis, bit for bit (the plain version run on the CPU: torch's
    stable CPU sort places NaN and -0.0 as numpy does); one launch per
    merge-split call, and per sort the launches of its plan (the tile sort,
    then its merge passes); timed beside their plain versions on the card,
    ``torch.sort``/``torch.argsort`` of the same data, and their byte
    bounds, at the phase's blocks and along 16384 steps."""
    import cubed_tpu_torch
    from cubed_tpu_torch.array_api._block_sort import _coarsen_for_network
    from cubed_tpu_torch.kernels import merge_sort as ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    spec = cubed_tpu_torch.Spec(work_dir=WORK_DIR, allowed_mem=config["allowed_mem"])
    x = cubed_tpu_torch.random.random(config["shape"], chunks=config["chunks"], spec=spec)
    c_sort = _coarsen_for_network(x, 0, with_idx=False).chunksize[0]
    c_arg = _coarsen_for_network(x, 0, with_idx=True).chunksize[0]
    lane = config["chunks"][1:]
    sort_shape, arg_shape, topk_shape = (c_sort,) + lane, (c_arg,) + lane, config["chunks"]

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)

    def passes(n):
        return max(0, (n - 1).bit_length())

    # correctness, bit for bit, against the plain versions on the CPU
    cases = [(f"main path {sort_shape}", sort_shape, 0, "float64"),
             (f"main path {arg_shape}", arg_shape, 0, "float64"),
             (f"main path {topk_shape}", topk_shape, 0, "float64")] + MERGE_CASES + merge_cases_past_tile()
    for case in cases:
        label, shape, axis, dtype = case
        v = rand(shape) if label.startswith("main") else _merge_data(torch, gen, shape, dtype)
        idx = torch.randperm(v.numel(), generator=gen, device=dev).reshape(shape)
        before = {k: getattr(ms, k).launches for k in ("sort_block", "argsort_block", "merge_split")}
        got_s = ms.sort_block(v, axis)
        got_p = ms.sort_block(v, axis, idx)
        got_a = ms.argsort_block(v, axis)
        torch.cuda.synchronize()
        what = f"merge kernels, {label} {dtype} axis {axis}"
        sv = ms.sort_block_plain(v.cpu(), axis)
        check(_same(got_s, sv), f"{what}: sort_block differs from its plain version")
        ref_p = ms.sort_block_plain(v.cpu(), axis, idx.cpu())
        check(_same(got_p[0], ref_p[0]) and _same(got_p[1], ref_p[1]), f"{what}: sort_block with indices differs")
        check(_same(got_a, ms.argsort_block_plain(v.cpu(), axis)), f"{what}: argsort_block differs")
        launched = {k: getattr(ms, k).launches - before[k] for k in before}
        want = {"sort_block": sort_launches(shape, axis, dtype, "values") + sort_launches(shape, axis, dtype, "pairs"),
                "argsort_block": sort_launches(shape, axis, dtype, "argsort"), "merge_split": 0}
        check(launched == want, f"{what}: launches {launched}, expected {want}")
    # each counted sort launch is a kernel the device ran: the profiler's
    # records of the tile sort and the merge passes against the counts, at
    # the phase's blocks, past a tile and along 16384 steps
    rec = [rand(shape) for shape in (sort_shape, topk_shape, ORDER_STATS_SEQ_LONG["shape"])]
    past = [c[1] for c in merge_cases_past_tile() if c[2] == 0 and c[3] == "float64"][-1]  # 3T+5 along axis 0
    rec.append(_merge_data(torch, gen, past, "float64"))
    rec_idx = [torch.randperm(v.numel(), generator=gen, device=dev).reshape(v.shape) for v in rec]
    sort_kernels = ("sort_tiles_kernel", "sort_merge_kernel")
    one_launch_per_call(torch, ms.sort_block, sort_kernels,
                        [lambda v=v: ms.sort_block(v, 0) for v in rec]
                        + [lambda v=v, i=i: ms.sort_block(v, 0, i) for v, i in zip(rec, rec_idx)])
    one_launch_per_call(torch, ms.argsort_block, sort_kernels, [lambda v=v: ms.argsort_block(v, 0) for v in rec])
    del rec, rec_idx
    print(f"merge kernels: sort_block and argsort_block equal their plain versions (bit for bit) over "
          f"{len(cases)} cases (the phase's blocks {sort_shape}, {arg_shape}, {topk_shape}; NaN, -0.0, ties, "
          f"integer extremes, ragged, one element, (16384, 32, 32), lanes past a tile for each of "
          f"{len(MERGE_DTYPES)} dtypes on both axes); the plan's launches a sort")

    out = []
    # sort_block: the network's local round of sort
    v = [rand(sort_shape) for _ in range(2)]
    ms_ = time_ms(torch, ms.sort_block, [(t, 0) for t in v], reps=5)
    plain = time_ms(torch, ms.sort_block_plain, [(t, 0) for t in v], reps=5)
    lib = time_ms(torch, lambda t: torch.sort(t, dim=0, stable=True), [(t,) for t in v], reps=5)
    b, by = bound_ms(2 * 8 * v[0].numel(), v[0].numel() * passes(sort_shape[0]))
    print(f"sort_block {sort_shape} f64 axis 0 ({sort_launches(sort_shape, 0, 'float64', 'values')} launch(es)): "
          f"{ms_:.5f} ms ({100 * b / ms_:.1f}% of bound); plain {plain:.5f} ms; torch.sort {lib:.5f} ms; bound "
          f"{b:.5f} ms ({by}: the block read and written once); {smi_tag()}")
    out.append(dict(name="sort_block", route="cuda", source="cubed_tpu_torch/kernels/csrc/merge_sort.cu",
                    replaces="cubed_tpu/array_api/_block_sort.py:210 (jnp.sort of the local round; not Pallas)",
                    max_abs_err=0.0, ms=ms_, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))
    # argsort_block: top-k's per-block order
    v = [rand(topk_shape) for _ in range(2)]
    ms_ = time_ms(torch, ms.argsort_block, [(t, 0) for t in v], reps=5)
    plain = time_ms(torch, ms.argsort_block_plain, [(t, 0) for t in v], reps=5)
    lib = time_ms(torch, lambda t: torch.argsort(t, dim=0, stable=True), [(t,) for t in v], reps=5)
    b, by = bound_ms((8 + 8) * v[0].numel(), v[0].numel() * passes(topk_shape[0]))
    print(f"argsort_block {topk_shape} f64 axis 0 ({sort_launches(topk_shape, 0, 'float64', 'argsort')} "
          f"launch(es)): {ms_:.5f} ms ({100 * b / ms_:.1f}% of bound); plain {plain:.5f} ms; torch.argsort "
          f"{lib:.5f} ms; bound {b:.5f} ms ({by}: the block read once, int64 indices written once); {smi_tag()}")
    out.append(dict(name="argsort_block", route="cuda", source="cubed_tpu_torch/kernels/csrc/merge_sort.cu",
                    replaces="cubed_tpu/array_api/sorting_functions.py:249 (jnp.argsort in "
                             "_stable_argsort_kernel; not Pallas)",
                    max_abs_err=0.0, ms=ms_, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))
    # along 16384 steps in one chunk: the tile sort and its merge passes
    long = ORDER_STATS_SEQ_LONG["shape"]
    v = [rand(long) for _ in range(2)]
    for name, fn, plain_fn, lib_fn, mode, out_bytes in (
            ("sort_block", ms.sort_block, ms.sort_block_plain, torch.sort, "values", 8),
            ("argsort_block", ms.argsort_block, ms.argsort_block_plain, torch.argsort, "argsort", 8)):
        t = time_ms(torch, fn, [(a, 0) for a in v], reps=5)
        plain = time_ms(torch, plain_fn, [(a, 0) for a in v], reps=5)
        lib = time_ms(torch, lambda a: lib_fn(a, dim=0, stable=True), [(a,) for a in v], reps=5)
        b, by = bound_ms((8 + out_bytes) * v[0].numel(), v[0].numel() * passes(long[0]))
        print(f"{name} {long} f64 axis 0 ({sort_launches(long, 0, 'float64', mode)} launches): {t:.5f} ms "
              f"({100 * b / t:.1f}% of bound); plain {plain:.5f} ms; torch.{lib_fn.__name__} {lib:.5f} ms; bound "
              f"{b:.5f} ms ({by}); {smi_tag()}")
    out.append(check_merge_split(torch, sort_shape, arg_shape))
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return out


#: merge_split's inputs beyond the mixed ones (NaN, -0.0, ties): lanes of
#: equal keys whose bits differ (x all -0.0 or NaN with a payload, y all
#: 0.0 or the default NaN: the stable merge keeps x's first), and x wholly
#: below or wholly above y
SPLIT_KINDS = ("mixed", "equal keys", "x below y", "x above y")


def _split_inputs(torch, gen, shape, axis: int, dtype: str, kind: str) -> tuple:
    """Two blocks of one of SPLIT_KINDS on the CPU, each sorted along *axis*
    with int64 indices carried (few distinct indices: ties of (value,
    index)): (x, y, xi, yi, sorted x, sorted y) -- values alone sorted
    apart from the pairs."""
    dt = getattr(torch, dtype)
    if kind == "mixed":
        x, y = (_merge_data(torch, gen, shape, dtype).cpu() for _ in range(2))
    elif kind == "equal keys":
        if dtype.startswith("float"):
            bits = {"float64": torch.int64, "float32": torch.int32}[dtype]
            x, y = torch.full(shape, -0.0, dtype=dt), torch.zeros(shape, dtype=dt)
            nan = torch.tensor(float("nan"), dtype=dt)
            payload = (nan.view(bits) + 1).view(dt)  # a NaN with other bits
            # every other lane NaN, its NaNs in x with the other bits
            lane_shape = tuple(1 if d == axis else k for d, k in enumerate(shape))
            where = (torch.arange(math.prod(lane_shape)) % 2 == 0).reshape(lane_shape)
            x, y = torch.where(where, payload, x), torch.where(where, nan, y)
        else:
            x, y = torch.full(shape, 3, dtype=dt), torch.full(shape, 3, dtype=dt)
    else:
        lo = torch.randint(0, 10, shape, generator=torch.Generator().manual_seed(int(shape[axis]))).to(dt)
        hi = lo + 20
        x, y = (lo, hi) if kind == "x below y" else (hi, lo)
    cpu = torch.Generator().manual_seed(int(torch.randint(0, 2**30, (1,), generator=gen, device=gen.device)))
    xi, yi = (torch.randint(0, 4, shape, generator=cpu) for _ in range(2))
    from cubed_tpu_torch.kernels import merge_sort as ms

    (px, pxi), (py, pyi) = ms.sort_block_plain(x, axis, xi), ms.sort_block_plain(y, axis, yi)
    return px, py, pxi, pyi, ms.sort_block_plain(x, axis), ms.sort_block_plain(y, axis)


def split_over_read(torch, x, y, take_low: bool, p, item_bytes: int) -> float:
    """The bytes merge_split's loads cover over its bound's, for sorted
    float blocks *x*, *y* along axis 0 (one lane group's outer index, no
    NaN): each CTA's sector groups read the union of their lanes' segment
    rows, ``sector`` lanes a row (fewer at a ragged edge), and every output
    is written once; the bound reads n elements a lane and writes n.
    *item_bytes*: an element's bytes with its carried index. The splits are
    found here from ranks (each x element's place in the stable merge: its
    position plus y's elements strictly before it)."""
    n, inner = p.n, p.inner
    xt, yt = x.reshape(n, inner).t().contiguous(), y.reshape(n, inner).t().contiguous()
    rank = torch.arange(n, device=x.device) + torch.searchsorted(yt, xt, side="left")
    ends = torch.tensor([min(n, k * p.tile) for k in range(p.tiles_n + 1)], device=x.device)
    ends = ends + (0 if take_low else n)
    splits = torch.searchsorted(rank, ends.expand(inner, -1).contiguous(), side="left")
    i0, i1 = splits[:, :-1], splits[:, 1:]  # (inner, tiles_n)
    tn = (ends[1:] - ends[:-1])[None, :]
    groups = -(-inner // p.sector)
    pad = groups * p.sector - inner

    def grouped(t, fill):
        t = torch.cat([t, torch.full((pad, t.shape[1]), fill, device=t.device, dtype=t.dtype)]) if pad else t
        return t.reshape(groups, p.sector, -1)

    big = 2 * n + 1
    min0, max0 = grouped(i0, big).amin(1), grouped(i0, -big).amax(1)
    min1, max1 = grouped(i1, big).amin(1), grouped(i1, -big).amax(1)
    width = torch.clamp(inner - torch.arange(groups, device=x.device) * p.sector, max=p.sector)[:, None]
    rows = (max1 - min0) + (tn + max0 - min1)
    loaded = int((rows * width).sum()) * item_bytes
    return (loaded + n * inner * item_bytes) / (2 * n * inner * item_bytes)


def check_merge_split(torch, sort_shape, arg_shape) -> dict:
    """merge_split (csrc/merge_sort.cu) against its plain version, bit for
    bit: the low and the high half, values and pairs (int64 indices
    carried, few distinct: ties of (value, index)), every dtype of the
    kernels, each of SPLIT_KINDS, lanes of 171 steps and past a tile
    (``split_plan``'s, T + 1 and 3T + 5) along axis 0 beside MERGE_INNER
    lanes (ragged lane groups) and along the innermost axis (inner 1, three
    lane groups, each its own flag); the phase's pairs (sort's *sort_shape*
    values, argsort's *arg_shape* pairs, the plain version on the card);
    a vmapped batch with a flag an example, one launch. Each call one
    launch, held against torch.profiler's merge_split_kernel records. Timed
    at the phase's shapes beside the plain version, ``torch.sort`` of the
    concatenated pair and the two-block bound, with the over-read (bytes
    the loads cover over the bound's). Returns the kernels line's entry."""
    from cubed_tpu_torch.kernels import _geometry
    from cubed_tpu_torch.kernels import merge_sort as ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    calls = 0
    before = ms.merge_split.launches

    def held(what, x, y, flags, axis, xi=None, yi=None):
        nonlocal calls
        got = ms.merge_split(x.to(dev), y.to(dev), flags.to(dev), axis,
                             *(() if xi is None else (xi.to(dev), yi.to(dev))))
        calls += 1
        ref = ms.merge_split_plain(x, y, flags, axis, xi, yi)
        torch.cuda.synchronize()
        if xi is None:
            check(_same(got, ref), f"merge_split {what}: values differ from the plain version")
        else:
            check(_same(got[0], ref[0]) and _same(got[1], ref[1]), f"merge_split {what}: pairs differ")

    cases = 0
    for dtype in MERGE_DTYPES:
        itemsize = np.dtype(dtype).itemsize
        for axis, inner in ((0, MERGE_INNER), (1, 1)):
            t = _geometry.split_plan(1, 1 << 20, inner, itemsize, "values").tile
            for n in (171, t + 1, 3 * t + 5):
                shape = (n, inner) if axis == 0 else (3, n)
                for kind in SPLIT_KINDS if n < 3 * t else SPLIT_KINDS[:1]:
                    x, y, xi, yi, sx, sy = _split_inputs(torch, gen, shape, axis, dtype, kind)
                    flags = torch.rand(shape[:axis] + (1,) * (2 - axis), generator=gen, device=dev).cpu() < 0.5
                    for f in (flags, ~flags):
                        what = f"{dtype} {shape} axis {axis} {kind} take_low {f.reshape(-1).tolist()}"
                        held(what, sx, sy, f, axis)
                        held(what + " with indices", x, y, f, axis, xi, yi)
                    cases += 1
    # the phase's pairs, the plain version on the card (no NaN: its
    # torch.sort places every value as the CPU's)
    for shape, with_idx in ((sort_shape, False), (sort_shape, True), (arg_shape, True)):
        x, y = (ms.sort_block(torch.rand(shape, generator=gen, device=dev, dtype=torch.float64), 0)
                for _ in range(2))
        xi = torch.randperm(x.numel(), generator=gen, device=dev).reshape(shape)
        yi = xi + x.numel()
        for low in (True, False):
            f = torch.tensor(low, device=dev)
            got = ms.merge_split(x, y, f, 0, *((xi, yi) if with_idx else ()))
            calls += 1
            ref = ms.merge_split_plain(x, y, f, 0, *((xi, yi) if with_idx else ()))
            torch.cuda.synchronize()
            same = _same(got[0], ref[0]) and _same(got[1], ref[1]) if with_idx else _same(got, ref)
            check(same, f"merge_split main path {shape} indices {with_idx} take_low {low}: differs")
        del x, y, xi, yi, got, ref
    # a vmapped batch: one launch, each example its own flag
    for dtype in ("float64", "int8"):
        t = _geometry.split_plan(1, 1 << 20, MERGE_INNER, np.dtype(dtype).itemsize, "values").tile
        shape = (t + 1, MERGE_INNER)
        blocks = [_split_inputs(torch, gen, shape, 0, dtype, "mixed") for _ in range(3)]
        flags = torch.tensor([True, False, True])
        xs, ys, xis, yis, sxs, sys_ = (torch.stack([b[k] for b in blocks]).to(dev) for k in range(6))
        n0 = ms.merge_split.launches
        got = torch.func.vmap(lambda a, b, f: ms.merge_split(a, b, f, 0))(sxs, sys_, flags.to(dev))
        got_p = torch.func.vmap(lambda a, b, i, j, f: ms.merge_split(a, b, f, 0, i, j))(xs, ys, xis, yis,
                                                                                       flags.to(dev))
        torch.cuda.synchronize()
        calls += 2
        check(ms.merge_split.launches - n0 == 2, f"merge_split vmapped {dtype}: {ms.merge_split.launches - n0} "
                                                 f"launches for two calls")
        for k, b in enumerate(blocks):
            check(_same(got[k], ms.merge_split_plain(b[4], b[5], flags[k], 0)),
                  f"merge_split vmapped {dtype}: example {k} differs")
            ref = ms.merge_split_plain(b[0], b[1], flags[k], 0, b[2], b[3])
            check(_same(got_p[0][k], ref[0]) and _same(got_p[1][k], ref[1]),
                  f"merge_split vmapped {dtype} with indices: example {k} differs")
    check(ms.merge_split.launches - before == calls, f"merge_split: {ms.merge_split.launches - before} launches "
                                                      f"for {calls} calls")
    print(f"merge_split: equal to its plain version (bit for bit) in {calls} calls, one launch each: "
          f"{cases} cases of {len(MERGE_DTYPES)} dtypes x lanes of 171, T + 1 and 3T + 5 along axis 0 "
          f"({MERGE_INNER} lanes) and the innermost axis x {SPLIT_KINDS}, both halves, values and pairs; the "
          f"phase's pairs {sort_shape} and {arg_shape}; vmapped batches of 3 with a flag each")

    # each counted launch a kernel the device ran
    rec = [(ms.sort_block(torch.rand(shape, generator=gen, device=dev, dtype=torch.float64), 0), shape)
           for shape in (sort_shape, sort_shape, arg_shape, arg_shape)]
    low, high = torch.tensor(True, device=dev), torch.tensor(False, device=dev)
    zeros, ones = (torch.full(arg_shape, k, dtype=torch.int64, device=dev) for k in (0, 1))
    one_launch_per_call(torch, ms.merge_split, "merge_split_kernel", [
        lambda: ms.merge_split(rec[0][0], rec[1][0], low, 0),
        lambda: ms.merge_split(rec[2][0], rec[3][0], high, 0),
        lambda: ms.merge_split(rec[2][0], rec[3][0], low, 0, zeros, ones)])
    del rec, zeros, ones

    def pair(shape, with_idx):
        x, y = (ms.sort_block(torch.rand(shape, generator=gen, device=dev, dtype=torch.float64), 0)
                for _ in range(2))
        if not with_idx:
            return x, y
        xi = torch.randperm(x.numel(), generator=gen, device=dev).reshape(shape)
        return x, y, xi, xi + x.numel()

    # the values at sort's pair: the kernels line's entry
    pairs = [pair(sort_shape, False) for _ in range(2)]
    n = pairs[0][0].numel()
    t_low = time_ms(torch, ms.merge_split, [(x, y, low, 0) for x, y in pairs], reps=10)
    t_high = time_ms(torch, ms.merge_split, [(x, y, high, 0) for x, y in pairs], reps=10)
    plain = time_ms(torch, ms.merge_split_plain, [(x, y, low, 0) for x, y in pairs], reps=5)
    cats = [(torch.cat([x, y], dim=0),) for x, y in pairs]
    lib = time_ms(torch, lambda t: torch.sort(t, dim=0, stable=True), cats, reps=5)
    del cats
    b, by = bound_ms(2 * 8 * n, n)
    p = _geometry.split_plan(1, sort_shape[0], n // sort_shape[0], 8, "values")
    over = [split_over_read(torch, x, y, lo, p, 8) for x, y in pairs[:1] for lo in (True, False)]
    print(f"merge_split {sort_shape} f64 pair ({p.tiles} CTAs of {p.tile} x {p.lanes}, sector groups of "
          f"{p.sector} lanes): low half {t_low:.5f} ms ({100 * b / t_low:.1f}% of bound), high half {t_high:.5f} "
          f"ms; plain {plain:.5f} ms; torch.sort of the concatenated pair {lib:.5f} ms; bound {b:.5f} ms ({by}: "
          f"one block read, one written; PR 11's three-block figure {1.5 * b:.5f} ms); loads and stores cover "
          f"{over[0]:.4f} (low) and {over[1]:.4f} (high) of the bound's bytes; {smi_tag()}")
    del pairs
    # the pairs path at argsort's network chunk
    pairs = [pair(arg_shape, True) for _ in range(2)]
    n = pairs[0][0].numel()
    t_pairs = time_ms(torch, lambda x, y, i, j: ms.merge_split(x, y, low, 0, i, j), pairs, reps=10)
    plain_pairs = time_ms(torch, lambda x, y, i, j: ms.merge_split_plain(x, y, low, 0, i, j), pairs, reps=3)
    bp, byp = bound_ms(2 * (8 + 8) * n, n)
    pp = _geometry.split_plan(1, arg_shape[0], n // arg_shape[0], 8, "pairs")
    over_p = split_over_read(torch, pairs[0][0], pairs[0][1], True, pp, 16)
    print(f"merge_split {arg_shape} f64 + int64 indices ({pp.tiles} CTAs of {pp.tile} x {pp.lanes}): "
          f"{t_pairs:.5f} ms ({100 * bp / t_pairs:.1f}% of bound); plain {plain_pairs:.5f} ms; bound {bp:.5f} ms "
          f"({byp}: a block of values and indices read, one written; PR 11's three-block figure {1.5 * bp:.5f} "
          f"ms); loads and stores cover {over_p:.4f} of the bound's bytes; {smi_tag()}")
    del pairs
    return dict(name="merge_split", route="cuda", source="cubed_tpu_torch/kernels/csrc/merge_sort.cu",
                replaces="cubed_tpu/array_api/_block_sort.py:220 (jnp.sort of the concatenated pair in "
                         "_round_ops; not Pallas)",
                max_abs_err=0.0, ms=t_low, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)


def _net_chunk(config, with_idx: bool) -> int:
    """The time-axis chunk of the sort network's blocks for *config* (after
    ``auto``'s coarsening or shrinking)."""
    import cubed_tpu_torch
    from cubed_tpu_torch.array_api._block_sort import _coarsen_for_network

    spec = cubed_tpu_torch.Spec(work_dir=WORK_DIR, allowed_mem=config["allowed_mem"])
    x = cubed_tpu_torch.random.random(config["shape"], chunks=config["chunks"], spec=spec)
    return _coarsen_for_network(x, 0, with_idx=with_idx).chunksize[0]


def order_kernel_wrappers() -> dict:
    """The order-statistics path's kernels: Philox and region_sum beside
    the merge kernels."""
    from cubed_tpu_torch.kernels.merge_sort import argsort_block, merge_split, sort_block
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.kernels.region_sum import region_sum

    return {"philox_uniform": philox_uniform, "region_sum": region_sum, "sort_block": sort_block,
            "argsort_block": argsort_block, "merge_split": merge_split}


@contextlib.contextmanager
def plain_sort_bodies():
    """``nxp.sort`` and ``nxp.argsort`` as their plain versions
    (``torch.sort``/``torch.argsort``, stable) in place of the merge
    kernels, on the card too: to read their task peaks."""
    from cubed_tpu_torch.backend_array_api import nxp
    from cubed_tpu_torch.kernels import merge_sort as ms

    saved = nxp.sort, nxp.argsort
    nxp.sort = lambda x, axis=-1, stable=True: ms.sort_block_plain(x, axis)
    nxp.argsort = lambda x, axis=-1, stable=True: ms.argsort_block_plain(x, axis)
    try:
        yield
    finally:
        nxp.sort, nxp.argsort = saved


def _compute_both(arr):
    """compute() of an op's result: one array, or histogram's (counts,
    edges) pair computed together."""
    import cubed_tpu_torch

    if isinstance(arr, tuple):
        return arr, lambda **kw: cubed_tpu_torch.compute(*arr, **kw)
    return arr, lambda **kw: arr.compute(**kw)


def _network_rounds(arr) -> dict:
    """The bitonic ops of a plan, by name (an op fused from rounds counts
    once)."""
    from cubed_tpu_torch.core.plan import iter_op_nodes

    arrs = arr if isinstance(arr, tuple) else (arr,)
    names: dict = {}
    for a in arrs:
        for _, d in iter_op_nodes(a.plan.dag):
            if "bitonic" in d["op_name"]:
                names[d["op_name"]] = names.get(d["op_name"], 0) + 1
    return names


def run_order_stats_phase(torch, config=ORDER_STATS, seq_config=ORDER_STATS_SEQ) -> dict:
    """The order-statistics phase (see the module docstring). Returns each
    op's numbers and the kernels' launches over the phase's first device
    computes."""
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.array_api.sorting_functions import NETWORK_ENV_VAR
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    t0 = time.perf_counter()
    wrappers = order_kernel_wrappers()
    print(f"order-statistics phase: x {config['shape']} float64 in {config['chunks']} chunks, allowed_mem "
          f"{config['allowed_mem']}; searchsorted {config['search'][0]} / {config['search'][1]} against "
          f"{config['search'][2]} / {config['search'][3]}; cov {config['cov'][0]} / {config['cov'][1]}; "
          f"sequential check cut to {seq_config['shape']} in {seq_config['chunks']} chunks; {smi_tag()}")
    oracle = OrderOracle(config)
    seq_oracle = OrderOracle(seq_config)
    net_config = dict(seq_config, chunks=ORDER_STATS_SEQ_NETWORK["chunks"])
    net_oracle = OrderOracle(net_config)
    long_oracle = OrderOracle(ORDER_STATS_SEQ_LONG)
    print(f"order-statistics phase: numpy oracle inputs {time.perf_counter() - t0:.1f} s")
    ops = _order_stats_ops(oracle)
    seq_ops = _order_stats_ops(seq_oracle)
    net_ops = _order_stats_ops(net_oracle)
    long_ops = _order_stats_ops(long_oracle)
    seq_configs = {None: (seq_config, seq_oracle, seq_ops), "force": (net_config, net_oracle, net_ops),
                   "long": (ORDER_STATS_SEQ_LONG, long_oracle, long_ops)}
    # the sequential check's extra cases: the network forced at the cut
    # (where auto keeps the slab in one chunk), so its rounds' peaks count
    seq_cases = ([(name, None) for name in seq_ops] + [("sort", "force"), ("argsort", "force")]
                 + [("sort", "long"), ("argsort", "long")])
    # cuBLAS takes its workspace (32 MiB on Hopper) from the caching
    # allocator at a process's first GEMM and keeps it: a warm-up product
    # makes that once-a-process allocation before any task's peak is read
    torch.matmul(torch.ones((8, 8), dtype=torch.float64, device="cuda"),
                 torch.ones((8, 8), dtype=torch.float64, device="cuda"))
    torch.cuda.synchronize()

    def sequential(name, mode):
        """*name* of case *mode* on the sequential executor under allowed_mem
        equal to its plan's projected memory: (array, value, seconds, task
        peaks, projected)."""
        cfg, _, case_ops = seq_configs[mode]
        old_mode = os.environ.get(NETWORK_ENV_VAR)
        if mode == "force":
            os.environ[NETWORK_ENV_VAR] = mode
        try:
            work = os.path.join(WORK_DIR, f"order-seq-{name}")
            probe = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=cfg["allowed_mem"], reserved_mem=0)
            arr = case_ops[name][0](xp, cubed_tpu_torch, order_stats_inputs(probe, cfg))
            arrs = arr if isinstance(arr, tuple) else (arr,)
            projected = max(a.plan.max_projected_mem() for a in arrs)
            tight = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=projected, reserved_mem=0)
            arr, run = _compute_both(case_ops[name][0](xp, cubed_tpu_torch, order_stats_inputs(tight, cfg)))
            peaks = TaskPeaks(torch)
            t = time.perf_counter()
            value = run(callbacks=[peaks])
            seq_s = time.perf_counter() - t
        finally:
            if mode == "force":
                if old_mode is None:
                    os.environ.pop(NETWORK_ENV_VAR)
                else:
                    os.environ[NETWORK_ENV_VAR] = old_mode
        shutil.rmtree(work, ignore_errors=True)
        return arr, value, seq_s, peaks, projected

    results = {}
    phase_launches = dict.fromkeys(wrappers, 0)
    for name, mode in seq_cases:
        cfg, case_oracle, case_ops = seq_configs[mode]
        _, expected_fn, how = case_ops[name]
        label = name + {None: " [sequential, cut]",
                        "force": f" [network forced, {cfg['chunks']} chunks] [sequential, cut]",
                        "long": f" [{cfg['shape']} in {cfg['chunks']} chunks] [sequential]"}[mode]
        arr, value, seq_s, peaks, projected = sequential(name, mode)
        err = check_order_value(label, value, expected_fn, how, case_oracle)
        ratio = peaks.worst / projected
        print(f"{label}: compute() {seq_s:.3f} s, {peaks.tasks} tasks, network ops {json.dumps(_network_rounds(arr))};"
              f" largest task device peak {peaks.worst} B ({peaks.worst_op}) / projected {projected} B = "
              f"{ratio:.4f} ({peaks.guard_note()}); max err {err:.3e}; {smi_tag()}")
        check(ratio <= 1.0, f"{label}: a task's device peak {peaks.worst} B is over its projected {projected} B")
        entry = dict(seq_s=seq_s, ratio=ratio, peak=peaks.worst, projected=projected)
        if mode == "long":
            with plain_sort_bodies():
                _, value, _, plain, _ = sequential(name, mode)
            check_order_value(f"{label} [plain torch.sort bodies]", value, expected_fn, how, case_oracle)
            entry["plain_ratio"] = plain.worst / projected
            print(f"{label} with the plain torch.sort bodies (not the port's): largest task device peak {plain.worst} B"
                  f" / projected {projected} B = {entry['plain_ratio']:.4f}; {smi_tag()}")
        results[name + {None: "", "force": "_network", "long": "_long"}[mode] + "_seq"] = entry

    for name, (build, expected_fn, how) in ops.items():
        work = os.path.join(WORK_DIR, f"order-{name}")
        spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem=config["allowed_mem"])
        arr, run = _compute_both(build(xp, cubed_tpu_torch, order_stats_inputs(spec, config)))
        ex = CudaExecutor()
        times, launches, stats = [], [], []
        for i in range(2):
            for w in wrappers.values():
                w.launches = 0  # just before the compute: its launches alone
            t = time.perf_counter()
            value = run(executor=ex)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches.append({k: w.launches for k, w in wrappers.items()})
            stats.append(dict(sorted(ex.stats.items())))
            err = check_order_value(f"{name} [cuda, compute {i + 1}]", value, expected_fn, how, oracle)
            for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
                check(ex.stats.get(counter, 0) == 0, f"{name} [cuda]: {counter} = {ex.stats.get(counter)}")
        for k, n in launches[0].items():
            phase_launches[k] += n
        copies = host_device_copies(torch, lambda: run(executor=ex))
        outs = arr if isinstance(arr, tuple) else (arr,)
        out_chunks = sum(int(np.prod(a.numblocks)) if a.shape else 1 for a in outs if a.chunkmem >= 64 * 1024)
        crossing = copies["HtoD"] + max(0, copies["DtoH"] - out_chunks)
        print(f"{name} [cuda]: compute() cold {times[0]:.3f} s, warm {times[1]:.3f} s; network ops "
              f"{json.dumps(_network_rounds(arr))}; stats cold {json.dumps(stats[0])}; warm {json.dumps(stats[1])}; "
              f"launches cold {json.dumps(launches[0])}, warm {json.dumps(launches[1])}; host<->card copies of a "
              f"profiled warm compute {json.dumps(copies)} (the output's write: {out_chunks} chunks), beyond it "
              f"{crossing}; max err {err:.3e}; {smi_tag()}")
        check(copies["unsized"] == 0, f"{name} [cuda]: the profiler recorded copies without their bytes")
        check(crossing == 0, f"{name} [cuda]: data crossed between host and card beyond the output's writes "
                             f"({copies})")
        timed = copies.get("kernels_us", {})
        split = timed.get("merge_split_kernel")
        if split and name in ("sort", "argsort"):
            # a round: one merge-split launch over every block of the
            # (padded) array; its bound, one block read and one written a
            # task: two of the array's bytes (values, and argsort's int64
            # indices), over 3.35 TB/s. Beside it, the partner gather of
            # the round's permuted leaves (torch.index_select)
            padded = math.prod(config["shape"][1:]) * (1 << max(0, (-(-config["shape"][0] // _net_chunk(
                config, name == "argsort")) - 1).bit_length())) * _net_chunk(config, name == "argsort")
            round_bytes = 2 * padded * (8 + (8 if name == "argsort" else 0))
            round_ms = split[0] / 1e3 / split[1]
            bound = round_bytes / HBM_BYTES_PER_S * 1e3
            gather = timed.get("indexSelect", [0.0, 0])
            gather_ms = gather[0] / 1e3 / split[1]
            every = timed.get("all", [0.0, 0])
            print(f"{name} [cuda]: a bitonic round (one merge_split launch, profiled warm compute): {round_ms:.3f} ms "
                  f"over {split[1]} records; bound {bound:.3f} ms ({round_bytes / 1e9:.2f} GB moved), "
                  f"{100 * bound / round_ms:.1f}% of it (PR 11's three-block bound {1.5 * bound:.3f} ms); the "
                  f"partner gather (index_select) {gather_ms:.3f} ms a round ({gather[1]} records in the compute), "
                  f"{100 * gather_ms / (gather_ms + round_ms):.1f}% of gather + merge_split; every kernel of the "
                  f"compute {every[0] / 1e3:.3f} ms over {every[1]} records; {smi_tag()}")
            results_round = dict(round_ms=round_ms, round_bound_ms=bound, gather_ms=gather_ms,
                                 kernels_ms=every[0] / 1e3)
        else:
            results_round = {}
        shutil.rmtree(work, ignore_errors=True)
        results[name] = dict(cold_s=times[0], warm_s=times[1], stats=stats[1], launches=launches[0],
                             copies=crossing, rounds=_network_rounds(arr), err=err, **results_round)
    for k, n in phase_launches.items():
        check(n > 0, f"order-statistics phase: {k} was never launched by the phase's device computes")
    print(f"order-statistics phase: launches over the first device computes {json.dumps(phase_launches)}; "
          f"{time.perf_counter() - t0:.1f} s; {smi_tag()}")
    return dict(ops=results, launches=phase_launches)


# ---------------------------------------------------------------------------
# phase 5: where the time goes
# ---------------------------------------------------------------------------


def profiled(torch, fn) -> tuple:
    """Run *fn* under torch.profiler's CUDA activity; returns (wall seconds,
    kernel seconds, copy seconds, the five kernels with the most device
    time, why the device time is missing or None, every kernel as
    (seconds, launches, name))."""
    from torch.profiler import ProfilerActivity, profile

    prof, why = profile(activities=[ProfilerActivity.CUDA]), "the profiler recorded no device events"
    try:
        prof.start()
        time.sleep(PROFILE_PAD_S)
        torch.cuda._sleep(SENTINEL_CYCLES)
    except (AssertionError, RuntimeError) as e:  # no CUDA tracing available here
        prof, why = None, f"the profiler did not start: {e!r}"
    t0 = time.perf_counter()  # the profiler's own start-up is not the run's
    try:
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    finally:
        if prof is not None:
            prof.stop()
    kernels_s = copies_s = 0.0
    by_kernel = []
    for e in prof.key_averages() if prof is not None else ():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e6
        if e.key.startswith(("Memcpy", "Memset")):
            copies_s += t
        elif t > 0 and SENTINEL_KERNEL not in e.key:
            kernels_s += t
            by_kernel.append((t, e.count, e.key))
    top = sorted(by_kernel, reverse=True)[:5]
    return wall, kernels_s, copies_s, top, None if kernels_s + copies_s > 0 else why, by_kernel


def copy_and_fill_kernels(by_kernel) -> tuple[int, int]:
    """Device copy kernels (a block copied into an assembled array) and
    float64 fill kernels (a virtual template block) among *by_kernel*."""
    copies = sum(n for _, n, key in by_kernel if "copy" in key.lower())
    fills = sum(n for _, n, key in by_kernel if "FillFunctor<double>" in key)
    return copies, fills


def print_device_split(label: str, wall, kernels_s, copies_s, top, why, by_kernel) -> None:
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


def profile_device_run(torch) -> int:
    """``--profile-device-run``: vorticity on the device executor, once to
    warm up (the first sighting of its segment), once under torch.profiler
    to warm the profiler up (its segment is captured), and once under it to
    measure (a replay), in a process of its own; prints the profiled run as
    one JSON line (:func:`profiled`'s reading, and the launches the
    wrappers counted in it)."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    work = os.path.join(WORK_DIR, f"vorticity-profile-{os.getpid()}")
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB")
    random.seed(SEED)
    result = vorticity_build(spec)

    ex = CudaExecutor()

    def run():
        result.compute(executor=ex)
        torch.cuda.synchronize()

    try:
        run()
        profiled(torch, run)  # the profiler's first session in a process starts it up
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        wall, kernels_s, copies_s, _, why, by_kernel = profiled(torch, run)
        counted = {k: w.launches for k, w in wrappers.items()}
        check(ex.stats["segment_struct_hits"] == 1, f"the profiled run did not replay: {dict(ex.stats)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(dict(wall=wall, kernels_s=kernels_s, copies_s=copies_s, why=why, by_kernel=by_kernel,
                          counted=counted)))
    return 0


def breakdown_device(torch, name: str, build) -> None:
    """Device executor: compute once more under torch.profiler for the
    device's busy time and idle share, in a fresh process; then run the
    plan again with the executor's ops one at a time, each timed on the
    host clock up to a synchronize (within a compute, a segment's ops share
    one time)."""
    # torch.profiler has lost device records in a process that had already
    # profiled and run many kernels (one Philox launch of four, every time),
    # never in a fresh one; a dropped copy or fill would pass the check
    # below unseen, so a reading counts only when it recorded every launch
    # the wrappers counted
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        proc = run_fresh(["--profile-device-run"])
        check(proc.returncode == 0, f"{name} [cuda]: the profiled run failed:\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        recorded = {k: sum(n for _, n, key in r["by_kernel"] if KERNEL_RECORDS[k] in key) for k in r["counted"]}
        complete = r["why"] is None and recorded == r["counted"]
        print(f"{name} breakdown [cuda], profiled run {attempt} (fresh process): launches counted "
              f"{json.dumps(r['counted'])}, recorded {json.dumps(recorded)}: "
              f"{'complete' if complete else 'incomplete, reading not used'}")
        if complete:
            break
    check(complete, f"{name} [cuda]: no profiled run of {PROFILE_ATTEMPTS} recorded every counted launch")
    split = (r["wall"], r["kernels_s"], r["copies_s"], sorted(map(tuple, r["by_kernel"]), reverse=True)[:5], None,
             r["by_kernel"])
    print(f"{name} breakdown [cuda]: wall {split[0]:.3f} s")
    print_device_split(f"{name} breakdown [cuda]", *split)
    # the random ops run block by block made 399 block copies and 398
    # template fills
    copies, fills = copy_and_fill_kernels(split[5])
    print(f"{name} breakdown [cuda]: {copies} copy kernels, {fills} float64 fill kernels "
          f"(block by block: 399 and 398)")
    check(copies <= 399 - 390 and fills <= 398 - 390,
          f"{name} [cuda]: {copies} copy and {fills} fill kernels, not 390 fewer than block by block")
    breakdown_device_ops(torch, name, build)


def breakdown_device_ops(torch, name: str, build, allowed_mem: str = "2GB") -> None:
    """Run the plan on a new CudaExecutor with its ops one at a time, each
    timed on the host clock up to a synchronize, then the output's flush
    to storage and its read back, as ``compute()`` makes them."""
    import cubed_tpu_torch
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.pipeline import visit_nodes

    spec = cubed_tpu_torch.Spec(work_dir=os.path.join(WORK_DIR, f"{name}-breakdown-cuda"), allowed_mem=allowed_mem)
    random.seed(SEED)
    result = build(spec)
    t0 = time.perf_counter()
    dag = result.plan._finalize(array_names=(result.name,)).dag
    per_kind: dict = {"plan finalisation": time.perf_counter() - t0}
    ex = CudaExecutor()
    resident: dict = {}
    budget = ex._budget(spec, torch.device("cuda"))
    requested = {result.zarray_maybe_lazy.store}
    for op_name, node in visit_nodes(dag):
        t = time.perf_counter()
        if ex._classify(node["primitive_op"]) == "segment":
            for arr in ex._segment_sources([(op_name, node)]):
                ex._preload(arr, resident, budget)
        ex._run_ops([(op_name, node)], resident, budget, requested)
        torch.cuda.synchronize()
        kind = node["op_name"]
        per_kind[kind] = per_kind.get(kind, 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    for res in resident.values():
        if res.target.store in requested:
            ex._flush(res)
    per_kind["flush"] = time.perf_counter() - t
    t = time.perf_counter()
    result._read_stored()
    per_kind["read back"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    shutil.rmtree(spec.work_dir, ignore_errors=True)
    ops = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(per_kind.items(), key=lambda kv: -kv[1]))
    print(f"{name} breakdown [cuda, op by op]: wall {wall:.3f} s; by op kind: {ops}")


# ---------------------------------------------------------------------------
# the attention phase: ring attention over a mesh of four slots of one card,
# with its one hand kernel, flash_block, held against its plain step
# ---------------------------------------------------------------------------

#: the attention phase, in a process of its own (``--attention-phase``): one
#: long-context layer's (B, S, H, D) float32 queries, keys and values at full
#: width, a ring of ``slots`` slots of cuda:0 (S / slots positions a slot, 16
#: flash_block launches a ring); the backward checked at ``grad_S``; the
#: dense oracle run ``oracle_heads`` heads at a time (heads are independent;
#: one head's scores are 1 GB, all 16 heads' 17 GB)
ATTENTION = dict(B=1, S=16384, H=16, D=128, slots=4, seed=SEED, grad_S=2048, oracle_heads=1)
#: tolerances, with their reasons. A step: the kernel's float32 sums run
#: tile by tile with rescaling, the plain step's over the whole block, so
#: they differ by float32 rounding over up to 4096 terms (m is a max: exact
#: but for the scores' own rounding). The ring against the dense oracle:
#: two float32 softmaxes over 16384 keys summed in different orders, outputs
#: within [-1, 1]; a wrong mask or rescale is off by 1e-2 or more. The
#: gradient: float32 sums over 2048 positions in two orders, taken relative
#: to the gradient's largest magnitude (the JAX package's test holds 2e-4
#: absolute at 32 positions and magnitudes near 1)
ATTENTION_TOL = dict(step_m=1e-6, step_l=2e-5, step_o=2e-5, ring=1e-4, grad=2e-4)
#: ragged slot-steps checked against the plain step: (S_q, S_k, H, D,
#: q_offset, k_offset), lengths not a multiple of the 64-position tile, D
#: of 8, 64 and 256, and causal blocks with rows that see no key
FLASH_RAGGED = [(1000, 1000, 4, 8, 0, 0), (1000, 1000, 4, 64, 1000, 0), (777, 1000, 2, 256, 500, 300),
                (1000, 1000, 2, 64, 0, 500)]
#: H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet): the bound a
#: tensor-core redesign of flash_block would be held to, printed beside the
#: FP32 one
TF32_OPS_PER_S = 495e12


def flash_ops(B: int, H: int, S_q: int, S_k: int, D: int) -> float:
    """Floating-point operations of one slot-step: two products of 2 S_q
    S_k D each, a (batch, head)."""
    return 4.0 * B * H * S_q * S_k * D


def attention_inputs(spec, config):
    """Three (B, S, H, D) float32 cubed arrays drawn by ``random.random``
    (uniform on [-1, 1)), S chunked by the ring's slots."""
    import cubed_tpu_torch
    import cubed_tpu_torch.array_api as xp

    shape = (config["B"], config["S"], config["H"], config["D"])
    chunks = (config["B"], config["S"] // config["slots"], config["H"], config["D"])
    random.seed(config["seed"])
    return [xp.astype(xp.subtract(xp.multiply(cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec), 2.0),
                                  1.0), xp.float32) for _ in range(3)]


def check_flash_step(torch, label: str, case: tuple, causal: bool, gen) -> float:
    """Two slot-steps of *case* from empty accumulators, the kernel's against
    the plain step's; returns the largest error on o."""
    from cubed_tpu_torch.kernels.flash_block import flash_block, flash_block_plain

    S_q, S_k, H, D, q_off, k_off = case
    dev = torch.device("cuda")
    q = torch.rand((1, S_q, H, D), generator=gen, device=dev) * 2 - 1
    mine = (torch.zeros((1, H, S_q, D), device=dev), torch.zeros((1, H, S_q), device=dev),
            torch.full((1, H, S_q), -torch.inf, device=dev))
    plain = [t.clone() for t in mine]
    err = 0.0
    for step, (qo, ko) in enumerate(((q_off, k_off), (q_off, k_off + S_k))):
        k, v = (torch.rand((1, S_k, H, D), generator=gen, device=dev) * 2 - 1 for _ in range(2))
        kw = dict(q_offset=qo, k_offset=ko, causal=causal, scale=D ** -0.5)
        before = flash_block.launches
        flash_block(q, k, v, *mine, **kw)
        flash_block_plain(q, k, v, *plain, **kw)
        torch.cuda.synchronize()
        what = f"flash_block {label} {'causal' if causal else 'full'} step {step}"
        check(flash_block.launches == before + 1, f"{what}: not one launch")
        o, l, m = mine
        po, pl, pm = plain
        check(torch.equal(torch.isneginf(m), torch.isneginf(pm)), f"{what}: rows with no key differ")
        fin = ~torch.isneginf(pm)
        tol = ATTENTION_TOL
        check(bool(((m - pm)[fin].abs() <= tol["step_m"] * pm[fin].abs().clamp_min(1.0)).all()), f"{what}: m")
        check(bool(((l - pl).abs() <= tol["step_l"] * pl.abs().clamp_min(1.0)).all()), f"{what}: l")
        scale_o = float(po.abs().max()) or 1.0
        e = float((o - po).abs().max())
        check(e <= tol["step_o"] * scale_o, f"{what}: o off by {e} (scale {scale_o})")
        err = max(err, e)
    return err


def check_flash_block(torch, config) -> dict:
    """flash_block against its plain step on the main path's slot-step and
    ragged ones, then timed beside its plain step, its bound and SDPA on the
    same block; returns its kernels-line entry (launches added later)."""
    from cubed_tpu_torch.kernels import _build
    from cubed_tpu_torch.kernels.flash_block import flash_block, flash_block_plain

    for fn, use in _build.resource_usage("flash_block").items():
        if "Li128E" in fn and "IfLi" in fn:
            print(f"flash_block float32, D padded to 128: {use}")
    gen = torch.Generator(device="cuda").manual_seed(config["seed"])
    B, H, D, S_l = config["B"], config["H"], config["D"], config["S"] // config["slots"]
    main = (S_l, S_l, H, D, S_l, S_l)  # a diagonal slot-step: the causal mask cuts it in half
    err = 0.0
    for label, case in [("main path", main)] + [(f"ragged {c}", c) for c in FLASH_RAGGED]:
        for causal in (False, True):
            err = max(err, check_flash_step(torch, label, case, causal, gen))
    print(f"flash_block: the kernel within {ATTENTION_TOL['step_o']} x max|o| (l {ATTENTION_TOL['step_l']}, m "
          f"{ATTENTION_TOL['step_m']} relative) of the plain step over two steps each, the main path's slot-step "
          f"(1, {S_l}, {H}, {D}) and {len(FLASH_RAGGED)} ragged ones, both masks; max |o - plain| {err:.3g}")

    dev = torch.device("cuda")
    q, k, v = (torch.rand((B, S_l, H, D), generator=gen, device=dev) * 2 - 1 for _ in range(3))

    def fresh():
        return (torch.zeros((B, H, S_l, D), device=dev), torch.zeros((B, H, S_l), device=dev),
                torch.full((B, H, S_l), -torch.inf, device=dev))

    kw = dict(q_offset=0, k_offset=0, scale=D ** -0.5)
    state = fresh()
    ms = time_ms(torch, lambda: flash_block(q, k, v, *state, causal=False, **kw), [()], reps=10)
    ms_causal = time_ms(torch, lambda: flash_block(q, k, v, *state, causal=True, **kw), [()], reps=10)
    plain_ms = time_ms(torch, lambda: flash_block_plain(q, k, v, *fresh(), causal=False, **kw), [()], reps=3)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qh, kh, vh), [()], reps=5)
    ops = flash_ops(B, H, S_l, S_l, D)
    nbytes = 3 * 4 * B * S_l * H * D + 2 * 4 * (B * H * S_l * (D + 2))  # q, k, v read; o, l, m read and written
    b, by = bound_ms(nbytes, ops)
    print(f"flash_block (1, {S_l}, {H}, {D}) float32 slot-step: {ms:.4f} ms/launch ({100 * b / ms:.1f}% of its "
          f"bound), causal diagonal {ms_causal:.4f} ms; plain step {plain_ms:.4f} ms; SDPA of the block "
          f"{library_ms:.4f} ms; bound {b:.4f} ms ({by}: {ops / 1e9:.1f} GFLOP at the FP32 rate; "
          f"{ops / TF32_OPS_PER_S * 1e3:.4f} ms at the TF32 tensor-core rate; {nbytes / 1e6:.1f} MB moved); "
          f"{smi_tag()}")
    return dict(
        name="flash_block", route="cuda", source="cubed_tpu_torch/kernels/csrc/flash_block.cu",
        replaces="cubed_tpu/parallel/ring_attention.py:51 (_ring_attention_local; a JAX program, no pallas_call)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=library_ms,
    )


def dense_oracle(torch, q, k, v, causal: bool, heads: int):
    """Dense attention on the card, *heads* heads at a time."""
    from cubed_tpu_torch.parallel.ring_attention import dense_attention

    out = torch.empty_like(q)
    for h in range(0, q.shape[2], heads):
        sl = slice(h, h + heads)
        out[:, :, sl] = dense_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], causal=causal)
    return out


def check_ring_gradient(torch, config) -> float:
    """One causal backward at ``grad_S`` on the ring against dense attention's
    autograd; returns the largest error over the largest magnitude."""
    from cubed_tpu_torch.parallel.mesh import make_mesh
    from cubed_tpu_torch.parallel.ring_attention import dense_attention, ring_attention

    dev = torch.device("cuda", 0)
    mesh = make_mesh(shape=(config["slots"],), axis_names=("seq",), devices=[dev] * config["slots"])
    gen = torch.Generator(device=dev).manual_seed(config["seed"] + 1)
    shape = (config["B"], config["grad_S"], config["H"], config["D"])
    ts = [(torch.rand(shape, generator=gen, device=dev) * 2 - 1).requires_grad_() for _ in range(3)]
    ring = torch.autograd.grad((ring_attention(*ts, mesh=mesh, causal=True).gather() ** 2).sum(), ts)
    dense = torch.autograd.grad((dense_attention(*ts, causal=True) ** 2).sum(), ts)
    worst = 0.0
    for name, g, w in zip("qkv", ring, dense):
        rel = float((g - w).abs().max()) / float(w.abs().max())
        check(rel <= ATTENTION_TOL["grad"], f"attention: d{name} off by {rel:.3g} of its largest magnitude")
        worst = max(worst, rel)
    print(f"attention: the causal ring's gradient at S={config['grad_S']} within {worst:.3g} of dense autograd's "
          f"largest magnitude (limit {ATTENTION_TOL['grad']})")
    return worst


def run_attention_phase(torch, config=ATTENTION) -> dict:
    """The attention phase (see the module docstring); returns its numbers,
    printed as they come."""
    import cubed_tpu_torch
    from cubed_tpu_torch.kernels.flash_block import flash_block
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.parallel import attention, make_mesh
    from cubed_tpu_torch.parallel.ring_attention import ring_attention, sequence_sharded

    started = time.perf_counter()
    work = os.path.join(WORK_DIR, "attention")
    shutil.rmtree(work, ignore_errors=True)
    timings: dict = {}
    kernel = check_flash_block(torch, config)
    timings["kernel checks"] = time.perf_counter() - started
    spec = cubed_tpu_torch.Spec(work_dir=work, allowed_mem="2GB")
    dev = torch.device("cuda", 0)
    mesh = make_mesh(shape=(config["slots"],), axis_names=("seq",), devices=[dev] * config["slots"])
    # the inputs' values for the oracle, outside the counted run
    t0 = time.perf_counter()
    qn, kn, vn = cubed_tpu_torch.compute(*attention_inputs(spec, config))
    q, k, v = (torch.from_numpy(x).to(dev) for x in (qn, kn, vn))
    placed = [sequence_sharded(t, mesh) for t in (q, k, v)]
    timings["inputs"] = time.perf_counter() - t0

    # the main path: the ring on the placed tensors, then attention() on the
    # cubed arrays (their inputs computed through the plan), both masks
    t0 = time.perf_counter()
    flash_block.launches, philox_uniform.launches = 0, 0
    flash_block.paths.update(causal=0, full=0)
    rings, apis = {}, {}
    for causal in (False, True):
        rings[causal] = ring_attention(*placed, mesh=mesh, causal=causal).gather()
        apis[causal] = attention(*attention_inputs(spec, config), mesh=mesh, causal=causal)
    torch.cuda.synchronize()
    launches = dict(flash_block=flash_block.launches, philox_uniform=philox_uniform.launches,
                    flash_block_paths=dict(flash_block.paths))
    timings["main path"] = time.perf_counter() - t0
    print(f"attention main path: launches {json.dumps(launches)} (16 a ring: {config['slots']} slots x "
          f"{config['slots']} steps; the inputs drawn per block by Philox on the sequential executor)")
    check(launches["flash_block"] == 4 * config["slots"] ** 2, f"attention: flash_block launched "
          f"{launches['flash_block']} times, not {4 * config['slots'] ** 2}")
    check(launches["philox_uniform"] > 0, "attention: Philox never launched on the main path")

    t0 = time.perf_counter()
    errors = {}
    for causal in (False, True):
        mask = "causal" if causal else "full"
        want = dense_oracle(torch, q, k, v, causal, config["oracle_heads"])
        got_api = torch.from_numpy(apis[causal].compute()).to(dev)
        check(apis[causal].chunksize == (config["B"], config["S"] // config["slots"], config["H"], config["D"]),
              f"attention: chunked {apis[causal].chunksize}, not like q")
        for label, got in (("ring_attention", rings[causal]), ("attention()", got_api)):
            check(bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(q.shape),
                  f"attention {label} {mask}: not finite or shape {tuple(got.shape)}")
            e = float((got - want).abs().max())
            errors[f"{label} {mask}"] = e
            check(e <= ATTENTION_TOL["ring"], f"attention {label} {mask}: off the dense oracle by {e}")
        del want, got_api
    timings["oracle checks"] = time.perf_counter() - t0
    print(f"attention: against the dense oracle ({config['oracle_heads']} head at a time), max abs errors "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errors.items()})} (limit {ATTENTION_TOL['ring']})")
    grad = check_ring_gradient(torch, config)

    # times: the whole ring beside SDPA on the same whole attention
    t0 = time.perf_counter()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ring_ms, sdpa_ms = {}, {}
    for causal in (False, True):
        mask = "causal" if causal else "full"
        ring_ms[mask] = time_ms(torch, lambda c=causal: ring_attention(*placed, mesh=mesh, causal=c), [()], reps=3)
        sdpa_ms[mask] = time_ms(torch, lambda c=causal: sdpa(qh, kh, vh, is_causal=c), [()], reps=3)
    timings["ring times"] = time.perf_counter() - t0
    whole = flash_ops(config["B"], config["H"], config["S"], config["S"], config["D"])
    print(f"attention ({config['B']}, {config['S']}, {config['H']}, {config['D']}) float32 on a ring of "
          f"{config['slots']} slots of one card: ring {json.dumps({k: round(v, 3) for k, v in ring_ms.items()})} ms "
          f"(16 flash_block launches, the epilogue, no copies on one card); SDPA on the same whole attention "
          f"{json.dumps({k: round(v, 3) for k, v in sdpa_ms.items()})} ms; the non-causal bound "
          f"{whole / CUDA_CORE_OPS_PER_S * 1e3:.2f} ms at the FP32 rate ({whole / 1e12:.2f} TFLOP); {smi_tag()}")
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - started
    print(f"attention phase: {seconds:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items())
          + f"); {smi_tag()}")
    return dict(kernel=kernel, launches=launches, errors=errors, grad_rel_err=grad, ring_ms=ring_ms,
                sdpa_ms=sdpa_ms, seconds=seconds, timings=timings)


# ---------------------------------------------------------------------------
# the chaos phase: composed-failure campaigns on the card's executors
# ---------------------------------------------------------------------------

#: the chaos phase, in a process of its own (``--chaos-phase``): a generated
#: campaign over ``seeds`` (three failure domains each), the subprocess
#: mode's coordinator kill, a failing schedule shrunk and replayed from its
#: repro file, and the CLI on ``cli_seed``
CHAOS = dict(seeds=(0, 1, 2, 3), cli_seed=2,
             coordinator_kill=dict(seed=88, workload="blockwise_chain",
                                   faults={"seed": 88, "storage_read_failure_rate": 0.05,
                                           "coordinator_crash_after_dispatches": 3}),
             failing=dict(seed=55, workload="blockwise_chain",
                          faults={"seed": 55, "task_failure_rate": 1.0, "straggler_rate": 0.2,
                                  "straggler_delay_s": 0.05, "storage_throttle_rate": 0.05}))


def run_chaos_phase(torch, config=CHAOS) -> dict:
    """The chaos phase (see the module docstring); returns its numbers."""
    from cubed_tpu_torch.backend_array_api import get_device
    from cubed_tpu_torch.runtime.campaign import CampaignRunner, FaultSchedule

    started = time.perf_counter()
    work = os.path.join(WORK_DIR, "chaos")
    shutil.rmtree(work, ignore_errors=True)
    timings: dict = {}
    runner = CampaignRunner(work)
    check(str(get_device()) == "cuda", "chaos: the chunk device is not the card")

    t0 = time.perf_counter()
    results = []
    for seed in config["seeds"]:
        sched = runner.generate(seed)
        res = runner.run(sched)
        print("chaos 1: " + res.render().replace("\n", "; ") + f" {json.dumps(res.stats)}")
        check(res.ok and res.report is not None and res.report.ok,
              f"chaos 1: seed {seed} not bitwise and auditor-clean: {res.render()}")
        check(len(sched.domains) >= 3, f"chaos 1: seed {seed} composes {sorted(sched.domains)}")
        results.append(dict(seed=seed, fleet=sched.needs_fleet, wall_s=res.wall_s))
    check(any(r["fleet"] for r in results) and not all(r["fleet"] for r in results),
          "chaos 1: the seeds do not cover both the threads and the fleet")
    timings["campaign"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    kill = FaultSchedule(**config["coordinator_kill"])
    res = runner.run(kill)
    print("chaos 2: " + res.render().replace("\n", "; ") + f" {json.dumps(res.stats)}")
    check(kill.needs_subprocess and res.ok, f"chaos 2: the coordinator kill did not recover: {res.render()}")
    check(res.stats.get("child_rc") != 0 or res.stats.get("child_killed"), "chaos 2: the child was not killed")
    check(res.report is not None and res.report.ok, "chaos 2: the clean replay's audit is not clean")
    timings["coordinator kill"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    failing = FaultSchedule(**config["failing"])
    first = runner.run(failing)
    check(not first.ok and first.signature == ("compute", "FaultInjectedTaskError"),
          f"chaos 3: the failing schedule's first run: {first.render()}")
    minimal = runner.shrink(failing, signature=first.signature)
    check(set(minimal.faults) == {"seed", "task_failure_rate"}, f"chaos 3: shrunk to {minimal.faults}")
    repro = runner.write_repro(minimal, runner.run(minimal), os.path.join(work, "repro.json"))
    replayed = runner.replay(repro)
    check(replayed.signature == first.signature, f"chaos 3: the repro replays as {replayed.signature}")
    print(f"chaos 3: {failing.describe()} failed at {first.signature}, shrunk to {sorted(minimal.faults)}, "
          f"replayed from {os.path.basename(repro)} with the same signature")
    timings["shrink and replay"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cubed_tpu_torch.chaos", "--seed", str(config["cli_seed"]),
                           "--base-dir", os.path.join(work, "cli")], capture_output=True, text=True,
                          timeout=600, cwd=REPO, env=dict(os.environ, CUBED_TPU_TORCH_DEVICE="cuda"))
    print("chaos 4: python -m cubed_tpu_torch.chaos --seed " + str(config["cli_seed"]) + ": exit "
          + str(proc.returncode) + "; " + "; ".join(proc.stdout.strip().splitlines()[:2]))
    check(proc.returncode == 0, f"chaos 4: the CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    timings["cli"] = time.perf_counter() - t0

    left = live_children()
    check(left == [], f"chaos: live child processes at the end: {left}")
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - started
    print(f"chaos phase: {seconds:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items())
          + f"); {smi_tag()}")
    return dict(campaign=results, seconds=seconds, timings=timings)


#: the fresh process that waits for its arguments (:func:`start_fresh`),
#: and those given theirs that are not yet waited for
_SPARE: Optional[subprocess.Popen] = None
_STARTED: list = []


def _spawn_spare() -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spare"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)


def feed(proc, args: list) -> tuple:
    """Give a warm process (``_spawn_spare``) its arguments; its output is
    read meanwhile. Returns a handle for :func:`drain`."""
    box: dict = {}

    def talk():
        box["out"], box["err"] = proc.communicate(json.dumps(args) + "\n")

    reader = threading.Thread(target=talk, daemon=True)
    reader.start()
    return proc, reader, box


def drain(handle: tuple, timeout: float, label: str) -> subprocess.CompletedProcess:
    """Wait for a process of :func:`feed` (killed past *timeout*)."""
    proc, reader, box = handle
    reader.join(timeout)
    if reader.is_alive():
        proc.kill()
        reader.join()
        raise PhaseFailed(f"chip_smoke.py {label}: ran past {timeout} s")
    return subprocess.CompletedProcess(proc.args, proc.returncode, box["out"], box["err"])


def start_fresh(args: list) -> tuple:
    """Start ``chip_smoke.py ARGS`` in a fresh process of this checkout. A
    spare process (``--spare``) imports torch and the port while the run
    goes on, then waits for its arguments (one JSON line on stdin); this
    takes it and starts the next spare. Returns a handle for
    :func:`finish_fresh`; the process's output is read meanwhile."""
    global _SPARE
    proc = _SPARE or _spawn_spare()
    _SPARE = _spawn_spare()
    _STARTED.append(proc)
    return args, feed(proc, args), time.perf_counter()


def warm_spare() -> None:
    """Start the first spare process (:func:`start_fresh`) now."""
    global _SPARE
    if _SPARE is None:
        _SPARE = _spawn_spare()


def finish_fresh(handle: tuple, timeout: float = 600) -> tuple:
    """Wait for a process of :func:`start_fresh` (killed past *timeout*
    seconds from its start): (CompletedProcess, seconds from its start)."""
    args, fed, t0 = handle
    _STARTED.remove(fed[0])
    return drain(fed, max(0.0, timeout - (time.perf_counter() - t0)), args[0]), time.perf_counter() - t0


def run_fresh(args: list, timeout: float = 600) -> subprocess.CompletedProcess:
    """``chip_smoke.py ARGS`` in a fresh process (:func:`start_fresh`)."""
    return finish_fresh(start_fresh(args), timeout)[0]


def stop_fresh() -> None:
    """End the spare process and any not waited for (a failed run)."""
    global _SPARE
    for proc in ([_SPARE] if _SPARE is not None else []) + _STARTED:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    _SPARE = None
    _STARTED.clear()


def phase_result(handle: tuple, label: str, timeout: float = 600) -> dict:
    """A phase run in a fresh process (:func:`start_fresh`): its output
    passed on; returns its summary (its last line) and ``whole_seconds``,
    from its start to its end."""
    proc, seconds = finish_fresh(handle, timeout)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines))
    check(proc.returncode == 0, f"{label}: its process failed:\n{proc.stderr[-4000:]}")
    return dict(json.loads(lines[-1]), whole_seconds=seconds)


def main(argv: list) -> int:
    global CARD, WORK_DIR
    against = timed = layouts = None
    if argv == ["--spare"]:
        # a fresh process started ahead of its use (start_fresh): import,
        # then run the arguments it is given
        sys.path.insert(0, REPO)
        try:
            import torch  # noqa: F401
            import cubed_tpu_torch  # noqa: F401
            from cubed_tpu_torch.kernels import _build  # noqa: F401
        except ImportError:
            pass  # main reports it
        line = sys.stdin.readline()
        return main(json.loads(line)) if line else 1
    if argv[:1] and argv[0] in SIDE_WORK_DIRS:
        WORK_DIR = SIDE_WORK_DIRS[argv[0]]
    if argv[:1] == ["--against"] and len(argv) == 2:
        against = argv[1]
    elif argv[:1] == ["--check-layouts"] and len(argv) == 2:
        layouts = argv[1]
    elif argv[:1] in (["--time-kernels"], ["--time-computes"]) and len(argv) == 2:
        timed = os.path.abspath(argv[1])
    elif argv[:1] in (["--threads-phase"], ["--analytics-phase"], ["--fleet-phase"], ["--service-phase"]) \
            and len(argv) <= 2:
        pass
    elif argv[:1] == ["--service-failover"] and len(argv) == 3 and argv[1] in ("run", "recover"):
        pass
    elif argv and argv not in (["--profile-device-run"], ["--observe-device-run"], ["--array-api-phase"],
                               ["--array-api-phase", "full"], ["--order-stats-phase"],
                               ["--order-stats-phase", "full"], ["--zarr-stencil-phase"], ["--linalg-fft-phase"],
                               ["--reliability-phase"], ["--analytics-unobserved"], ["--attention-phase"],
                               ["--chaos-phase"]):
        print("usage: chip_smoke.py [--against CHECKOUT | --array-api-phase [full] | --order-stats-phase [full] | "
              "--zarr-stencil-phase | --linalg-fft-phase | --reliability-phase | --threads-phase | "
              "--analytics-phase | --fleet-phase | --service-phase | --attention-phase | --chaos-phase]",
              file=sys.stderr)
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
    root = timed or REPO
    sys.path.insert(0, root)
    try:
        import cubed_tpu_torch  # noqa: F401
        from cubed_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: cubed_tpu_torch is not importable from {root}: {e}", file=sys.stderr)
        return 1
    os.environ["CUBED_TPU_TORCH_DEVICE"] = "cuda"
    if argv == ["--profile-device-run"]:
        return profile_device_run(torch)
    if argv == ["--observe-device-run"]:
        try:
            return observe_device_run(torch)
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
    if argv[:1] == ["--array-api-phase"]:
        # the Array API phase alone
        CARD = nvidia_smi()
        try:
            _build.build_all()
            run_array_api_phase(torch, ARRAY_API_FULL if argv[1:] == ["full"] else ARRAY_API)
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv == ["--zarr-stencil-phase"]:
        # the Zarr and stencils phase alone
        CARD = nvidia_smi()
        try:
            _build.build_all()
            run_zarr_stencil_phase(torch)
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv == ["--linalg-fft-phase"]:
        # the linear algebra and spectra phase alone, its summary the last line
        CARD = nvidia_smi()
        try:
            _build.build_all()
            print(json.dumps(run_linalg_fft_phase(torch)))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv == ["--reliability-phase"]:
        # the memory guard and reliability phase alone, its summary the last line
        CARD = nvidia_smi()
        try:
            _build.build_all()
            print(json.dumps(run_reliability_phase(torch)))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv[:1] == ["--threads-phase"]:
        # the threads phase alone, its summary the last line; the full run
        # passes its sequential executor's launches on vorticity's plan
        CARD = nvidia_smi()
        try:
            _build.build_all()
            given = json.loads(argv[1]) if argv[1:] else {}
            config = dict(THREADS, **{k: given[k] for k in ("rounds", "cut", "full_modes", "workers", "timing_workers")
                                      if k in given})
            config["cut"] = dict(config["cut"], shape=tuple(config["cut"]["shape"]))
            print(json.dumps(run_threads_phase(torch, config, sequential_full=given.get("sequential"))))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv[:1] == ["--fleet-phase"]:
        # the fleet phase alone, its summary the last line; the full run
        # passes phase 4's and the threads phase's yardsticks
        CARD = nvidia_smi()
        try:
            _build.build_all()
            print(json.dumps(run_fleet_phase(torch, FLEET, json.loads(argv[1]) if argv[1:] else {})))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv[:1] == ["--service-phase"]:
        # the service phase alone, its summary the last line; the full run
        # passes phase 4's device value and launches and the threads phase's
        # sequential value at the cut
        CARD = nvidia_smi()
        try:
            _build.build_all()
            print(json.dumps(run_service_phase(torch, SERVICE, json.loads(argv[1]) if argv[1:] else {})))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv in (["--attention-phase"], ["--chaos-phase"]):
        # the attention or the chaos phase alone, its summary the last line
        CARD = nvidia_smi()
        try:
            _build.build_all()
            run = run_attention_phase if argv == ["--attention-phase"] else run_chaos_phase
            print(json.dumps(run(torch)))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv[:1] == ["--service-failover"]:
        # one side of the service phase's check 3 (run until killed, or the
        # successor that recovers), in a process of its own
        CARD = nvidia_smi()
        try:
            return service_failover_child(argv[1], json.loads(argv[2]))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
    if argv == ["--analytics-unobserved"]:
        # the analytics phase's yardstick when it runs alone
        CARD = nvidia_smi()
        try:
            _build.build_all()
            print(json.dumps(analytics_unobserved(torch)))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv[:1] == ["--analytics-phase"]:
        # the analytics phase, its summary the last line; the full run passes
        # phase 4's oracle value and unobserved launches, alone they come
        # from a process of their own
        CARD = nvidia_smi()
        try:
            _build.build_all()
            if argv[1:]:
                given = json.loads(argv[1])
            else:
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--analytics-unobserved"],
                                      capture_output=True, text=True, timeout=600, cwd=REPO)
                check(proc.returncode == 0, f"analytics phase: the unobserved run failed:\n{proc.stderr[-4000:]}")
                given = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(run_analytics_phase(torch, ANALYTICS, given)))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if argv[:1] == ["--order-stats-phase"]:
        # the order-statistics phase alone, its merge kernels checked first;
        # ``full``: at the full depth of the time axis
        CARD = nvidia_smi()
        try:
            _build.build_all()
            config = ORDER_STATS_FULL if argv[1:] == ["full"] else ORDER_STATS
            kernels_order = check_merge_sort(torch, config)
            order = run_order_stats_phase(torch, config)
            print(json.dumps({"kernels": kernels_order, "order": order}))
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    if layouts:
        try:
            _build.build_all()
            check_layouts_file(torch, layouts)
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    if timed:
        # one checkout's kernels or computes, alone in this process
        if not os.path.abspath(cubed_tpu_torch.__file__).startswith(root + os.sep):
            print(f"chip_smoke: imported {cubed_tpu_torch.__file__}, not the checkout at {root}", file=sys.stderr)
            return 1
        try:
            times = time_against_cases(torch) if argv[0] == "--time-kernels" else time_computes(torch)
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps(times))
        return 0

    started = time.perf_counter()
    CARD = smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")
    rounds_build = None
    try:
        t0 = time.perf_counter()
        rounds_build = start_rounds_build()
        warm_spare()
        # phase 4's numpy oracles on the host's cores while nvcc runs
        with concurrent.futures.ThreadPoolExecutor(1) as builder:
            built = builder.submit(lambda: _build.build_all() or time.perf_counter())
            for name, oracle, seeds in phase4_oracles():
                for seed in seeds:
                    cached_oracle(name, oracle, seed)
            oracles_s = time.perf_counter() - t0
            build_end = built.result()
        rounds_lib = finish_rounds_build(rounds_build)
        print(f"build: {max(build_end, time.perf_counter()) - t0:.2f} s ({', '.join(_build.SOURCES)}; "
              f"{ROUNDS_SOURCE}), the package's libraries {build_end - t0:.2f} s; phase 4's numpy oracles beside it "
              f"{oracles_s:.2f} s")
        print_resource_usage()

        kernels = [check_philox(torch, rounds_lib), check_region_sum(torch), check_fma_sum_blocks(torch)]
        check_fma_one_block(torch)
        check_batched_rules(torch, kernels[0]["slots"])
        kernels_f32 = check_philox_f32(torch, kernels[0]["slots"], kernels[0]["sass"]) + check_f32_routes(torch)
        check_matmul_modes(torch)
        if against:
            compare_against(torch, against)

        # addsum: the random ops fuse into their consumer; on the device
        # executor that op takes the batched route (the Philox and region
        # sum batching rules, one launch each)
        expected = cached_oracle("addsum", addsum_oracle, SEED)
        addsum = {
            "sequential": run_main_path(torch, "addsum", "sequential", addsum_build, expected, {
                "philox_uniform": (50, 50), "philox_uniform:batched": (0, 0), "region_sum": (25, 10**9),
                "fma_sum_blocks": (0, 0)}),
            "cuda": run_main_path(torch, "addsum", "cuda", addsum_build, expected, {
                "philox_uniform": (2, 2), "philox_uniform:batched": (2, 2), "region_sum": (2, 10**9),
                "fma_sum_blocks": (0, 0), "stats:batched_ops": (1, 1),
                "stats:chunked_ops": (3, 3), "stats:eager_ops": (1, 1), "stats:segments_traced": (1, 1)}),
        }
        # vorticity: per block on the sequential executor; on the device
        # executor the batched Philox form, fma_sum_blocks and segment
        # replay, four computes with distinct seeds
        expected = cached_oracle("vorticity", vorticity_oracle, SEED)
        sequential = run_main_path(torch, "vorticity", "sequential", vorticity_build, expected, {
            "philox_uniform": (400, 400), "philox_uniform:batched": (0, 0), "region_sum": (100, 10**9),
            "fma_sum_blocks": (0, 0)})
        runs = run_device_repeats(torch, "vorticity", vorticity_build, vorticity_oracle, {
            "philox_uniform": (4, 4), "philox_uniform:batched": (4, 4), "philox_uniform:block": (0, 0),
            "region_sum": (1, 10**9), "fma_sum_blocks": (1, 1), "fma_sum_blocks:split": (1, 1),
            "stats:batched_ops": (5, 5), "stats:chunked_ops": (3, 3), "stats:eager_ops": (1, 1),
            "stats:segments_traced": (1, 1), "stats:segment_mem_aborts": (0, 0)},
            seeds=(SEED, SEED + 1, SEED + 2, SEED + 3),
            # the graph's pool holds at least the four random arrays
            footprint=4 * 8 * int(np.prod(VORTICITY["shape"])))
        # the fusion rule's chunked form: fma_sum block by block
        expected = cached_oracle("vorticity-spill", functools.partial(vorticity_oracle, SPILL), SEED)
        from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

        spill = run_main_path(
            torch, "vorticity-spill", "cuda", lambda spec: vorticity_build(spec, SPILL), expected, {
                "fma_sum_blocks": (100, 100), "stats:segment_mem_aborts": (1, 1),
                "stats:segments_traced": (0, 0)},
            executor=CudaExecutor(device_mem=SPILL_DEVICE_MEM), spill=True)
        layouts: dict = {}
        bench = run_bench_cells(torch, layouts)
        baseline = run_baseline_configs(torch, layouts)
        # the kernels line: each kernel's launches in the run of its path
        # (vorticity's first device compute; for the float32 entry points
        # and routes vorticity_f32's, and its spilled run's for the per-block
        # float32 Philox entry point)
        for k in kernels:
            k["launches"] = runs[0]["launches"][k["name"]]
        f32_paths = bench["vorticity_f32"][0]["paths"]
        f32_launches = {
            "philox_uniform_f32": bench["vorticity_f32-spill"]["paths"]["philox_uniform"].get("block_f32", 0),
            "philox_uniform_blocks_f32": f32_paths["philox_uniform"].get("batched_f32", 0),
            "fma_sum_blocks_f32": f32_paths["fma_sum_blocks"].get("float32", 0),
            "region_sum_f32": f32_paths["region_sum"].get("float32", 0),
        }
        for k in kernels_f32:
            k["launches"] = f32_launches[k["name"]]
            check(k["launches"] > 0, f"{k['name']}: no launch on its path")
        kernels += kernels_f32
        print("launches by run [cuda, first compute]: " + "; ".join(
            f"{name} {json.dumps(r['cuda'][0]['launches'])}" for name, r in baseline.items()))
        print(f"addsum [cuda] launches {json.dumps(addsum['cuda']['launches'])} (the Philox and region "
              f"sum batching rules on the fused op); compute() cold {addsum['cuda']['seconds']:.4f} s (a first "
              f"sighting: op by op, no capture); {smi_tag()}")
        # the threaded executor, in a process of its own beside the Array API
        # and Zarr phases, its full-width launches held to the sequential
        # executor's above
        threads_run = start_fresh(["--threads-phase", json.dumps(dict(THREADS_WHOLE_RUN, sequential=dict(
            sequential["launches"], **{"philox_uniform:block": sequential["paths"]["philox_uniform"].get("block", 0)})))])
        # the chaos campaigns, in a process of their own beside the threads
        # phase (small arrays: host work, fleets of worker processes)
        chaos_run = start_fresh(["--chaos-phase"])
        array_api = run_array_api_phase(torch)
        print("array API phase summary: " + json.dumps(array_api))
        zarr_stencil = run_zarr_stencil_phase(torch)
        print("zarr and stencils phase summary: " + json.dumps(zarr_stencil))
        threads = phase_result(threads_run, "threads phase", timeout=900)
        chaos = phase_result(chaos_run, "chaos phase", timeout=900)
        print(f"chaos phase summary: {chaos['whole_seconds']:.1f} s with its process's start, beside the Array API, "
              f"Zarr and threads phases ({chaos['seconds']:.1f} s in it); "
              f"{json.dumps({k: round(v, 1) for k, v in chaos['timings'].items()})}")
        print(f"threads phase summary: {threads['whole_seconds']:.1f} s with its process's start, beside the Array "
              f"API and Zarr phases ({threads['seconds']:.1f} s in it); launches at full width "
              f"{json.dumps(threads['launches'])}; checks {json.dumps({k: round(v, 3) for k, v in threads['timings'].items()})}")
        # the compute service, in a process of its own beside the
        # order-statistics phase, held to phase 4's device value and launches
        # of vorticity and to the threads phase's sequential value at the cut
        check(THREADS_WHOLE_RUN["cut"] == SERVICE["cut"] and THREADS["seed"] == SERVICE["seed"],
              "the threads phase's cut is not the service phase's")
        service_run = start_fresh(["--service-phase", json.dumps(dict(
            device_value=runs[0]["value"], device_launches={k: runs[0]["launches"][k] for k in SERVICE_LAUNCHES},
            cut_sequential=dict(value=threads["cut_sequential"]["value"])))])
        # ring attention, in a process of its own beside the service and the
        # order-statistics phases (at most a few GB of the card's memory);
        # flash_block's launches are those of its main path's run
        attention_run = start_fresh(["--attention-phase"])
        # the order-statistics phase, its merge kernels checked first, in a
        # process of its own (after the phases above, which run as they ran
        # before it); the kernels' launches are those of the phase's first
        # device computes
        r = phase_result(start_fresh(["--order-stats-phase"]), "order-statistics phase", timeout=900)
        kernels_order, order = r["kernels"], r["order"]
        print("order-statistics phase summary: " + json.dumps(order))
        for k in kernels_order:
            k["launches"] = order["launches"][k["name"]]
        kernels += kernels_order
        service = phase_result(service_run, "service phase", timeout=900)
        attention = phase_result(attention_run, "attention phase", timeout=900)
        print(f"attention phase summary: {attention['whole_seconds']:.1f} s with its process's start, beside the "
              f"order-statistics and service phases ({attention['seconds']:.1f} s in it); launches "
              f"{json.dumps(attention['launches'])}; ring ms {json.dumps(attention['ring_ms'])}, SDPA ms "
              f"{json.dumps(attention['sdpa_ms'])}")
        kernels.append(dict(attention["kernel"], launches=attention["launches"]["flash_block"]))
        print(f"service phase summary: {service['whole_seconds']:.1f} s with its process's start, beside the "
              f"order-statistics phase ({service['seconds']:.1f} s in the phase); checks "
              f"{json.dumps({k: round(v, 3) for k, v in service['timings'].items()})}")
        # the memory guard and reliability phase, in a process of its own
        reliability = phase_result(start_fresh(["--reliability-phase"]), "reliability phase")
        print(f"reliability phase summary: {reliability['seconds']:.1f} s; launches {json.dumps(reliability['launches'])}; "
              f"checks {json.dumps({k: round(v, 3) for k, v in reliability['timings'].items()})}")
        # the process pool and the TCP fleet, in a process of their own, held
        # to phase 4's oracle value, sequential value and launches at full
        # width and to the threads phase's sequential value and times at the
        # cut (the same plans), beside the linear algebra and spectra phase
        # (its host work and device memory fit beside the fleet's)
        check(THREADS_WHOLE_RUN["cut"] == FLEET["cut"] and THREADS["seed"] == FLEET["seed"],
              "the threads phase's cut is not the fleet phase's")
        fleet_run = start_fresh(["--fleet-phase", json.dumps(dict(
            expected=ORACLES["vorticity", SEED], full_sequential=dict(value=sequential["value"],
                                                                      launches=sequential["launches"]),
            cut_sequential=threads["cut_sequential"],
            cut_threads_s=threads["timings_s"][f"threads {FLEET['threads']}"][0]))])
        linalg_fft = phase_result(start_fresh(["--linalg-fft-phase"]), "linalg and fft phase", timeout=900)
        print(f"linalg and fft phase summary: {linalg_fft['seconds']:.1f} s; launches of its first device "
              f"computes {json.dumps(linalg_fft['launches'])}; sequential task peak / projected "
              + ", ".join(f"{k} {v['ratio']:.4f}" for k, v in linalg_fft["sequential"].items()))
        fleet = phase_result(fleet_run, "fleet phase", timeout=900)
        print(f"fleet phase summary: {fleet['whole_seconds']:.1f} s with its process's start, beside the linear "
              f"algebra phase ({fleet['seconds']:.1f} s in the phase); round at the cut (s) {json.dumps(fleet['round_s'])}")
        # the observability phase: vorticity observed on both executors
        check_observed_device_run(torch, runs)
        observed = run_sequential_observed(torch, threads["cut_sequential"]["seconds"], THREADS_WHOLE_RUN["cut"])
        # the analytics phase, held to phase 4's oracle value and unobserved
        # launches of vorticity and to the sequential run of the cut above
        analytics = phase_result(start_fresh(["--analytics-phase", json.dumps(dict(
            expected=ORACLES["vorticity", SEED], launches=[r["launches"] for r in runs[:3]], sequential=observed))]),
            "analytics phase")
        print(f"analytics phase summary: {analytics['whole_seconds']:.1f} s with its process's start "
              f"({analytics['seconds']:.1f} s in it); cost (ms, quartiles) "
              f"{json.dumps(analytics['cost_ms'])}; sampler tick {analytics['sampler_tick_ms']:.4f} ms")
        breakdown_device(torch, "vorticity", vorticity_build)
        # where a rechunk's device compute goes: its output is (450, 400) in
        # 100 chunks, written to storage and read back
        breakdown_device_ops(torch, "rechunk-2GB", rechunk_build)
        # the sequential executor op by op, at the threads phase's cut
        breakdown(torch, "vorticity-cut", lambda spec: vorticity_build(spec, THREADS_WHOLE_RUN["cut"]))
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_fresh()
        if rounds_build is not None and rounds_build[0].poll() is None:
            rounds_build[0].kill()
            rounds_build[0].wait()
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from the card's name to this line")
    print(smi)
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
