"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (what CI on the card runs)
    python3 chip_smoke.py --phases build,kernels,lm

Phases:

1. ``build``: compile the seven CUDA sources in ``src/repro_torch/csrc``
   (one nvcc each, all at once) and print ptxas's register report.
2. ``kernels``: each kernel against its plain PyTorch version (the
   reference stage) on the card, in fp64 and fp32, at shapes the main path
   gives it: the system-major and batched Stage 1/Stage 3, the wide
   (interleaved) Stage 1/Stage 3, ragged identity padding included, the
   reduced solve (``thomas``) on both routes, the tridiagonal matvec, and
   the SSD intra-chunk stage at mamba2-1.3b's widths and at zamba2-7b's
   (H = 112, P = 64, N = 64), with the chunked scan around it at both;
   max error against the
   tolerance ladder (fp64 1e-12, fp32 1e-5), median time from CUDA events
   around one call (``ms``), the kernel's device time beside it
   (``device_ms``: calls queued behind a sleeping kernel, so the host's
   launch work is not in it, with the L2 evicted before each), the plain
   version's time and the bound (bytes over 3.35 TB/s or operations over
   the peak rate of the unit that runs them, whichever is larger); for the
   matvec the CSR sparse product's time. The wide rows also print the
   wrapper's host enqueue time (``enqueue_ms``), and the wide stages are
   timed at the reduced solve's level shapes too (m = R: P = 32, B = 1024
   and P = 313, B = 64). Stage 1 is also held against its plain
   version at block sizes m = 2 ... 100. Every Thomas row prints its level
   sizes and its time at a base of n0 = 64 rows, and must give the same
   bits twice; the reduced solve is also held against the fp64 host oracle
   ``thomas_numpy`` at the edges of its level structure and with large
   ignored couplings dl[0], du[n-1] at sizes r divides (both routes, both
   dtypes, B = 1, 3, 64). Two sweeps are printed: the sub-block size r at
   B = 1, n = 1e6 fp64, and the levels against the one-thread base alone
   at n = 65 ... 2000 (the base size n0). Stage 3 is held against its
   plain version at m = 2 ... 100 and past its shared-memory span, at the
   reduced solve's level shapes (m = R), with spikes unaligned to 16 bytes
   and a nonzero ``left``; it is also timed at P = 31,250 blocks, the main
   path's chunk shape (m = 10) and the reduced solve's first level (m = 32),
   with operand sets rotated past the L2 and with one set warm in it,
   beside a one-element kernel's launch (the floor) and a ``copy_`` of the
   same bytes. The wide stages are held against their plain versions at
   their edges (``wide_edges``): m = 2 ... 100 across the tile path's
   largest m, B = 1 ... 1027, P = 1, unaligned operands and spikes, a row
   count m does not divide with NaN past it, ignored ends and identity
   rows past P. The SSD stage is held against its plain version (on the CPU)
   at chunk lengths 1 ... 1024 and ragged widths, with its fp32-FMA and
   split-TF32 bounds.
3. ``main``: the port's main path through ``TridiagSession`` on
   ``device="cuda"``, ``backend="auto"`` and the fitted Eq. 4-7 heuristic.
   System-major (``layout="system-major"``): ``solve`` at n = 1e7 (fp64)
   and 1e6 (fp32), ``solve_batched`` at 64 x 100,000, ``solve_many`` on a
   ragged mix of paper sizes and 16 ``submit`` futures, and ``solve`` on
   the stacked (64, 100,000) operands, which runs the batched kernels;
   ``solve`` at n = 1e7 and on the stacked operands with 1 and 8 chunks
   must agree bit for bit; a ``backend="reference"`` session on the card is the plain
   comparison. Interleaved (``layout="auto"``, which must resolve to it):
   ``solve_batched`` at 64 x 100,000 (fp64, fp32) and 1024 x 10,000,
   ``solve_many`` of 48 ragged systems and 64 served ``submit`` requests,
   and the interleaved answer against the system-major one. Staged:
   ``solve_timed`` at n = 1e7 with one CUDA stream per chunk, twice, bit
   for bit, and ``solve_batched_timed`` on the staged interleaved branch.
   Every result is checked against ``x_true``, and the n = 1e7 solve's
   residual max|A x - b| is taken with the matvec kernel; every solver
   kernel's launch counter must rise. The fused path caches a CUDA graph
   per signature: each fused verb runs three times, a cache miss (eager),
   the hit that captures and a replay, which must give the same bits and
   raise each launch counter by exactly one set (the replay's through the
   capture's tally alone); for one verb of each layout the profiler's
   device kernels of a replay must be an eager call's; the 1 and 8 chunk
   answers are compared as replays; the reference backend is cached but
   never captured; the served batches report the cache's hit share. Then
   the functional ``solve_batched`` and ``thomas_batched`` at 64 x 100,000
   (one launch a stage); a hammer: two threads' sessions over an
   executable cache of capacity 2 beside a third thread on the staged path
   (answers, bounded joins, one set of launches a call); and 110 distinct
   n ~ 1e7 graphs, more than the card holds, which the cache's byte budget
   must evict (answers on x_true).
4. ``breakdown``: where the time of one n = 1e7 fp64 solve and of one
   interleaved ``solve_batched`` of 1024 x 10,000 fp64 goes, stage by
   stage, from CUDA events and the host clock around the copies, how long
   the host takes to enqueue the n = 1e7 fused path and its reduced solve,
   and, from ``torch.profiler``, each one's device busy time, idle share
   and largest device entries (the wide reduced solve's too, which must be
   three kernels at P = 1,000, B = 1024: Stage 1, the base, Stage 3).
   Both fused paths are also timed as CUDA graph replays beside their
   eager calls (events in turn, enqueue, device time, profiler), with the
   device memory one cache entry holds (and is charged), which
   ``clear_executable_cache`` must give back.
5. ``closed_loop``: the closed loop at fp64, m = 10, ``backend="cuda"``.
   (a) The paper's experiment on this card: ``measure_dataset`` over the
   paper's 13 sizes from 1,000 to 1e6, ``measure_batched_dataset`` at
   10,000 and 100,000 x batches 1, 4, 16, and ``measure_ragged_dataset`` on
   one mix, each over chunk counts 1 ... 32 through the staged path (one
   CUDA stream per chunk, the reduced solve on the host); a row per size
   prints the median time per chunk count, the empirical optimum, the
   overlappable share and the picks of the shipped heuristic and of
   ``fit_batched_stream_heuristic`` refitted on the card's rows. (b) Fused
   batches of 4 x 25,000, 4 x 100,000, 4 x 1e6 and 4 x 2.5e6 (two
   effective sizes each side of the Eq. 7 regime split) served at each
   fixed chunk count
   (a cache miss, a capture, a replay), their telemetry recorded into one
   ``autotune="live"`` session whose worker refits and swaps the policy on
   its own; each of its batches must carry the chunk count of the refit it
   was priced by, ``plan_for`` the last refit's. (c) With the refit latency
   model and ``max_predicted_ms``, one request whose timeout is under its
   prediction is shed with ``PredictedTimeoutError`` and no launch; then
   deadline-free batches (32 x 10,000 among them, interleaved) print their
   median residuals. The six solver kernels' launch counts must rise.
6. ``mesh``: the multi-device solve on four logical shards of one card,
   ``TridiagSession(SolverConfig(mesh=("cuda:0",) * 4, backend="cuda"))``
   at m = 10, fp64 unless named: ``solve`` at n = 1e7 with
   ``FixedChunkPolicy(8)`` and with the shipped heuristic,
   ``solve_batched`` at 64 x 100,000 (system-major: 16 lanes a shard) and
   at 1024 x 10,000 in fp64 and fp32 (interleaved, 256 lanes a shard),
   ``solve_many`` of 48 ragged systems of 10,000 ... 400,000, 16 served
   ``submit`` requests, and n = 1e7 + 10, whose 1,000,001 blocks snap the
   plan to one shard. Each case must raise the launch counts by one
   sharded set (Stage 1 and Stage 3 once a chunk, the reduced solve once a
   shard; the wide stages once a lane shard), meet ``x_true`` at the
   ladder, and give, through the sharded executor, the bits of the
   unsharded executor on the same plan (system-major; interleaved within
   the ladder, the bits printed); it prints CUDA-event times of the two
   executors in turn (both eager, and against the unsharded graph replay)
   and host-clock times of the sharded and the unsharded session's verb.
   Then the device time the replicated reduced solves add (the reduced
   solve's device time, and the profiler's device busy time of the
   sharded against the unsharded n = 1e7 call with its device kernels),
   ``stats()["mesh"]``, one executable-cache entry each for 4, 2 and no
   shards with the same bits, and ``mesh="auto"`` over every card where
   more than one is visible (else it prints that it skipped). All shards
   share one card: no multi-card time is taken.
7. ``lm``: the LM serving path, ``repro_torch.launch.serve.serve`` →
   ``Model.prefill`` / ``decode_step`` → the blocks (``ssm_apply`` →
   ``ssd_scan_kernel``; ``attention_apply`` with KV caches, ``mlp_apply``,
   ``moe_apply``; the hybrid's shared block; the encoder-decoder's
   ``encode`` and ``decode`` with cross-attention). (a) Full width, fp32,
   TF32 off, the card against the CPU on the same weights (drawn on the
   card, copied to the host): prompts of 2 x 512 tokens (gemma2-27b: 2 x
   256; whisper-medium: 2 x 128 against 1500 frames from a seed) and 4
   greedy decode steps for mamba2-1.3b, qwen3-4b and moonshot-v1-16b-a3b
   with 2 layers, gemma2-27b with 2 (one local/global pair), zamba2-7b with
   7 (one super-block of 6 and a tail layer) and whisper-medium with 2
   encoder and 2 decoder layers; logits and caches (``enc_out`` too) within
   1e-3, tokens identical, one SSD launch per SSM layer on the card's
   prefill; for moonshot the router's expert choices, card against CPU,
   are counted and printed. (b) mamba2-1.3b (48 layers), zamba2-7b (81 SSM
   layers, 13 shared-block calls), qwen3-4b (36 layers),
   moonshot-v1-16b-a3b (48 layers, 64 experts top-6 + 2 shared) and
   whisper-medium (24 + 24 layers, 64 zero frames a batch) at full depth
   in bf16, one at a time, served: 8 requests in 4 slots, one batch padded
   to 1024 tokens (4 chunks), one to 197 (an odd chunk), 16 new tokens
   each, KV caches of 1040 positions; every logit finite, padded logits at
   -1e30, every token in the vocab, one SSD launch per SSM layer a
   prefill; the share of MoE (token, k) choices dropped at prefill.
   whisper-medium also runs one ``Model.prefill`` against [4, 1500, 1024]
   frames (its encoder timed apart) and 4 decode steps against them.
   kimi-k2-1t-a32b at full width cut to one layer: a 4 x 1024 prefill and
   16 decode steps through ``Model.prefill`` / ``decode_step``. Then where
   the time of one 4 x 1024 prefill and of one decode step goes, for
   mamba2-1.3b, zamba2-7b, moonshot-v1-16b-a3b and kimi-k2 (the MoE layer
   split into its expert products, shared experts and the rest of it).

It exits non-zero when there is no CUDA device, when the port cannot be
imported, or when any phase fails. The line before the last is the
``{"kernels": [...]}`` record; the last is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# Peak rates outside the tensor cores, H100 SXM at 700 W (NVIDIA data sheet).
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
# TF32 on the tensor cores, dense (the same data sheet): the SSD kernel's
# unit, where its split-TF32 products take three TF32 products each.
TF32_TC_FLOPS = 495e12
# A sleeping kernel of at least this many cycles (~30 ms) holds the card
# while the host enqueues a run of launches (device_ms, queued_ms); it is
# doubled, at most SLEEP_DOUBLINGS times, when the host is slower.
SLEEP_CYCLES = 60_000_000
SLEEP_DOUBLINGS = 4
# Traces taken of a call before an empty or incomplete one fails.
PROFILE_ATTEMPTS = 5
# Device entries launched at the start of a profiler window to take the
# trace's loss of its first entries; doubled at each attempt after an
# incomplete trace.
PROFILE_PAD = 64
M = 10
ALL_PHASES = ("build", "kernels", "main", "breakdown", "closed_loop", "mesh", "lm")
# The kernels each path launches; its run must raise every one of their counts.
MAIN_KERNELS = ("partition_stage1", "thomas", "partition_stage3", "partition_stage1_wide",
                "thomas_wide", "partition_stage3_wide", "tridiag_matvec")
LM_KERNELS = ("ssd_stage1",)
# The main path's launches replayed from CUDA graphs, by kernel (main_phase).
REPLAYED: Dict[str, int] = {}
# The lm phase's card-against-CPU runs, part (a): (arch, layers, prompt
# length); gemma2-27b's shorter prompts bound the CPU's time.
# whisper-medium's layers are its encoder's and its decoder's each.
LM_PARITY = (("mamba2-1.3b", 2, 512), ("qwen3-4b", 2, 512), ("gemma2-27b", 2, 256),
             ("zamba2-7b", 7, 512), ("moonshot-v1-16b-a3b", 2, 512), ("whisper-medium", 2, 128))
# The archs served at full depth in bf16, part (b), one at a time, and
# those whose time is then broken down.
LM_SERVED = ("mamba2-1.3b", "zamba2-7b", "qwen3-4b", "moonshot-v1-16b-a3b", "whisper-medium")
LM_BREAKDOWNS = ("mamba2-1.3b", "zamba2-7b", "moonshot-v1-16b-a3b")
# kimi-k2-1t-a32b (2.09 TB in bf16) at full width, cut to this many layers.
KIMI_LAYERS = 1
# 48 ragged systems of 60,000 ... 100,000 rows: padded to P_max = 10,000
# blocks they fill 80.0 % of the wide grid, so "auto" interleaves them.
RAGGED_48 = tuple(60_000 + (40_000 * i // 47) // M * M for i in range(48))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed_cuda(fn: Callable[[], Any], reps: int, warmup: int = 2) -> Tuple[float, Any]:
    """Median time of one call of ``fn`` on the card, from CUDA events, and
    the last call's result."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    out = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def cuda_ms(fn: Callable[[], Any], reps: int, warmup: int = 2) -> float:
    return timed_cuda(fn, reps, warmup)[0]


def alternating_ms(fns: List[Callable[[], Any]], reps: int) -> List[float]:
    """Median CUDA-event time of each of ``fns``, called in turn rep after
    rep, so that a drift of the host's speed falls on all of them alike."""
    for fn in fns:
        fn()
    times: List[List[float]] = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            ts.append(cuda_ms(fn, reps=1, warmup=0))
    return [statistics.median(ts) for ts in times]


def host_ms(fn: Callable[[], Any], reps: int = 3) -> float:
    """Median host-clock time of ``fn`` (a copy that ends on the host or
    blocks on one), bracketed by synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def enqueue_ms(fn: Callable[[], Any], reps: int = 3) -> float:
    """Median host-clock time for ``fn`` to return, from an idle card: the
    host's work of enqueuing it. Where it is close to the device time, the
    card waits on the host."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def behind_sleep(enqueue: Callable[[], Any]) -> Any:
    """Run ``enqueue`` (launches with their timing events) while a sleeping
    kernel holds the card, so that the host's launch work is done before the
    card reaches the launches; return its result once the card is done.
    When the sleep ended before ``enqueue`` returned, the card may have
    waited on the host: the run is thrown away and made again behind twice
    the sleep, at most ``SLEEP_DOUBLINGS`` times, then this raises."""
    cycles = SLEEP_CYCLES
    for _ in range(SLEEP_DOUBLINGS + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        out = enqueue()
        in_time = not slept.query()
        torch.cuda.synchronize()
        if in_time:
            return out
        log(f"    (the host outlasted a sleep of {cycles} cycles; timing again behind twice that)")
        cycles *= 2
    raise AssertionError(f"the host outlasted a sleep of {cycles // 2} cycles")


_FLUSH: Dict[int, torch.Tensor] = {}


def device_ms(fn: Callable[[], Any], reps: int = 10) -> float:
    """Median device time (ms) of one call of ``fn``: CUDA events around
    each call, the calls enqueued behind a sleeping kernel (``behind_sleep``)
    so that the host's launch work is not in the reading, and each call
    after a read of a 64 MiB buffer, which evicts the 50 MB L2 (operands
    arrive cold, as from a caller whose data came from elsewhere)."""
    dev = torch.cuda.current_device()
    if dev not in _FLUSH:
        _FLUSH[dev] = torch.zeros(16 * 2**20, device=torch.device("cuda", dev))
    flush = _FLUSH[dev]
    flush.max()  # its workspace, allocated now and not inside the queue
    fn()

    def enqueue() -> List[Tuple[torch.cuda.Event, torch.cuda.Event]]:
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        for start, end in events:
            flush.max()
            start.record()
            fn()
            end.record()
        return events

    return statistics.median(start.elapsed_time(end) for start, end in behind_sleep(enqueue))


def queued_ms(fns: List[Callable[[], Any]], reps: int = 5) -> float:
    """Device time (ms) a call of ``fns``, from CUDA events around all of
    them, enqueued behind a sleeping kernel (``behind_sleep``): they run
    back to back and the reading is the card's alone."""
    for fn in fns:
        fn()

    def enqueue() -> Tuple[torch.cuda.Event, torch.cuda.Event]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for fn in fns:
            fn()
        end.record()
        return start, end

    times = []
    for _ in range(reps):
        start, end = behind_sleep(enqueue)
        times.append(start.elapsed_time(end) / len(fns))
    return statistics.median(times)


def traced(label: str, fn: Callable[[], Any], reps: int) -> List[Tuple[float, int, str]]:
    """``fn`` under ``torch.profiler``: one call outside the trace warms
    it up; inside it, a pad of ``torch.cuda._sleep(0)`` launches (device
    entries named ``spin_kernel``, which no path launches) runs first, then
    ``reps`` calls, each ending on a synchronisation. On this card's hosts
    a trace loses its first few device entries (1 to 8 in the traces read;
    unpadded, the first call of a small ``fn``, or the first Stage 1
    launches of a large one): the pad takes that loss, and a trace in which
    at least one pad entry survived holds every call in full. Returns the device
    entries of the calls, (µs in all, count in all, name). A trace with no
    pad entry, no other device entry, or a count of 0 or not a multiple of
    ``reps`` (every call runs the same kernels) is taken again behind twice
    the pad; after ``PROFILE_ATTEMPTS`` such traces it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = PROFILE_PAD
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        entries, padded = [], 0
        for e in prof.key_averages():
            # Host-side ops also carry their kernels' time: only the
            # device's own entries count.
            if e.device_type != DeviceType.CUDA:
                continue
            if "spin_kernel" in e.key:
                padded += e.count
                continue
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
            entries.append((us, e.count, e.key))
        if padded and entries and all(c > 0 and c % reps == 0 for _, c, _ in entries):
            if padded < pad:
                log(f"    profiler, {label}: the trace lost {pad - padded} of its {pad} pad entries")
            return entries
        log(f"    profiler, {label}: an incomplete trace ({padded} of {pad} pad entries) in attempt "
            f"{attempt} of {PROFILE_ATTEMPTS}: {[(c, k[:40]) for _, c, k in entries]}")
        pad *= 2
    raise AssertionError(f"{label}: the profiler recorded no complete trace in {PROFILE_ATTEMPTS} attempts")


def device_profile(label: str, fn: Callable[[], Any], ms: float, reps: int = 3,
                   top: int = 5) -> List[Tuple[float, int, str]]:
    """The device's busy time a call of ``fn`` from its trace (``traced``;
    the sum of its kernels' and copies' device times; one stream, so they
    do not overlap), its idle share against ``ms`` (the call's CUDA-event
    time, taken without the profiler), and the largest device entries with
    their count a call. Returns the device entries, (ms a call, count a
    call, name), largest first."""
    entries = [(us / reps / 1e3, c // reps, k) for us, c, k in traced(label, fn, reps)]
    entries.sort(reverse=True)
    busy = sum(t for t, _, _ in entries)
    log(f"    profiler, {label}: device busy {busy:.4f} ms a call against {ms:.4f} ms "
        f"(idle share {1 - busy / ms:.3f}); largest: "
        + "; ".join(f"{k[:60]} {t:.4f} ms x{c}" for t, c, k in entries[:top]))
    return entries


def bound(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``ops`` operations at ``peak`` operations a second, the rate of the unit
    the kernel runs them on, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def system(n: int, seed: int, dtype: Any, batch: Tuple[int, ...] = ()) -> Tuple[np.ndarray, ...]:
    from repro_torch.core.tridiag.reference import make_diag_dominant_system

    return make_diag_dominant_system(n, seed=seed, batch=batch, dtype=dtype)


def max_err(a: Any, b: Any) -> float:
    def host(t: Any) -> np.ndarray:
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    return float(np.max(np.abs(host(a).astype(np.float64) - host(b).astype(np.float64))))


# ------------------------------------------------------------------ kernels --
def kernel_phase(dev: torch.device) -> List[Dict[str, Any]]:
    """Each wrapper on the card against its plain version (the reference
    stage of ``repro_torch.core.tridiag``) at the main path's shapes."""
    from repro_torch.core.tridiag import layout
    from repro_torch.core.tridiag.batched import fuse_systems
    from repro_torch.core.tridiag.partition import partition_stage1, partition_stage3
    from repro_torch.core.tridiag.ragged import fuse_ragged
    from repro_torch.core.tridiag.thomas import thomas
    from repro_torch.kernels import common
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.partition_stage1.ops import (
        partition_stage1_cuda,
        partition_stage1_cuda_batched,
        partition_stage1_cuda_wide,
        span_blocks,
    )
    from repro_torch.kernels.partition_stage3.ops import (
        partition_stage3_cuda,
        partition_stage3_cuda_batched,
        partition_stage3_cuda_wide,
    )
    from repro_torch.kernels.thomas.ops import (
        N0,
        R,
        level_sizes,
        thomas_cuda,
        thomas_cuda_wide,
        thomas_levels_cuda,
    )

    sources = {
        "partition_stage1": ("src/repro_torch/csrc/partition_stage1.cu",
                             "src/repro/kernels/partition_stage1/stage1.py:28"),
        "partition_stage3": ("src/repro_torch/csrc/partition_stage3.cu",
                             "src/repro/kernels/partition_stage3/stage3.py:17"),
        "thomas": ("src/repro_torch/csrc/thomas.cu", "src/repro/kernels/thomas/thomas.py:22"),
        "partition_stage1_wide": ("src/repro_torch/csrc/partition_stage1_wide.cu",
                                  "src/repro/kernels/partition_stage1/stage1.py:103"),
        "partition_stage3_wide": ("src/repro_torch/csrc/partition_stage3_wide.cu",
                                  "src/repro/kernels/partition_stage3/stage3.py:51"),
        "thomas_wide": ("src/repro_torch/csrc/thomas.cu", "src/repro/kernels/thomas/thomas.py:22"),
        "tridiag_matvec": ("src/repro_torch/csrc/tridiag_matvec.cu",
                           "src/repro/kernels/tridiag_matvec/matvec.py:13"),
        "ssd_stage1": ("src/repro_torch/csrc/ssd_stage1.cu",
                       "src/repro/kernels/ssd_stage1/ssd1.py:28"),
    }
    rows: List[Dict[str, Any]] = []

    def check(name: str, dtype: torch.dtype, kernel: Callable[[], Any], plain: Callable[[], Any],
              nbytes: float, ops: float, reps: int = 20, plain_reps: int = 5,
              plain_warmup: int = 2,
              library: Optional[Callable[[], Any]] = None,
              peak: Optional[float] = None, host: bool = False) -> Tuple[Any, float]:
        """Run, compare and time one kernel against its plain version (and
        one PyTorch call computing the same function, where there is one);
        returns the kernel's output and its median ms. ``ms`` (and
        ``library_ms``) is CUDA events around one call from an idle card,
        the wrapper's host work included; ``device_ms`` beside it is the
        card's time alone, with a cold L2. ``peak``: the rate of the unit
        that runs the kernel's operations (default: the CUDA cores' rate for
        ``dtype``). With ``host``, the row also gets ``enqueue_ms``, the
        host's time for the wrapper to return from an idle card, which
        accounts for the gap between ``ms`` and ``device_ms``."""
        got = kernel()
        plain_ms, want = timed_cuda(plain, reps=plain_reps, warmup=plain_warmup)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            assert tuple(g.shape) == tuple(w.shape), (name, tuple(g.shape), tuple(w.shape))
            assert_allclose_by_dtype(g, w, dtype)
        err = max(max_err(g, w) for g, w in pairs)
        ms = cuda_ms(kernel, reps=reps)
        dev_ms = device_ms(kernel)
        lib_ms = lib_dev_ms = None
        if library is not None:
            lib_ms, lib_out = timed_cuda(library, reps=reps)
            lib_dev_ms = device_ms(library)
            assert_allclose_by_dtype(lib_out, got, dtype)
        b_ms, b_by = bound(nbytes, ops, PEAK_FLOPS[dtype] if peak is None else peak)
        source, replaces = sources[name.split("/")[0]]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "device_ms": dev_ms,
        }
        if host:
            row["enqueue_ms"] = enqueue_ms(kernel, reps=10)
        rows.append(row)
        log(f"  {name}: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f} "
            f"device_ms={dev_ms:.4f} (share {b_ms / dev_ms:.3f})"
            + (f" enqueue_ms={row['enqueue_ms']:.4f}" if host else "")
            + (f" library_ms={lib_ms:.4f} (device {lib_dev_ms:.4f})" if lib_ms is not None else ""))
        return got, ms

    def stage1_cost(bsz: int, p: int, es: int, m: int = M) -> Tuple[float, float]:
        n = p * m
        nbytes = bsz * (4 * n + 3 * p * (m - 1) + 4 * p) * es
        return nbytes, bsz * p * (6 * (m - 2) + 3 + 9 * (m - 3) + 10)

    def stage3_cost(bsz: int, p: int, es: int, m: int = M) -> Tuple[float, float]:
        return bsz * (3 * p * (m - 1) + p + 1 + p * m) * es, bsz * 4 * p * (m - 1)

    def check_thomas(tag: str, dtype: torch.dtype, es: int, ops4: Tuple[torch.Tensor, ...],
                     wide: bool = False, **kw: Any) -> float:
        if wide:  # (n, B) rows of the interleaved layout
            tn, bsz = tuple(ops4[1].shape)
            name = f"thomas_wide/{tag}/P={tn},B={bsz}"
            kernel, plain = thomas_cuda_wide, layout.thomas_wide
        else:
            bsz, tn = (1, ops4[1].shape[0]) if ops4[1].ndim == 1 else tuple(ops4[1].shape)
            name = f"thomas/{tag}/B={bsz},n={tn}"
            kernel, plain = thomas_cuda, thomas
        got, ms = check(name, dtype, lambda: kernel(*ops4), lambda: plain(*ops4),
                        5 * bsz * tn * es, 8 * bsz * tn, **kw)
        assert torch.equal(kernel(*ops4), got), f"{name}: two calls differ"
        rows2 = ops4 if wide else tuple(a.reshape(-1, tn) for a in ops4)
        at_n0, at_64 = alternating_ms([lambda: thomas_levels_cuda(*rows2, wide=wide),
                                       lambda: thomas_levels_cuda(*rows2, wide=wide, n0=64)],
                                      reps=kw.get("reps", 20))
        log(f"    levels {' -> '.join(map(str, level_sizes(tn)))} (r={R}, n0={N0}); "
            f"two calls bit-identical; alternating: n0={N0} {at_n0:.4f} ms, n0=64 "
            f"({' -> '.join(map(str, level_sizes(tn, n0=64)))}) {at_64:.4f} ms")
        return ms

    def check_stage1(name: str, dtype: torch.dtype, ops4: Tuple[torch.Tensor, ...],
                     batched: bool, nbytes: float, nops: float) -> Any:
        """A system-major Stage 1 row."""
        wrapper = partition_stage1_cuda_batched if batched else partition_stage1_cuda
        c, _ = check(name, dtype, lambda: wrapper(*ops4, m=M),
                     lambda: partition_stage1(*ops4, M), nbytes, nops)
        log(f"    {span_blocks(M, dtype)} blocks a span")
        return c

    def wide_ops(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor,
                 sizes: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
        """Fused 1-D operands (boundary couplings zeroed) → wide (P, m, B)."""
        return layout.interleave_operands(dl, d, du, b, sizes, M)

    def check_wide(tag: str, dtype: torch.dtype, es: int, wide: Tuple[torch.Tensor, ...],
                   seed: int, suffix: str = "") -> Any:
        """Wide Stage 1 and Stage 3 at one interleaved (P, m, B) shape, each
        with its host enqueue time; returns the coeffs."""
        wp, m, wb = wide[1].shape
        label = f"P={wp},m={m},B={wb}{suffix}"
        c, _ = check(f"partition_stage1_wide/{tag}/{label}", dtype,
                     lambda: partition_stage1_cuda_wide(*wide, m=m),
                     lambda: layout.partition_stage1_wide(*wide, m=m), *stage1_cost(wb, wp, es, m),
                     host=True)
        s = torch.as_tensor(np.random.default_rng(seed).standard_normal((wp, wb)), device=dev).to(dtype)
        check(f"partition_stage3_wide/{tag}/{label}", dtype,
              lambda: partition_stage3_cuda_wide(c, s), lambda: layout.partition_stage3_wide(c, s),
              *stage3_cost(wb, wp, es, m), host=True)
        return c

    def level_ops(n: int, bsz: int, seed: int, np_dtype: Any) -> Tuple[torch.Tensor, ...]:
        """A level of the wide reduced solve: (n, B) rows as (n/R, R, B) blocks."""
        return tuple(torch.as_tensor(a, device=dev).T.contiguous().view(n // R, R, bsz)
                     for a in system(n, seed, np_dtype, batch=(bsz,))[:4])

    p = 1_000_000
    for np_dtype, dtype in ((np.float64, torch.float64), (np.float32, torch.float32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        es = torch.empty((), dtype=dtype).element_size()

        # Stage 1 and Stage 3 on one n = 1e7 system (P = 1e6, m = 10), the
        # unchunked shape of the main path's largest solve.
        dl, d, du, b, _ = (torch.as_tensor(a, device=dev) for a in system(p * M, 11, np_dtype))
        c = check_stage1(f"partition_stage1/{tag}/P={p},m={M}", dtype, (dl, d, du, b), False,
                         *stage1_cost(1, p, es))
        s = torch.as_tensor(np.random.default_rng(12).standard_normal(p), device=dev).to(dtype)
        check(f"partition_stage3/{tag}/P={p},m={M}", dtype,
              lambda: partition_stage3_cuda(c, s), lambda: partition_stage3(c, s),
              *stage3_cost(1, p, es))
        copy_yardstick(dev, dtype, stage3_cost(1, p, es)[0], f"Stage 3 at P={p}")
        rows.append(stage3_chunk_row(dev, dtype, M))
        stage3_chunk_row(dev, dtype, R)
        red = (c.red_dl, c.red_d, c.red_du, c.red_b)
        if dtype == torch.float64:
            # The main path's reduced system of the n = 1e7 fp64 solve,
            # P = 1e6 rows. The plain loop takes minutes: one call.
            check_thomas(tag, dtype, es, red, reps=10, plain_reps=1, plain_warmup=0)
            # The sub-block size of the levels, swept on these rows.
            red2 = tuple(a[None] for a in red)
            rs = (8, 16, 32)
            sweep = alternating_ms([lambda r=r: thomas_levels_cuda(*red2, wide=False, r=r)
                                    for r in rs], reps=30)
            log("    r sweep at B=1, n=1e6 fp64: " + "; ".join(
                f"r={r} ({' -> '.join(map(str, level_sizes(p, r)))}) {t:.4f} ms"
                for r, t in zip(rs, sweep)) + f"; chosen r={R}")
        del dl, d, du, b, c, s, red

        if dtype == torch.float32:
            # The reduced system of the n = 1e6 fp32 solve (P = 1e5).
            c = partition_stage1_cuda(*(torch.as_tensor(a, device=dev)
                                        for a in system(p, 12, np_dtype)[:4]), m=M)
            check_thomas(tag, dtype, es, (c.red_dl, c.red_d, c.red_du, c.red_b),
                         reps=5, plain_reps=1, plain_warmup=0)
            del c

        # The stacked (64, 100,000) solve: batched Stage 1 and Stage 3 (the
        # next-block shift and s_left stop at each system's edge), and its
        # reduced system of 64 x 10,000 rows.
        bsz, bn = 64, 100_000
        bp = bn // M
        dl, d, du, b, _ = (torch.as_tensor(a, device=dev)
                           for a in system(bn, 14, np_dtype, batch=(bsz,)))
        c = check_stage1(f"partition_stage1/{tag}/B={bsz},P={bp},m={M}", dtype, (dl, d, du, b),
                         True, *stage1_cost(bsz, bp, es))
        s = torch.as_tensor(np.random.default_rng(15).standard_normal((bsz, bp)), device=dev).to(dtype)
        left = torch.as_tensor(np.random.default_rng(16).standard_normal(bsz), device=dev).to(dtype)
        check(f"partition_stage3/{tag}/B={bsz},P={bp},m={M}", dtype,
              lambda: partition_stage3_cuda_batched(c, s, left),
              lambda: partition_stage3(c, s, left), *stage3_cost(bsz, bp, es))
        check_thomas(tag, dtype, es, (c.red_dl, c.red_d, c.red_du, c.red_b),
                     reps=5, plain_reps=2, plain_warmup=1)
        del dl, d, du, b, c, s, left

        # The interleaved solve_batched of 64 x 100,000: wide Stage 1/Stage 3
        # on (10,000, m, 64) and the wide Thomas on its (10,000, 64) reduced
        # rows, beside the (B, n) route on the same rows transposed (is the
        # (B, n) route slow because its loads are uncoalesced?).
        fused = fuse_systems(*(torch.as_tensor(a, device=dev) for a in system(bn, 17, np_dtype, batch=(bsz,))[:4]))
        c = check_wide(tag, dtype, es, wide_ops(*fused, (bn,) * bsz), seed=18)
        red_w = (c.red_dl, c.red_d, c.red_du, c.red_b)
        wide_ms = check_thomas(tag, dtype, es, red_w, wide=True, reps=5, plain_reps=1, plain_warmup=1)
        red_t = tuple(a.T.contiguous() for a in red_w)
        sm_ms = cuda_ms(lambda: thomas_cuda(*red_t), reps=5)
        assert_allclose_by_dtype(thomas_cuda(*red_t).T, thomas_cuda_wide(*red_w), dtype)
        log(f"    same rows on the (B, n) route: {sm_ms:.4f} ms, wide/(B, n) = {wide_ms / sm_ms:.3f}")
        del fused, c, red_w, red_t
        # The first level of that wide reduced solve: P = 313 blocks of
        # m = R rows (10,000 rows padded to 10,016), B = 64.
        check_wide(tag, dtype, es, level_ops(common.round_up(bn // M, R), bsz, 22, np_dtype),
                   seed=23, suffix=",level")

        if dtype == torch.float64:
            # solve_batched of 1024 x 10,000 (P = 1,000, B = 1024).
            fused = fuse_systems(*(torch.as_tensor(a, device=dev)
                                   for a in system(10_000, 19, np_dtype, batch=(1024,))[:4]))
            c = check_wide(tag, dtype, es, wide_ops(*fused, (10_000,) * 1024), seed=20)
            check_thomas(tag, dtype, es, (c.red_dl, c.red_d, c.red_du, c.red_b), wide=True,
                         reps=5, plain_reps=1, plain_warmup=1)
            del fused, c
            # Its first level: P = 32 blocks of m = R rows (1,000 rows
            # padded to 1,024), B = 1024.
            check_wide(tag, dtype, es, level_ops(common.round_up(1_000, R), 1024, 24, np_dtype),
                       seed=25, suffix=",level")
            # solve_many of 48 ragged systems, 60,000 ... 100,000 rows: the
            # shorter ones padded with identity blocks to P_max = 10,000.
            sizes = RAGGED_48
            fl = fuse_ragged([tuple(torch.as_tensor(a, device=dev) for a in system(nr, 300 + i, np_dtype)[:4])
                              for i, nr in enumerate(sizes)])
            check_wide(tag, dtype, es, wide_ops(*fl[:4], sizes), seed=21, suffix=",ragged")
            del fl

        # Thomas on a batch of 256 and on one system at n = 4096.
        for tb in (256, 1):
            ops_np = system(4096, 13 + tb, np_dtype, batch=(tb,) if tb > 1 else ())
            check_thomas(tag, dtype, es, tuple(torch.as_tensor(a, device=dev) for a in ops_np[:4]),
                         plain_reps=2, plain_warmup=1)

        thomas_edges(dev, np_dtype, dtype)
        thomas_ignored_ends(dev, np_dtype, dtype)
        stage1_edges(dev, np_dtype, dtype)
        stage3_edges(dev, np_dtype, dtype)
        wide_edges(dev, np_dtype, dtype)
        if dtype == torch.float64:
            n0_sweep(dev)

    lm_kernel_rows(dev, check)
    return rows


def thomas_edges(dev: torch.device, np_dtype: Any, dtype: torch.dtype) -> None:
    """The reduced solve on both routes at the edges of its level structure
    (no level, the base at its edges, one, two and three levels; B = 1, 3,
    64) against the fp64 host oracle ``thomas_numpy``, which takes the 64
    systems at once (at the three-level size the plain PyTorch loop would
    take minutes). Two calls must give the same bits."""
    from repro_torch.core.tridiag.reference import thomas_numpy
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.thomas.ops import N0, R, level_sizes, thomas_cuda, thomas_cuda_wide

    sizes = (1, 2, N0, N0 + 1, R * N0 - 1, R * N0 + 1, R * R * N0 + 1)
    errs = []
    for n in sizes:
        host = system(n, 500 + n, np_dtype, batch=(64,))[:4]
        want = thomas_numpy(*host)
        ops = [torch.as_tensor(a, device=dev) for a in host]
        for wide in (False, True):
            for bsz in (1, 3, 64):
                sub = [a[:bsz].T.contiguous() if wide else a[:bsz].contiguous() for a in ops]
                kernel = thomas_cuda_wide if wide else thomas_cuda
                got = kernel(*sub)
                assert torch.equal(kernel(*sub), got), (wide, n, bsz)
                got = got.T if wide else got
                assert_allclose_by_dtype(got, want[:bsz], dtype)
                errs.append(max_err(got, want[:bsz]))
    log(f"  thomas / thomas_wide at the level edges, {np_dtype.__name__}: n in {sizes} "
        f"(levels of the last: {' -> '.join(map(str, level_sizes(sizes[-1])))}), B in (1, 3, 64), "
        f"both routes: max_abs_err={max(errs):.3e} against thomas_numpy, two calls bit-identical")


def thomas_ignored_ends(dev: torch.device, np_dtype: Any, dtype: torch.dtype) -> None:
    """Thomas ignores each system's dl[0] and du[n-1]; the partition couples
    through them. At sizes r divides, the (B, n) route reads the caller's
    operands with those couplings read as zero in Stage 1, and the wide
    route copies them zeroed. Large couplings (+-1e3) must give the
    oracle's answer on the zeroed operands (``make_diag_dominant_system``
    zeroes both), and stay in the caller's tensors; B = 1, 3, 64 (systems
    meet inside a batch)."""
    from repro_torch.core.tridiag.reference import thomas_numpy
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.thomas.ops import N0, R, level_sizes, thomas_cuda, thomas_cuda_wide

    sizes = (R * N0, R * R * N0)
    errs = []
    for n in sizes:
        host = [np.array(a) for a in system(n, 900 + n, np_dtype, batch=(64,))[:4]]
        want = thomas_numpy(*host)
        host[0][:, 0] = 1e3
        host[2][:, -1] = -1e3
        ops = [torch.as_tensor(a, device=dev) for a in host]
        for wide in (False, True):
            for bsz in (1, 3, 64):
                sub = [a[:bsz].T.contiguous() if wide else a[:bsz].contiguous() for a in ops]
                kept = [a.clone() for a in sub]
                got = (thomas_cuda_wide if wide else thomas_cuda)(*sub)
                assert all(torch.equal(a, k) for a, k in zip(sub, kept)), (wide, n, bsz)
                got = got.T if wide else got
                assert_allclose_by_dtype(got, want[:bsz], dtype)
                errs.append(max_err(got, want[:bsz]))
    log(f"  thomas / thomas_wide with dl[0] = 1e3, du[n-1] = -1e3, {np_dtype.__name__}: "
        f"n in {sizes} (levels {[level_sizes(n) for n in sizes]}), B in (1, 3, 64), both routes: "
        f"max_abs_err={max(errs):.3e} against thomas_numpy on zeroed couplings; "
        f"caller's tensors unchanged")


def n0_sweep(dev: torch.device) -> None:
    """The base size n0: one level and the one-thread base at n0 = 64
    against the base alone (n0 = n) on the same fp64 rows, both through
    the reduced solve's entry, for n = 65 ... 2000 (one level: n/R <= 64)
    on the (B, n) route at B = 1 and 64 and the wide route at B = 64. Where
    the base alone is faster, a larger n0 is. The two calls alternate, so
    the host's drift between calls falls on both."""
    from repro_torch.kernels.thomas.ops import N0, thomas_levels_cuda

    for wide, bsz in ((False, 1), (False, 64), (True, 64)):
        cells = []
        for n in (65, 100, 150, 200, 300, 500, 700, 1000, 2000):
            ops = [torch.as_tensor(a, device=dev) for a in system(n, 800 + n, np.float64, batch=(bsz,))[:4]]
            if wide:
                ops = [a.T.contiguous() for a in ops]
            lv, ch = alternating_ms([lambda: thomas_levels_cuda(*ops, wide=wide, n0=64),
                                     lambda: thomas_levels_cuda(*ops, wide=wide, n0=n)], reps=30)
            cells.append(f"n={n} {lv:.4f}/{ch:.4f}")
        route = "thomas_wide" if wide else "thomas"
        log(f"    n0 sweep, {route} B={bsz} fp64, ms with one level / base alone: "
            + "; ".join(cells) + f"; chosen N0={N0}")


def stage1_edges(dev: torch.device, np_dtype: Any, dtype: torch.dtype) -> None:
    """System-major Stage 1 against its plain version over the block sizes
    it takes: the smallest, the main path's m, the reduced solve's R, the
    largest staged through shared memory and the first walked from device
    memory; B = 3 systems of P = 1000 blocks (a ragged last span)."""
    from repro_torch.core.tridiag.partition import partition_stage1
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_batched, span_blocks
    from repro_torch.kernels.thomas.ops import R

    ms = (2, 3, M, R, 64, 65, 100)
    errs = []
    for m in ms:
        ops = [torch.as_tensor(a, device=dev) for a in system(1000 * m, 700 + m, np_dtype, batch=(3,))[:4]]
        got = partition_stage1_cuda_batched(*ops, m=m)
        for g, w in zip(got, partition_stage1(*ops, m)):
            assert_allclose_by_dtype(g, w, dtype)
            errs.append(max_err(g, w))
    log(f"  partition_stage1 at the block-size edges, {np_dtype.__name__}: m in {ms} "
        f"(blocks a span: {[span_blocks(m, dtype) for m in ms]}), B=3, P=1000: "
        f"max_abs_err={max(errs):.3e}")


def stage3_edges(dev: torch.device, np_dtype: Any, dtype: torch.dtype) -> None:
    """System-major Stage 3 against its plain version: block sizes m = 2 ...
    100 (the two compiled sizes 10 and R = 32 among them) and one past the
    largest span staged in shared memory (m = 2733, read straight from
    device memory) at B = 3 systems; the reduced solve's level shapes at
    m = R (B = 1, n = 1e6 and B = 64, n = 10,000); spikes at element
    offsets that leave them unaligned to 16 bytes; a nonzero ``left``."""
    from repro_torch.core.tridiag.partition import PartitionCoeffs, partition_stage3
    from repro_torch.kernels.common import assert_allclose_by_dtype, cdiv
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_batched
    from repro_torch.kernels.thomas.ops import R, level_sizes

    rng = np.random.default_rng(950)

    def rand(shape: Tuple[int, ...], offset: int) -> torch.Tensor:
        size = int(np.prod(shape))
        buf = torch.as_tensor(rng.standard_normal(size + offset), device=dev).to(dtype)
        return buf[offset:].view(shape)  # contiguous, `offset` elements past an aligned start

    cases = [(3, 1000, m) for m in (2, 3, M, R, 64, 65, 100)] + [(3, 10, 2733)]
    cases += [(1, cdiv(lv, R), R) for lv in level_sizes(1_000_000)[:-1]]
    cases += [(64, cdiv(lv, R), R) for lv in level_sizes(10_000)[:-1]]
    errs = []
    for bsz, pb, m in cases:
        for offsets in ((0, 0, 0), (1, 2, 3)):
            y, v, w = (rand((bsz, pb, m - 1), o) for o in offsets)
            sv, left = rand((bsz, pb), 1), rand((bsz,), 0)
            c = PartitionCoeffs(y, v, w, *(sv,) * 4)
            got = partition_stage3_cuda_batched(c, sv, left)
            want = partition_stage3(c, sv, left)
            assert_allclose_by_dtype(got, want, dtype)
            errs.append(max_err(got, want))
    log(f"  partition_stage3 at the edges, {np_dtype.__name__}: (B, P, m) in {cases}, spikes at "
        f"element offsets 0 and 1/2/3, nonzero left: max_abs_err={max(errs):.3e}")


def wide_edges(dev: torch.device, np_dtype: Any, dtype: torch.dtype) -> None:
    """The wide Stage 1 and Stage 3 against their plain versions at their
    edges: m = 2, 3, M, R, the tile path's largest m and the first past it,
    and 100; B = 1, 3, 48, 64, 1000, 1027 lanes (rows of 16 bytes or not);
    P = 37 (a ragged last tile) and P = 1. At each (m, B): (P, m, B)
    operands and spikes as allocated and at element offsets 1/2/3 (not 16
    bytes aligned); then Stage 1 on (n, B) rows with n = P*m - max(1, m//3),
    at offsets 0 and 1/2/3, the caller's buffer NaN past row n (a kernel
    that loaded those rows would not stay finite), dl[0] = 1e3 and
    du[n-1] = -1e3 read as zero (``zero_ends``), and red_rows = P + 5,
    whose identity rows past P must be exact. At each m, Stage 3 also at
    2**17 columns, where one thread takes each (block, lane group)."""
    from repro_torch.core.tridiag import layout
    from repro_torch.core.tridiag.partition import PartitionCoeffs
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.partition_stage1.ops import (
        partition_stage1_cuda_wide,
        run_stage1_wide,
        wide_tile_blocks,
    )
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_wide
    from repro_torch.kernels.thomas.ops import R

    largest = 2
    while wide_tile_blocks(largest + 1) > 0:
        largest += 1
    ms = (2, 3, M, R, largest, largest + 1, 100)
    lanes = (1, 3, 48, 64, 1000, 1027)
    rng = np.random.default_rng(970)
    nan = float("nan")
    es = torch.empty((), dtype=dtype).element_size()

    def placed(a: torch.Tensor, offset: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """``a`` copied into a NaN buffer, ``offset`` elements past an
        aligned start, with a row of NaN after it."""
        size = int(np.prod(shape))
        buf = torch.full((offset + size + shape[-1],), nan, dtype=dtype, device=dev)
        view = buf[offset:offset + size].view(shape)
        view.copy_(a.reshape(shape))
        return view

    def compare(got: Any, want: Any) -> float:
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            assert tuple(g.shape) == tuple(w.shape), (tuple(g.shape), tuple(w.shape))
            assert bool(torch.isfinite(g).all()), "non-finite output"
            assert_allclose_by_dtype(g, w, dtype)
        return max(max_err(g, w) for g, w in pairs)

    errs = []
    cases = 0
    for m in ms:
        for bsz in lanes:
            for pb in (37, 1):
                n = pb * m
                host = system(n, 1000 + m + bsz + pb, np_dtype, batch=(bsz,))[:4]
                rows = [torch.as_tensor(a, device=dev).T.contiguous() for a in host]
                for offsets in ((0, 0, 0, 0), (1, 2, 3, 0)):
                    wide = tuple(placed(a, o, (pb, m, bsz)) for a, o in zip(rows, offsets))
                    c = partition_stage1_cuda_wide(*wide, m=m)
                    errs.append(compare(tuple(c), tuple(layout.partition_stage1_wide(*wide, m=m))))
                    spikes = [placed(a, o, (pb, m - 1, bsz)) for a, o in zip(c[:3], offsets)]
                    sv = placed(torch.as_tensor(rng.standard_normal((pb, bsz)), device=dev).to(dtype),
                                offsets[0], (pb, bsz))
                    cs = PartitionCoeffs(*spikes, *(sv,) * 4)
                    errs.append(compare(partition_stage3_cuda_wide(cs, sv),
                                        layout.partition_stage3_wide(cs, sv)))
                    cases += 2
                if pb == 1:
                    continue
                # A row count m does not divide, ends to be ignored, NaN past n.
                n = pb * m - max(1, m // 3)
                loud = [a[:n].clone() for a in rows]
                loud[0][0] = 1e3
                loud[2][n - 1] = -1e3
                for offsets in ((0, 0, 0, 0), (1, 2, 3, 0)):
                    ops = [placed(a, o, (n, bsz)) for a, o in zip(loud, offsets)]
                    got = run_stage1_wide(*ops, m, red_rows=pb + 5, zero_ends=True)
                    torch.cuda.synchronize()
                    want = layout.partition_stage1_wide(*ops, m=m, zero_ends=True)
                    errs.append(compare(tuple(got[:3]) + tuple(a[:pb] for a in got[3:]), tuple(want)))
                    for a, fill in zip(got[3:], (0.0, 1.0, 0.0, 0.0)):
                        assert bool((a[pb:] == fill).all()), "identity rows past P"
                    cases += 1
        # Stage 3 from 2**17 (block, lane group) columns up, where one
        # thread takes a column: 16-byte lane groups (B = 1024) and lanes
        # one by one (B = 1027, and spikes at offsets 1/2/3).
        for bsz, offsets in ((1024, (0, 0, 0, 0)), (1027, (0, 0, 0, 0)), (1024, (1, 2, 3, 0))):
            groups = bsz // (16 // es) if bsz * es % 16 == 0 and offsets[0] == 0 else bsz
            pb = -(-2**17 // groups)
            spikes = [placed(torch.as_tensor(rng.standard_normal((pb, m - 1, bsz)), device=dev).to(dtype),
                             o, (pb, m - 1, bsz)) for o in offsets[:3]]
            sv = torch.as_tensor(rng.standard_normal((pb, bsz)), device=dev).to(dtype)
            cs = PartitionCoeffs(*spikes, *(sv,) * 4)
            errs.append(compare(partition_stage3_cuda_wide(cs, sv), layout.partition_stage3_wide(cs, sv)))
            cases += 1
    log(f"  partition_stage1_wide / partition_stage3_wide at the edges, {np_dtype.__name__}: "
        f"m in {ms} (tile blocks {[wide_tile_blocks(m) for m in ms]}), B in {lanes}, P in (37, 1), "
        f"operands and spikes at offsets 0 and 1/2/3; (n, B) rows with n = P*m - max(1, m//3), "
        f"NaN past n, dl[0] = 1e3, du[n-1] = -1e3 with zero_ends, red_rows = P + 5: {cases} cases, "
        f"max_abs_err={max(errs):.3e}, identity rows exact")


def copy_yardstick(dev: torch.device, dtype: torch.dtype, nbytes: float, label: str) -> None:
    """The card's achievable streaming rate: a device-to-device ``copy_``
    that reads and writes ``nbytes`` in all (a yardstick; the port never
    calls it)."""
    es = torch.empty((), dtype=dtype).element_size()
    src = torch.ones(int(nbytes / 2 / es), dtype=dtype, device=dev)
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src))
    log(f"    copy_ yardstick, the bytes of {label} ({nbytes / 1e6:.1f} MB read + written): "
        f"device_ms={ms:.4f}, {nbytes / ms / 1e6:.1f} GB/s against {HBM_BYTES_PER_S / 1e9:.0f} GB/s")


def stage3_chunk_row(dev: torch.device, dtype: torch.dtype, m: int) -> Dict[str, Any]:
    """Stage 3 at P = 31,250 blocks: one of the 32 chunks of the n = 1e7
    solve at m = M (with the neighbouring chunk's ``left``), and the first
    level of the reduced solve of 1e6 rows at m = R. One operand set fits
    the 50 MB L2, so the timed calls rotate through enough sets to exceed
    64 MB: ``ms`` is CUDA events around one call from an idle card, as every
    kernel row; ``device_ms`` the same calls back to back behind a sleeping
    kernel (``queued_ms``), the card's time alone. Beside them: one set
    again and again back to back (warm, in L2, as a level's Stage 3 finds
    its spikes just after its Stage 1), a one-element ``zero_`` kernel (the
    launch floor) and a ``copy_`` of the same bytes."""
    from repro_torch.core.tridiag.partition import PartitionCoeffs, partition_stage3
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda

    pb = 10_000_000 // M // 32
    tag = "f64" if dtype == torch.float64 else "f32"
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (3 * pb * (m - 1) + pb + 1 + pb * m) * es
    ops = 4 * pb * (m - 1)
    nsets = max(8, int(np.ceil(64e6 / nbytes)))
    rng = np.random.default_rng(960 + m)
    sets = []
    for _ in range(nsets):
        y, v, w = (torch.as_tensor(rng.standard_normal((pb, m - 1)), device=dev).to(dtype)
                   for _ in range(3))
        sv = torch.as_tensor(rng.standard_normal(pb), device=dev).to(dtype)
        left = torch.as_tensor(rng.standard_normal(()), device=dev).to(dtype)
        sets.append((PartitionCoeffs(y, v, w, *(sv,) * 4), sv, left))
    got = partition_stage3_cuda(*sets[0])
    plain_ms, want = timed_cuda(lambda: partition_stage3(*sets[0]), reps=5)
    assert_allclose_by_dtype(got, want, dtype)
    turn = itertools.cycle(sets)
    ms = cuda_ms(lambda: partition_stage3_cuda(*next(turn)), reps=3 * nsets)
    dev_ms = queued_ms([lambda st=st: partition_stage3_cuda(*st) for st in sets] * 3)
    warm = queued_ms([lambda: partition_stage3_cuda(*sets[0])] * (3 * nsets))
    tiny = torch.zeros(1, dtype=dtype, device=dev)
    floor = queued_ms([tiny.zero_] * 64)
    alone = cuda_ms(tiny.zero_, reps=20)
    half = int(nbytes / 2 / es)
    bufs = [(torch.ones(half, dtype=dtype, device=dev), torch.empty(half, dtype=dtype, device=dev))
            for _ in range(nsets)]
    copy_ms = queued_ms([lambda s_=s_, d_=d_: d_.copy_(s_) for s_, d_ in bufs] * 3)
    b_ms, b_by = bound(nbytes, ops, PEAK_FLOPS[dtype])
    name = f"partition_stage3/{tag}/P={pb},m={m},chunk"
    log(f"  {name}: {nsets} operand sets ({nsets * nbytes / 1e6:.1f} MB) in turn: ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f} "
        f"device_ms={dev_ms:.4f} (back to back, share {b_ms / dev_ms:.3f}); one set back to back "
        f"(warm L2) {warm:.4f} ms; launch floor (one-element zero_) {floor:.4f} ms back to back, "
        f"{alone:.4f} ms by events around one launch; copy_ of the same bytes back to back "
        f"{copy_ms:.4f} ms ({nbytes / copy_ms / 1e6:.1f} GB/s)")
    return {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/partition_stage3.cu",
            "replaces": "src/repro/kernels/partition_stage3/stage3.py:17", "launches": None,
            "max_abs_err": max_err(got, want), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "device_ms": dev_ms}


def lm_kernel_rows(dev: torch.device, check: Callable[..., Tuple[Any, float]]) -> None:
    """The tridiagonal matvec and the SSD intra-chunk stage against their
    plain versions, at the shapes their paths give them."""
    from repro_torch.core.tridiag.matvec import tridiag_matvec
    from repro_torch.kernels.ssd_stage1.ops import ssd_scan_kernel, ssd_stage1_cuda
    from repro_torch.kernels.tridiag_matvec.ops import tridiag_matvec_cuda
    from repro_torch.models.layers.ssm import ssd_scan, ssd_stage1

    # The residual check of the main path's n = 1e7 fp64 solve, and an fp32
    # system whose length is a multiple of nothing. The library call is a
    # CSR sparse product on the same matrix (built outside the timing).
    for n, dtype in ((10_000_000, torch.float64), (1_000_003, torch.float32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        dl, d, du, _, x = (torch.as_tensor(a, device=dev).to(dtype)
                           for a in system(n, 30, np.float64))
        rows_i = torch.arange(n, device=dev)
        idx = torch.stack([torch.cat([rows_i[1:], rows_i, rows_i[:-1]]),
                           torch.cat([rows_i[:-1], rows_i, rows_i[1:]])])
        csr = torch.sparse_coo_tensor(idx, torch.cat([dl[1:], d, du[:-1]]), (n, n)).coalesce().to_sparse_csr()
        es = torch.empty((), dtype=dtype).element_size()
        check(f"tridiag_matvec/{tag}/N={n}", dtype, lambda: tridiag_matvec_cuda(dl, d, du, x),
              lambda: tridiag_matvec(dl, d, du, x), 5 * n * es, 5 * n,
              library=lambda: (csr @ x[:, None])[:, 0])
        del dl, d, du, x, csr, idx

    # SSD Stage 1 at mamba2-1.3b's widths (H = 64 heads of P = 64, N = 128)
    # and at zamba2-7b's (H = 112 heads of P = 64, N = 64: a state pass of
    # half its N tile, two K slices of the scores): the 4 x 1024-token
    # prefill's G = 16 cells of Q = 256, and the odd chunk of a batch padded
    # to 197 tokens. Inputs as in tests/test_kernel_ssd.py. The kernel runs
    # its products on the tensor cores in split TF32, three TF32 products
    # for each fp32 one: its bound is 3 x the operations at the TF32 rate;
    # the fp32-FMA bound on the CUDA cores is printed beside.
    for nh, p, n in ((64, 64, 128), (112, 64, 64)):
        for g, q in ((16, 256), (4, 197)):
            u, dac, b, c = ssd_inputs(dev, g, q, nh, p, n, seed=g + q)
            nbytes, macs = ssd_cost(g, q, nh, p, n)
            _, ms = check(f"ssd_stage1/G={g},Q={q},H={nh},P={p},N={n}", torch.float32,
                          lambda: ssd_stage1_cuda(u, dac, b, c), lambda: ssd_stage1(u, dac, b, c),
                          nbytes, 3 * 2 * macs, peak=TF32_TC_FLOPS)
            fma_ms, _ = bound(nbytes, 2 * macs, PEAK_FLOPS[torch.float32])
            log(f"    {2 * macs / 1e9:.3f} GFLOP: fp32-FMA bound {fma_ms:.4f} ms (CUDA cores, 67 "
                f"TFLOP/s, share {fma_ms / ms:.3f}); split-TF32 bound "
                f"{bound(nbytes, 6 * macs, TF32_TC_FLOPS)[0]:.4f} ms (tensor cores, 3 x the "
                f"operations at 495 TFLOP/s)")
            del u, dac, b, c
    ssd_edges(dev)

    # The whole chunked scan through the kernel against the plain scan, with
    # and without an incoming state, at 1e-4 (tests/test_kernel_ssd.py), at
    # both models' widths.
    rng = np.random.default_rng(40)
    bsz, s = 2, 1024
    for nh, p, n in ((64, 64, 128), (112, 64, 64)):
        x = torch.as_tensor(rng.standard_normal((bsz, s, nh, p)) * 0.5, device=dev).float()
        dt = torch.as_tensor(np.log1p(np.exp(rng.standard_normal((bsz, s, nh)))), device=dev).float()
        a = torch.as_tensor(-np.exp(rng.standard_normal(nh) * 0.3), device=dev).float()
        b_in, c_in = (torch.as_tensor(rng.standard_normal((bsz, s, n)) * 0.5, device=dev).float()
                      for _ in range(2))
        for h0 in (None, torch.full((bsz, nh, p, n), 0.1, device=dev)):
            got = ssd_scan_kernel(x, dt, a, b_in, c_in, chunk=256, h0=h0)
            want = ssd_scan(x, dt, a, b_in, c_in, chunk=256, h0=h0)
            errs = []
            for gt, wt in zip(got, want):
                np.testing.assert_allclose(gt.cpu().numpy(), wt.cpu().numpy(), rtol=1e-4, atol=1e-4)
                errs.append(max_err(gt, wt))
            log(f"  ssd_scan_kernel vs ssd_scan, B={bsz}, S={s}, H={nh}, P={p}, N={n}, chunk=256, "
                f"h0={'None' if h0 is None else '0.1'}: max_abs_err y={errs[0]:.3e} "
                f"state={errs[1]:.3e}")

def ssd_inputs(dev: torch.device, g: int, q: int, nh: int, p: int, n: int,
               seed: int) -> Tuple[torch.Tensor, ...]:
    """SSD Stage 1 inputs (u, dac, b, c) as in tests/test_kernel_ssd.py."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((g, q, nh, p)) * 0.5, device=dev).float()
    dac = torch.as_tensor(-0.1 * np.log1p(np.exp(rng.standard_normal((g, q, nh)))),
                          device=dev).float()
    b, c = (torch.as_tensor(rng.standard_normal((g, q, n)) * 0.5, device=dev).float()
            for _ in range(2))
    return u, dac, b, c


def ssd_cost(g: int, q: int, nh: int, p: int, n: int) -> Tuple[float, float]:
    """Bytes (each input read once, each output written once) and
    multiply-adds of SSD Stage 1 (the causal half of the scores and of y)."""
    causal = q * (q + 1) // 2  # the (q, k <= q) pairs
    macs = g * (causal * n + nh * causal * p + nh * q * p * n)
    nbytes = 4 * g * (2 * q * nh * p + q * nh + 2 * q * n + nh * p * n)
    return nbytes, macs


def ssd_edges(dev: torch.device) -> None:
    """SSD Stage 1 against its plain version at the fp32 ladder over the
    chunk lengths it takes (1 ... MAX_CHUNK = 1024, the odd 197 among them)
    at mamba2-1.3b's widths, and at widths that leave ragged tiles of P
    and N and unaligned rows (P = 20 and 130, N = 36 and 200, N = 6). The
    plain version runs on the CPU here: on the card, torch's fp32 cumsum of
    the decays errs by about 1e-4 at |cum| ~ 85 (Q = 1024), which alone
    takes the plain version off the ladder against an fp64 reference; the
    CPU's sequential cumsum does not."""
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.ssd_stage1.ops import ssd_stage1_cuda
    from repro_torch.models.layers.ssm import ssd_stage1

    shapes = [(2, q, 64, 64, 128) for q in (1, 7, 64, 197, 256)] + [(1, 1024, 64, 64, 128)]
    shapes += [(3, 97, 3, 20, 36), (2, 130, 2, 130, 200), (2, 33, 4, 6, 6)]
    errs = []
    for i, (g, q, nh, p, n) in enumerate(shapes):
        ins = ssd_inputs(dev, g, q, nh, p, n, seed=900 + i)
        got, want = ssd_stage1_cuda(*ins), ssd_stage1(*(t.cpu() for t in ins))
        for gt, wt in zip(got, want):
            assert_allclose_by_dtype(gt, wt, torch.float32)
        errs.append(max(max_err(gt, wt) for gt, wt in zip(got, want)))
    log("  ssd_stage1 at the edges against the plain version on the CPU, (G, Q, H, P, N) -> "
        "max_abs_err: "
        + "; ".join(f"{sh} {e:.3e}" for sh, e in zip(shapes, errs)))

    # At Q = 1024 both the kernel and the plain version on the card against
    # an fp64 version of the same formula, on the card.
    ins = ssd_inputs(dev, 1, 1024, 64, 64, 128, seed=900 + shapes.index((1, 1024, 64, 64, 128)))
    u, dac, b, c = (t.double() for t in ins)
    cum = torch.cumsum(dac, 1).movedim(-1, -2)  # [G, H, Q]
    causal = torch.ones(1024, 1024, dtype=torch.bool, device=dev).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.exp(torch.where(causal, diff, torch.full((), -1e300, dtype=torch.float64, device=dev)))
    y64 = torch.einsum("ghqk,gkhp->gqhp", torch.einsum("gqn,gkn->gqk", c, b)[:, None] * decay, u)
    for label, y in (("kernel", ssd_stage1_cuda(*ins)[0]), ("plain on the card", ssd_stage1(*ins)[0])):
        e = (y.double() - y64).abs()
        off = int((e > 1e-4 + 1e-5 * y64.abs()).sum())
        log(f"    Q=1024, y against fp64: {label} max_abs_err {e.max().item():.3e}, "
            f"{off} elements off the fp32 ladder")


# --------------------------------------------------------------------- main --
def main_phase(dev: torch.device) -> Dict[str, int]:
    from repro_torch.api import (
        HeuristicChunkPolicy,
        SolveRequest,
        SolverConfig,
        TridiagSession,
        clear_executable_cache,
        executable_cache_stats,
        set_executable_cache_capacity,
    )
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator
    from repro_torch.core.tridiag import plan as plan_mod
    from repro_torch.kernels import LAUNCH_COUNTERS, tridiag_matvec_cuda
    from repro_torch.kernels.common import assert_allclose_by_dtype

    heuristic = fit_stream_heuristic(StreamSimulator(seed=1).dataset(reps=2))
    # The system-major verbs stay pinned to that layout, so their numbers
    # stay comparable across runs; "auto" would interleave solve_batched.
    cfg = SolverConfig(m=M, device="cuda", backend="auto", policy=HeuristicChunkPolicy(heuristic),
                       layout="system-major")

    big = system(10_000_000, 1, np.float64)
    mid32 = system(1_000_000, 2, np.float32)
    batched = system(100_000, 3, np.float64, batch=(64,))
    ragged_sizes = (10_000, 40_000, 50_000, 80_000, 100_000, 400_000)
    ragged = [system(nr, 100 + i, np.float64) for i, nr in enumerate(ragged_sizes)]
    served_sizes = [(10_000, 40_000, 50_000, 80_000)[i % 4] for i in range(16)]
    served = [system(nr, 200 + i, np.float64) for i, nr in enumerate(served_sizes)]

    def timed(fn: Callable[[], Any], reps: int = 3) -> Tuple[Any, float]:
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            lat.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(lat)

    clear_executable_cache()
    for c in LAUNCH_COUNTERS.values():
        c.reset()
    with TridiagSession(cfg) as session:
        assert session.backend.name == "cuda", session.backend
        k = session.plan_for(big[4].size).num_chunks
        thrice("solve n=1e7 fp64", lambda: session.solve(*big[:4]), one_set(k))
        x, ms = timed(lambda: session.solve(*big[:4]))
        assert x.shape == big[4].shape and np.isfinite(x).all()
        assert_allclose_by_dtype(x, big[4], np.float64)
        # The residual through the matvec kernel, on the card.
        dl, d, du, b, xd = (torch.as_tensor(a, device=dev) for a in (*big[:4], x))
        res = float((tridiag_matvec_cuda(dl, d, du, xd) - b).abs().max())
        assert res <= 1e-10 * float(b.abs().max()), res
        del dl, d, du, b, xd
        log(f"  solve n=1e7 fp64: chunks={session.plan_for(big[4].size).num_chunks} "
            f"latency_ms={ms:.3f} max_err_vs_x_true={max_err(x, big[4]):.3e} "
            f"residual_max_abs={res:.3e}")

        k = session.plan_for(mid32[4].size).num_chunks
        thrice("solve n=1e6 fp32", lambda: session.solve(*mid32[:4]), one_set(k), profile=True)
        x, ms = timed(lambda: session.solve(*mid32[:4]))
        assert x.dtype == np.float32 and np.isfinite(x).all()
        assert_allclose_by_dtype(x, mid32[4], np.float32)
        log(f"  solve n=1e6 fp32: chunks={session.plan_for(mid32[4].size).num_chunks} "
            f"latency_ms={ms:.3f} max_err_vs_x_true={max_err(x, mid32[4]):.3e}")

        # The stacked (K, n) solve runs the batched Stage-1/Stage-3 kernels
        # once per chunk and the reduced solve as 64 systems in one launch.
        k = session.plan_for(100_000).num_chunks
        rose = one_set(k)
        x = thrice("solve stacked (64, 100000) fp64", lambda: session.solve(*batched[:4]), rose)
        assert x.shape == (64, 100_000) and np.isfinite(x).all()
        assert_allclose_by_dtype(x, batched[4], np.float64)
        _, ms = timed(lambda: session.solve(*batched[:4]))
        log(f"  solve stacked (64, 100000) fp64: chunks={k} launches={rose} "
            f"latency_ms={ms:.3f} max_err_vs_x_true={max_err(x, batched[4]):.3e}")

        k = session.plan_for((100_000,) * 64).num_chunks
        thrice("solve_batched 64x100000 fp64", lambda: session.solve_batched(*batched[:4]), one_set(k))
        x, ms = timed(lambda: session.solve_batched(*batched[:4]))
        assert x.shape == (64, 100_000) and np.isfinite(x).all()
        assert_allclose_by_dtype(x, batched[4], np.float64)
        log(f"  solve_batched 64x100000 fp64: chunks="
            f"{session.plan_for((100_000,) * 64).num_chunks} latency_ms={ms:.3f} "
            f"max_err_vs_x_true={max_err(x, batched[4]):.3e}")

        k = session.plan_for(ragged_sizes).num_chunks
        thrice(f"solve_many {ragged_sizes}", lambda: session.solve_many([s[:4] for s in ragged]),
              one_set(k))
        xs, ms = timed(lambda: session.solve_many([s[:4] for s in ragged]))
        for xi, s in zip(xs, ragged):
            assert_allclose_by_dtype(xi, s[4], np.float64)
        log(f"  solve_many {ragged_sizes}: chunks={session.plan_for(ragged_sizes).num_chunks} "
            f"latency_ms={ms:.3f} max_err_vs_x_true="
            f"{max(max_err(xi, s[4]) for xi, s in zip(xs, ragged)):.3e}")

    with TridiagSession(cfg.replace(max_batch=16, max_wait_ms=50.0)) as serving:
        s0 = executable_cache_stats()
        t0 = time.perf_counter()
        futs = [serving.submit(SolveRequest(i, *s[:4])) for i, s in enumerate(served)]
        outs = [f.result(timeout=300) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        for xi, s in zip(outs, served):
            assert_allclose_by_dtype(xi, s[4], np.float64)
        batches = serving.stats["per_batch"]
        log(f"  submit x16: batches={len(batches)} chunks={[b['num_chunks'] for b in batches]} "
            f"{hit_share(s0)} latency_ms={ms:.3f} max_err_vs_x_true="
            f"{max(max_err(xi, s[4]) for xi, s in zip(outs, served)):.3e}")

    # The chunk count must not change the answer, for one system and for
    # the stacked batch (whose chunks run the batched kernels with halos):
    # the replays at 1 and 8 (the policy's own count may be one of them,
    # which would make the first call a hit: the cache starts empty here).
    clear_executable_cache()
    for label, ops in (("n=1e7", big), ("stacked (64, 100000)", batched)):
        sols = {}
        for k in (1, 8):
            with TridiagSession(cfg.replace(policy=None, num_chunks=k)) as sk:
                sols[k] = thrice(f"solve {label} chunks={k}", lambda: sk.solve(*ops[:4]), None)
        assert np.array_equal(sols[1], sols[8]), f"solve {label}: 1 and 8 chunks differ"
        log(f"  solve {label} chunks=1 vs chunks=8, replayed: bit_identical=True")

    # The plain comparison: the same verb on the card with backend="reference",
    # at the default capacity. The plain stages are not captured (their
    # reduced solve is a Python loop of small launches): its entry is cached
    # and hit like any other but holds no graph and no device memory.
    small = system(100_000, 4, np.float64)
    clear_executable_cache()
    with TridiagSession(cfg) as kern, TridiagSession(cfg.replace(backend="reference")) as plain:
        assert plain.backend.name == "reference" and not plain.backend.capturable
        a = kern.solve(*small[:4])
        b, b_hit = plain.solve(*small[:4]), plain.solve(*small[:4])
    entries = {e.backend.name: e for e in plan_mod._EXEC_CACHE.values()}
    assert set(entries) == {"cuda", "reference"}, entries
    ref = entries["reference"]
    assert not ref.capturable and ref.graph is None and ref.nbytes == 0
    assert executable_cache_stats()["hits"] == 1 and np.array_equal(b, b_hit)
    assert_allclose_by_dtype(a, b, np.float64)
    log(f"  cuda vs reference backend on the card, n=1e5 fp64: max_abs_diff={max_err(a, b):.3e}; "
        f"the reference entry, hit once, holds no graph")

    interleaved_phase(cfg.replace(layout="auto"), timed, batched)
    staged_phase(cfg.replace(layout="auto"), big)
    functional_phase(batched)
    hammer_phase(cfg)
    budget_phase(dev)
    log(f"  executable cache after the main path: {executable_cache_stats()}")
    clear_executable_cache()

    launches = {name: LAUNCH_COUNTERS[name].count for name in MAIN_KERNELS}
    replayed = {name: LAUNCH_COUNTERS[name].replayed for name in MAIN_KERNELS}
    log(f"  launch counts on the main path (by the wrappers): {launches}; "
        f"launches replayed from CUDA graphs beside them: {replayed}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was never launched on the main path"
    REPLAYED.update(replayed)
    return launches


def hit_share(s0: Dict[str, int]) -> str:
    """The executable cache's hits and misses since ``s0``, and the hit share."""
    from repro_torch.api import executable_cache_stats

    s1 = executable_cache_stats()
    hits, misses = s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]
    return f"cache hits={hits} misses={misses} hit_share={hits / max(1, hits + misses):.3f}"


def launches_of(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """``fn()`` and how many times each kernel launched during it."""
    from repro_torch.kernels.common import launch_counts, launches_since

    before = launch_counts()
    out = fn()
    return out, launches_since(before)


WIDE_ONCE = {"partition_stage1_wide": 1, "thomas_wide": 1, "partition_stage3_wide": 1}


def one_set(k: int) -> Dict[str, int]:
    """The launches of one system-major fused call of k chunks."""
    return {"partition_stage1": k, "thomas": 1, "partition_stage3": k}


def same_bits(a: Any, b: Any) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(a, b))


def rises_of(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int], Dict[str, int]]:
    """``fn()``, how many launches of each kernel it made in all (by its
    wrappers and by graph replays), and how many of those were replayed."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    before = {name: c.replayed for name, c in LAUNCH_COUNTERS.items()}
    out, rose = launches_of(fn)
    replayed = {name: c.replayed - before[name] for name, c in LAUNCH_COUNTERS.items()
                if c.replayed != before[name]}
    return out, rose, replayed


def thrice(label: str, fn: Callable[[], Any], want: Optional[Dict[str, int]],
           profile: bool = False) -> Any:
    """``fn()`` (one fused dispatch) three times: the first call must miss
    the executable cache (it runs eagerly), the second hit it (it runs
    eagerly on the entry's static operands, then captures the CUDA graph),
    the third hit it again (a replay). Every answer must equal the first
    bit for bit; each call must raise the launch counts by exactly ``want``
    (one set), where given, the first two through the wrappers and the
    replay through the capture's tally alone. With ``profile``, the device
    kernels of a replay, from ``torch.profiler``, must be those of an
    eager call of ``fn`` (at capacity 0), name for name and count for count.
    Returns the replay's answer."""
    from repro_torch.api import executable_cache_stats, set_executable_cache_capacity

    if profile:  # first, so that the calls after thrice() find the entry
        set_executable_cache_capacity(0)
        try:
            eager_kernels = kernel_counts(f"{label} eager", fn)
        finally:
            set_executable_cache_capacity(128)
    stats = [executable_cache_stats()]
    calls = []
    for _ in range(3):
        calls.append(rises_of(fn))
        stats.append(executable_cache_stats())
    for i, (misses, hits) in enumerate(((1, 0), (0, 1), (0, 1))):
        got = (stats[i + 1]["misses"] - stats[i]["misses"], stats[i + 1]["hits"] - stats[i]["hits"])
        assert got == (misses, hits), (label, i, stats[i], stats[i + 1])
    (eager, rose_miss, rep_miss), (captured, rose_cap, rep_cap), (replay, rose_hit, rep_hit) = calls
    assert not rep_miss and not rep_cap and rep_hit == rose_hit, (label, rep_miss, rep_cap, rep_hit)
    if want is not None:
        for name, rose in (("miss", rose_miss), ("capture", rose_cap), ("replay", rose_hit)):
            assert rose == want, (label, name, rose, want)
    assert same_bits(eager, captured) and same_bits(eager, replay), f"{label}: the answers differ"
    log(f"  {label}: miss, capture, replay: launches {rose_miss}, {rose_cap} and {rose_hit} "
        f"(replayed {rep_hit}), bit_identical=True")
    if profile:
        graph_kernels = kernel_counts(f"{label} replay", fn)
        assert graph_kernels and graph_kernels == eager_kernels, (label, graph_kernels, eager_kernels)
        log(f"    profiler, {label}: a replay runs the eager call's {sum(graph_kernels.values())} "
            f"device kernels ({len(graph_kernels)} kinds): "
            + "; ".join(f"{k[:50]} x{c}" for k, c in sorted(graph_kernels.items())))
    return replay


def kernel_counts(label: str, fn: Callable[[], Any], reps: int = 2) -> Dict[str, int]:
    """The device kernels of one call of ``fn`` by name, from its trace
    (``traced``; copies and fills left out)."""
    return {k: c // reps for _, c, k in traced(label, fn, reps) if not k.startswith(("Memcpy", "Memset"))}


def interleaved_phase(cfg: Any, timed: Callable[..., Tuple[Any, float]],
                      batched: Tuple[np.ndarray, ...]) -> None:
    """The verbs that ``layout="auto"`` interleaves, at the paper's sizes."""
    from repro_torch.api import SolveRequest, TridiagSession, executable_cache_stats
    from repro_torch.core.tridiag import layout
    from repro_torch.kernels.common import assert_allclose_by_dtype

    b32 = system(100_000, 5, np.float32, batch=(64,))
    b1024 = system(10_000, 6, np.float64, batch=(1024,))
    many = [system(nr, 300 + i, np.float64) for i, nr in enumerate(RAGGED_48)]
    served_sizes = [10_000 + (10_000 * i // 63) // M * M for i in range(64)]
    served = [system(nr, 400 + i, np.float64) for i, nr in enumerate(served_sizes)]

    with TridiagSession(cfg) as session:
        for label, ops, np_dtype in (("64x100000 fp64", batched, np.float64),
                                     ("64x100000 fp32", b32, np.float32),
                                     ("1024x10000 fp64", b1024, np.float64)):
            bsz, n = ops[1].shape
            plan = session.plan_for((n,) * bsz)
            assert session._fused.resolved_layout(plan) == "interleaved", label
            rose = WIDE_ONCE
            x = thrice(f"solve_batched {label} layout=interleaved",
                       lambda: session.solve_batched(*ops[:4]), rose, profile=label == "64x100000 fp64")
            assert x.shape == (bsz, n) and x.dtype == np_dtype and np.isfinite(x).all()
            assert_allclose_by_dtype(x, ops[4], np_dtype)
            _, ms = timed(lambda: session.solve_batched(*ops[:4]))
            log(f"  solve_batched {label} layout=interleaved: launches={rose} latency_ms={ms:.3f} "
                f"max_err_vs_x_true={max_err(x, ops[4]):.3e}")

        plan = session.plan_for(RAGGED_48)
        assert session._fused.resolved_layout(plan) == "interleaved"
        xs = thrice("solve_many 48 ragged layout=interleaved",
                    lambda: session.solve_many([s[:4] for s in many]), WIDE_ONCE)
        # The graph reads the gather maps by address: with the layout's LRU
        # emptied and the allocator's free blocks given back, a replay must
        # still give the same bits, because the entry holds the maps.
        layout._device_maps.cache_clear()
        torch.cuda.empty_cache()
        xs_again, rose, replayed = rises_of(lambda: session.solve_many([s[:4] for s in many]))
        assert same_bits(xs, xs_again) and rose == replayed == WIDE_ONCE, (rose, replayed)
        log("  solve_many 48 ragged layout=interleaved: replayed after the gather maps' LRU "
            "was emptied, bit_identical=True")
        for xi, s in zip(xs, many):
            assert np.isfinite(xi).all()
            assert_allclose_by_dtype(xi, s[4], np.float64)
        _, ms = timed(lambda: session.solve_many([s[:4] for s in many]))
        log(f"  solve_many 48 ragged 60000..100000 layout=interleaved: latency_ms={ms:.3f} "
            f"max_err_vs_x_true={max(max_err(xi, s[4]) for xi, s in zip(xs, many)):.3e}")

        # The interleaved answer against the system-major one, same operands.
        x_il = session.solve_batched(*batched[:4])
    with TridiagSession(cfg.replace(layout="system-major")) as sm:
        x_sm = sm.solve_batched(*batched[:4])
    assert_allclose_by_dtype(x_il, x_sm, np.float64)
    log(f"  solve_batched 64x100000 fp64 interleaved vs system-major: max_abs_diff={max_err(x_il, x_sm):.3e}")

    # 64 served requests of 10,000 ... 20,000 rows, taken as one ragged batch.
    with TridiagSession(cfg.replace(max_batch=64, max_wait_ms=5000.0)) as serving:
        s0 = executable_cache_stats()
        t0 = time.perf_counter()
        futs = [serving.submit(SolveRequest(i, *s[:4])) for i, s in enumerate(served)]
        outs = [f.result(timeout=300) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        for xi, s in zip(outs, served):
            assert np.isfinite(xi).all()
            assert_allclose_by_dtype(xi, s[4], np.float64)
        batches = serving.stats["per_batch"]
        assert [(b["systems"], b["layout"]) for b in batches] == [(64, "interleaved")], batches
        log(f"  submit x64 10000..20000: batches={len(batches)} layout={batches[0]['layout']} "
            f"{hit_share(s0)} latency_ms={ms:.3f} max_err_vs_x_true="
            f"{max(max_err(xi, s[4]) for xi, s in zip(outs, served)):.3e}")


def staged_phase(cfg: Any, big: Tuple[np.ndarray, ...]) -> None:
    """The staged executor: one CUDA stream per chunk, host fp64 Stage 2."""
    from repro_torch.api import TridiagSession
    from repro_torch.kernels.common import assert_allclose_by_dtype

    with TridiagSession(cfg) as session:
        k = session.plan_for(big[4].size).num_chunks
        fused_x = session.solve(*big[:4])
        runs = []
        for _ in range(2):
            (x, t), rose = launches_of(lambda: session.solve_timed(*big[:4]))
            assert rose == {"partition_stage1": k, "partition_stage3": k}, (rose, k)
            assert t.num_chunks == k and np.isfinite(x).all()
            assert_allclose_by_dtype(x, big[4], np.float64)
            runs.append((x, t))
            log(f"  solve_timed n=1e7 fp64 staged, {k} chunks on {k} streams: "
                f"stage1_ms={t.t_stage1_ms:.3f} stage2_host_ms={t.t_stage2_ms:.3f} "
                f"stage3_ms={t.t_stage3_ms:.3f} total_ms={t.t_total_ms:.3f} "
                f"max_err_vs_x_true={max_err(x, big[4]):.3e}")
        assert np.array_equal(runs[0][0], runs[1][0]), "repeated staged solves differ"
        assert_allclose_by_dtype(runs[0][0], fused_x, np.float64)
        log(f"  staged twice: bit_identical=True; staged vs fused max_abs_diff="
            f"{max_err(runs[0][0], fused_x):.3e}")

    batched = system(100_000, 7, np.float64, batch=(64,))
    with TridiagSession(cfg.replace(layout="interleaved")) as session:
        for _ in range(2):
            (x, t), rose = launches_of(lambda: session.solve_batched_timed(*batched[:4]))
            assert rose == {"partition_stage1_wide": 1, "partition_stage3_wide": 1}, rose
            assert_allclose_by_dtype(x, batched[4], np.float64)
            log(f"  solve_batched_timed 64x100000 fp64 staged interleaved: "
                f"stage1_ms={t.t_stage1_ms:.3f} stage2_host_ms={t.t_stage2_ms:.3f} "
                f"stage3_ms={t.t_stage3_ms:.3f} total_ms={t.t_total_ms:.3f} "
                f"max_err_vs_x_true={max_err(x, batched[4]):.3e}")


def functional_phase(batched: Tuple[np.ndarray, ...]) -> None:
    """The functional batched solvers on the card: one launch of each stage."""
    from repro_torch.core.tridiag.batched import solve_batched, thomas_batched
    from repro_torch.kernels.common import assert_allclose_by_dtype

    for label, fn, want in (
        ("solve_batched", lambda ops: solve_batched(*ops, m=M),
         {"partition_stage1": 1, "thomas": 1, "partition_stage3": 1}),
        ("thomas_batched", lambda ops: thomas_batched(*ops), {"thomas": 1}),
    ):
        x, rose = launches_of(lambda: fn(batched[:4]))
        assert rose == want, (label, rose)
        assert x.device.type == "cuda" and x.shape == (64, 100_000) and x.dtype == torch.float64
        assert bool(torch.isfinite(x).all())
        assert_allclose_by_dtype(x, batched[4], np.float64)
        ops = [torch.as_tensor(a, device="cuda") for a in batched[:4]]
        ms = cuda_ms(lambda: fn(ops), reps=5)
        log(f"  {label} 64x100000 fp64 (functional): launches={rose} device_operands_ms={ms:.4f} "
            f"max_err_vs_x_true={max_err(x, batched[4]):.3e}")


def hammer_phase(cfg: Any) -> None:
    """Two threads, a session each, one executable LRU of capacity 2 on the
    card: thread 0 solves n = 100,000 and 200,000, thread 1 200,000 and
    300,000, ten rounds each, so an entry is shared by both threads, and
    entries are evicted and captured again while the other thread replays.
    A third thread runs the staged path meanwhile (``solve_timed``, one
    pooled CUDA stream a chunk), which must not reach into a capture.
    Every answer is checked against x_true, every join is bounded, and the
    launch counters must rise by exactly one set a call."""
    import threading

    from repro_torch.api import (
        TridiagSession,
        clear_executable_cache,
        executable_cache_stats,
        set_executable_cache_capacity,
    )
    from repro_torch.kernels.common import assert_allclose_by_dtype, launch_counts, launches_since

    k, staged_k, rounds = 4, 8, 10
    sizes = ((100_000, 200_000), (200_000, 300_000))
    problems = {n: system(n, 500 + n // 100_000, np.float64) for n in (100_000, 200_000, 300_000)}
    errors: List[Any] = []

    def worker(tid: int) -> None:
        try:
            if tid == 2:
                with TridiagSession(cfg.replace(policy=None, num_chunks=staged_k)) as session:
                    for _ in range(rounds):
                        x, _ = session.solve_timed(*problems[200_000][:4])
                        assert_allclose_by_dtype(x, problems[200_000][4], np.float64)
                return
            with TridiagSession(cfg.replace(policy=None, num_chunks=k)) as session:
                for _ in range(rounds):
                    for n in sizes[tid]:
                        x = session.solve(*problems[n][:4])
                        assert_allclose_by_dtype(x, problems[n][4], np.float64)
        except Exception as e:  # reported below, on the main thread
            errors.append((tid, repr(e)))

    clear_executable_cache()
    set_executable_cache_capacity(2)
    try:
        before = launch_counts()
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive(), "hammer thread did not finish"
        rose = launches_since(before)
        stats = executable_cache_stats()
    finally:
        set_executable_cache_capacity(128)
        clear_executable_cache()
    assert not errors, errors
    calls, staged = 2 * rounds * 2, rounds * staged_k
    assert stats["hits"] + stats["misses"] == calls and stats["size"] <= 2, stats
    assert rose == {"partition_stage1": calls * k + staged, "thomas": calls,
                    "partition_stage3": calls * k + staged}, rose
    log(f"  hammer, 2 threads x {rounds * 2} fused solves at capacity 2 beside {rounds} staged "
        f"solve_timed: answers on x_true, cache {stats}, launches {rose} (one set a call)")


def budget_phase(dev: torch.device, signatures: int = 110, n_max: int = 10_000_000) -> None:
    """More CUDA graphs than the card could hold, under the default cache
    capacity: ``signatures`` n ~ 1e7 fp64 systems of distinct row counts
    (so distinct plans), each solved twice on the device (a miss, then the
    hit that captures), about 0.8 GB an entry. The graphs captured hold
    more bytes in all than the card has; the byte budget must keep what the
    cache holds within its share (evicting), and every answer must be on
    x_true."""
    from repro_torch.api import FusedExecutor, clear_executable_cache, executable_cache_stats
    from repro_torch.core.tridiag import plan as plan_mod

    ex = FusedExecutor("cuda", device=dev, layout="system-major")
    gen = torch.Generator(device=dev).manual_seed(7)
    x_true = torch.randn(n_max, generator=gen, device=dev, dtype=torch.float64)
    dl, du = (torch.rand(n_max, generator=gen, device=dev, dtype=torch.float64) - 0.5 for _ in range(2))
    d = 4.0 + torch.rand(n_max, generator=gen, device=dev, dtype=torch.float64)
    x_host = x_true.cpu().numpy()
    budget = plan_mod._byte_budget(dev)
    card = torch.cuda.get_device_properties(dev).total_memory
    clear_executable_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    captured, worst, peak_bytes = 0, 0.0, 0
    t0 = time.perf_counter()
    for i in range(signatures):
        n = n_max - M * i
        b = d[:n] * x_true[:n]
        b[1:] += dl[1:n] * x_true[: n - 1]
        b[:-1] += du[: n - 1] * x_true[1:n]
        ops = (dl[:n], d[:n], du[:n], b)
        plan = plan_mod.build_plan(n, M, num_chunks=32)
        for _ in range(2):
            x, _ = ex.execute(plan, *ops)
            worst = max(worst, float(np.abs(x - x_host[:n]).max()))
        entry = plan_mod._EXEC_CACHE.get(ex._key(plan, [torch.as_tensor(a) for a in ops]))
        assert entry is not None and entry.graph is not None, i
        captured += entry.nbytes
        stats = executable_cache_stats()
        assert stats["bytes"] <= budget, (i, stats, budget)
        peak_bytes = max(peak_bytes, stats["bytes"])
    stats = executable_cache_stats()
    secs = time.perf_counter() - t0
    assert captured > card and stats["evictions"] > 0, (captured, card, stats)
    assert worst <= 1e-12, worst
    log(f"  byte budget: {signatures} distinct n~1e7 fp64 graphs captured, {captured} B in all "
        f"against a card of {card} B; the cache held at most {peak_bytes} B (budget {budget} B, "
        f"{plan_mod._EXEC_CACHE_MEMORY_SHARE} of the card), {stats}; max_memory_reserved "
        f"{torch.cuda.max_memory_reserved(dev)} B; max_err_vs_x_true={worst:.3e}; {secs:.1f} s")
    clear_executable_cache()


# ---------------------------------------------------------------- breakdown --
def breakdown_phase(dev: torch.device) -> None:
    from repro_torch.api import HeuristicChunkPolicy
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator
    from repro_torch.core.tridiag.plan import CudaBackend, _fused, build_plan
    from repro_torch.kernels.partition_stage1.ops import (
        partition_stage1_cuda,
        span_blocks,
        wide_tile_blocks,
    )
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda
    from repro_torch.kernels.thomas.ops import thomas_cuda

    n = 10_000_000
    host = system(n, 1, np.float64)[:4]
    policy = HeuristicChunkPolicy(fit_stream_heuristic(StreamSimulator(seed=1).dataset(reps=2)))
    plan = build_plan(n, M, policy=policy)
    ops = [torch.as_tensor(a, device=dev) for a in host]
    h2d = host_ms(lambda: [torch.as_tensor(a, device=dev) for a in host])
    c = partition_stage1_cuda(*ops, m=M)
    s1 = cuda_ms(lambda: partition_stage1_cuda(*ops, m=M), reps=5)
    red = (c.red_dl, c.red_d, c.red_du, c.red_b)
    s2 = cuda_ms(lambda: thomas_cuda(*red), reps=3, warmup=1)
    s = thomas_cuda(*red)
    s3 = cuda_ms(lambda: partition_stage3_cuda(c, s), reps=5)
    x = partition_stage3_cuda(c, s)
    d2h = host_ms(lambda: x.cpu())
    fused = cuda_ms(lambda: _fused(plan, CudaBackend(), *ops), reps=3, warmup=1)
    total = h2d + fused + d2h
    log(f"  n=1e7 fp64, chunks={plan.num_chunks}: h2d_ms={h2d:.3f} stage1_ms={s1:.3f} "
        f"reduced_solve_ms={s2:.3f} stage3_ms={s3:.3f} d2h_ms={d2h:.3f} "
        f"fused_device_ms={fused:.3f} (h2d+fused+d2h={total:.3f}); "
        f"reduced solve share of fused={s2 / fused:.3f}")
    log(f"    host enqueue: fused_enqueue_ms="
        f"{enqueue_ms(lambda: _fused(plan, CudaBackend(), *ops)):.3f} "
        f"reduced_solve_enqueue_ms={enqueue_ms(lambda: thomas_cuda(*red)):.3f}")
    device_profile("fused path n=1e7", lambda: _fused(plan, CudaBackend(), *ops), fused)
    device_profile("reduced solve B=1, n=1e6", lambda: thomas_cuda(*red), s2)
    del c, red, s, x
    # Stage 1 sets its shared-memory attribute at every launch above 48 KB;
    # these launches run inside the captures below.
    smem = {"partition_stage1 m=32 fp64 (the reduced solve's levels)":
            4 * span_blocks(32, torch.float64) * (32 | 1) * 8,
            "partition_stage1_wide m=10 fp64": 4 * wide_tile_blocks(M) * M * 128}
    assert all(nbytes > 48 * 1024 for nbytes in smem.values()), smem
    log(f"    captured launches that call cudaFuncSetAttribute (dynamic shared memory, B): {smem}")
    replay_breakdown(dev, "fused path n=1e7", plan, "system-major", ops,
                     lambda: _fused(plan, CudaBackend(), *ops))
    del host, ops
    interleaved_breakdown(dev)


def replay_breakdown(dev: torch.device, label: str, plan: Any, layout: str, ops: List[torch.Tensor],
                     eager: Callable[[], Any]) -> None:
    """The fused path as a CUDA graph replay beside its eager call: CUDA
    events (in turn), the host's enqueue time, device time behind a sleep
    and the profiler's busy time. First, the device memory one cache entry
    holds: ``memory_reserved`` before the miss, after the hit that
    captures and after ``clear_executable_cache()`` (each after
    ``empty_cache``, nothing else run between), which must give back at
    least 95 % of what the capture took; the bytes the entry was charged
    must be at least 95 % of that too."""
    from repro_torch.api import FusedExecutor, clear_executable_cache
    from repro_torch.core.tridiag import plan as plan_mod

    ex = FusedExecutor("cuda", device=dev, layout=layout)
    clear_executable_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    ex.execute(plan, *ops)  # the miss: eager
    ex.execute(plan, *ops)  # the first hit: eager on the static operands, then the capture
    torch.cuda.empty_cache()
    captured = torch.cuda.memory_reserved(dev)
    charged = plan_mod._EXEC_CACHE[ex._key(plan, ops)].nbytes
    clear_executable_cache()
    torch.cuda.empty_cache()
    cleared = torch.cuda.memory_reserved(dev)
    static = 4 * ops[1].numel() * ops[1].element_size()
    log(f"    {label}, memory_reserved: before capture {before} B, after {captured} B (the "
        f"entry holds {captured - before} B: static operands {static} B, graph pool and "
        f"solution {captured - before - static} B; charged to the cache {charged} B), "
        f"after clear {cleared} B")
    assert captured - cleared >= 0.95 * (captured - before), (before, captured, cleared)
    assert charged >= 0.95 * (captured - before), (charged, before, captured)

    ex.execute(plan, *ops)
    ex.execute(plan, *ops)
    graph = plan_mod._EXEC_CACHE[ex._key(plan, ops)].graph
    assert graph is not None
    eager_ms, replay_ms = alternating_ms([eager, graph.replay], reps=10)
    eager_dev, replay_dev = device_ms(eager, reps=5), device_ms(graph.replay, reps=5)
    log(f"  {label} as a replay: events eager_ms={eager_ms:.4f} replay_ms={replay_ms:.4f}; "
        f"enqueue eager_ms={enqueue_ms(eager):.4f} replay_ms={enqueue_ms(graph.replay):.4f}; "
        f"device eager_ms={eager_dev:.4f} replay_ms={replay_dev:.4f}")
    device_profile(f"{label} as a replay", graph.replay, replay_ms)
    # The same call from host operands, as a verb makes it: the pageable
    # copies in and out around the entry's eager stages, and around a
    # replay; host clock, in turn.
    entry = plan_mod._EXEC_CACHE[ex._key(plan, ops)]
    host = [torch.from_numpy(a.cpu().numpy()) for a in ops]
    verb_ms: Dict[str, List[float]] = {"eager": [], "replay": []}
    for _ in range(5):
        for kind, fn in (("eager", lambda: entry.eager(host)), ("replay", lambda: entry(host))):
            verb_ms[kind].append(host_ms(fn, reps=1))
    log(f"  {label} from host operands (copies in and out): eager_ms="
        f"{statistics.median(verb_ms['eager']):.3f} replay_ms={statistics.median(verb_ms['replay']):.3f} "
        f"(medians of 5, in turn)")
    del graph, entry
    clear_executable_cache()


def interleaved_breakdown(dev: torch.device) -> None:
    """One interleaved solve_batched of 1024 x 10,000 fp64, part by part."""
    from repro_torch.core.tridiag import layout
    from repro_torch.core.tridiag.batched import fuse_systems
    from repro_torch.core.tridiag.plan import CudaBackend, _fused_interleaved, build_plan
    from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_wide
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_wide
    from repro_torch.kernels.thomas.ops import thomas_cuda_wide

    bsz, n = 1024, 10_000
    sizes = (n,) * bsz
    host = system(n, 6, np.float64, batch=(bsz,))[:4]
    plan = build_plan(sizes, M)
    h2d = host_ms(lambda: [torch.as_tensor(a, device=dev) for a in host])
    ops = [torch.as_tensor(a, device=dev) for a in host]
    fuse = cuda_ms(lambda: fuse_systems(*ops), reps=5)
    fused = fuse_systems(*ops)
    gather = cuda_ms(lambda: layout.interleave_operands(*fused, sizes, M), reps=5)
    wide = layout.interleave_operands(*fused, sizes, M)
    s1 = cuda_ms(lambda: partition_stage1_cuda_wide(*wide, m=M), reps=5)
    c = partition_stage1_cuda_wide(*wide, m=M)
    red = (c.red_dl, c.red_d, c.red_du, c.red_b)
    s2 = cuda_ms(lambda: thomas_cuda_wide(*red), reps=5)
    s = thomas_cuda_wide(*red)
    # One level (1,000 > N0 rows): Stage 1 on the caller's rows, the base and
    # Stage 3, and no copy of the caller's rows.
    entries = device_profile("wide reduced solve P=1000, B=1024", lambda: thomas_cuda_wide(*red), s2)
    launched = sum(c for _, c, _ in entries)
    assert launched == 3, f"thomas_cuda_wide at P=1000, B=1024 ran {launched} device entries: {entries}"
    log(f"    thomas_cuda_wide at P=1000, B=1024: {launched} device kernels a call "
        f"({', '.join(k[:40] for _, _, k in entries)})")
    s3 = cuda_ms(lambda: partition_stage3_cuda_wide(c, s), reps=5)
    xw = partition_stage3_cuda_wide(c, s)
    scatter = cuda_ms(lambda: layout.deinterleave(xw, sizes, M), reps=5)
    x = layout.deinterleave(xw, sizes, M)
    d2h = host_ms(lambda: x.cpu())
    device = cuda_ms(lambda: _fused_interleaved(plan, CudaBackend(), *fused), reps=5)
    device_profile("interleaved device path 1024x10000", lambda: _fused_interleaved(plan, CudaBackend(), *fused),
                   device)
    replay_breakdown(dev, "interleaved device path 1024x10000", plan, "interleaved", list(fused),
                     lambda: _fused_interleaved(plan, CudaBackend(), *fused))
    log(f"  solve_batched 1024x10000 fp64 interleaved: h2d_ms={h2d:.3f} fuse_ms={fuse:.3f} "
        f"interleave_ms={gather:.3f} stage1_wide_ms={s1:.3f} thomas_wide_ms={s2:.3f} "
        f"stage3_wide_ms={s3:.3f} deinterleave_ms={scatter:.3f} d2h_ms={d2h:.3f} "
        f"interleaved_device_ms={device:.3f} (h2d+fuse+device+d2h={h2d + fuse + device + d2h:.3f}); "
        f"wide Thomas share of device={s2 / device:.3f}")


# --------------------------------------------------------------- closed loop --
# The campaign takes the paper's sizes up to this one: past it the staged
# path's host reduced solve (a Python loop, ~10 us a row) makes one size
# cost minutes over its 24 solves.
CAMPAIGN_MAX = 1_000_000
CLOSED_LOOP_KERNELS = MAIN_KERNELS[:6]


def closed_loop_phase(dev: torch.device, campaign_sizes: Optional[Tuple[int, ...]] = None,
                      batched_sizes: Tuple[int, ...] = (10_000, 100_000),
                      batches: Tuple[int, ...] = (1, 4, 16),
                      mix: Tuple[int, ...] = (10_000, 40_000, 100_000, 400_000),
                      served_sizes: Tuple[int, ...] = (25_000, 100_000, 1_000_000, 2_500_000),
                      wide: Tuple[int, int] = (32, 10_000), shed_size: int = 4_000_000) -> Dict[str, int]:
    """The closed loop on the card at fp64, m = 10, ``backend="cuda"``:
    (a) the staged campaigns over the chunk candidates and the Eq. 4-7
    refit on their rows; (b) fused traffic served at fixed chunk counts,
    its telemetry fed to one ``autotune="live"`` session whose worker
    refits and swaps the chunk policy on its own; (c) predicted-latency
    admission with the refit latency model: one request shed with no
    launch, then deadline-free batches and their residuals. The keyword
    arguments are the sizes (the defaults are the card's). The served
    batches have effective sizes on both sides of the Eq. 7 regime split
    (1e6), two on each: each regime's 5-parameter fit needs at least 5
    training rows, and with one size a regime every refit raises. Returns
    the launches of the path's kernels over the phase."""
    from repro_torch.api import (
        HeuristicChunkPolicy,
        OnlineRefitter,
        PredictedTimeoutError,
        SolveRequest,
        SolverConfig,
        TridiagSession,
        clear_executable_cache,
    )
    from repro_torch.core.autotune import fit_batched_stream_heuristic, fit_stream_heuristic
    from repro_torch.core.streams import PAPER_SIZES, STREAM_CANDIDATES, StreamDataset, StreamSimulator
    from repro_torch.core.streams.measure import (
        measure_batched_dataset,
        measure_dataset,
        measure_ragged_dataset,
    )
    from repro_torch.core.tridiag.plan import price_chunks
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.common import assert_allclose_by_dtype, launch_counts, launches_since

    on_card = dev.type == "cuda"
    if campaign_sizes is None:
        campaign_sizes = tuple(n for n in PAPER_SIZES if n <= CAMPAIGN_MAX)
    for c in LAUNCH_COUNTERS.values():
        c.reset()
    clear_executable_cache()
    seconds: Dict[str, float] = {}

    # ---- (a) the campaign: the paper's experiment on this card.
    t0 = time.perf_counter()
    kw = dict(m=M, backend="cuda", device=dev)
    single = measure_dataset(campaign_sizes, STREAM_CANDIDATES, reps=3, **kw)
    seconds["(a) single"] = time.perf_counter() - t0
    batched = measure_batched_dataset(batched_sizes, batches, STREAM_CANDIDATES, reps=2, **kw)
    seconds["(a) batched"] = time.perf_counter() - t0 - seconds["(a) single"]
    ragged = measure_ragged_dataset([mix], STREAM_CANDIDATES, reps=3, **kw)
    rows = single.rows + batched.rows + ragged.rows
    for r in rows:
        for key in ("sum", "t_str", "t_non_str", "t_overhead"):
            assert np.isfinite(r[key]), r
    shipped = fit_stream_heuristic(StreamSimulator(seed=1).dataset(reps=2))
    campaign_fit = fit_batched_stream_heuristic(StreamDataset(rows))
    assert campaign_fit is not None and campaign_fit.base.sum_model is not None
    log("  (a) campaign: staged solves (one CUDA stream per chunk, reduced solve on the host), "
        "t_str in ms, median of the reps; k=1 is t_non_str, the best of the baseline reps; "
        "opt: the k of the lowest best-of-reps time")
    for label, data in (("single", single), ("batched", batched), ("ragged", ragged)):
        cells: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
        for r in data.rows:
            cells.setdefault((r["size"], r.get("batch", 1)), []).append(r)
        for (n, b), cell in sorted(cells.items()):
            t_non = cell[0]["t_non_str"]
            med = {1: t_non}
            best = {1: t_non}
            for k in STREAM_CANDIDATES[1:]:
                ts = [r["t_str"] for r in cell if r["num_str"] == k]
                med[k], best[k] = statistics.median(ts), min(ts)
            opt = min(best, key=best.get)
            sizes = mix if label == "ragged" else (n,) * b
            picks = (price_chunks(shipped, sizes), price_chunks(campaign_fit, sizes))
            assert opt in STREAM_CANDIDATES and all(p in STREAM_CANDIDATES for p in picks), (n, b, opt, picks)
            log(f"    {label} n={n} batch={b}: t_str " + " ".join(f"k{k}={v:.3f}" for k, v in med.items())
                + f"; opt={opt} overlappable={cell[0]['sum'] / t_non:.3f} "
                f"shipped_pick={picks[0]} refit_pick={picks[1]}")
    seconds["(a) campaign"] = time.perf_counter() - t0
    popt = {name: None if p is None else [float(f"{v:.4g}") for v in p]
            for name, p in (("small", campaign_fit.base.popt_small), ("big", campaign_fit.base.popt_big))}
    log(f"  (a) campaign fit on {len(rows)} rows: Eq. 4 sum = "
        f"{campaign_fit.base.sum_model.coef[0]:.4e}*n + {campaign_fit.base.sum_model.intercept:.4e} ms; "
        f"Eq. 7 popt {popt}")

    # ---- (b) the closed loop, live: fixed chunk counts feed one live session.
    t1 = time.perf_counter()
    base = SolverConfig(m=M, device=dev, backend="cuda", max_batch=4, max_predicted_ms=1e6)
    traffic = {n: [system(n, 300 + i, np.float64) for i in range(4)] for n in served_sizes}

    def serve(session: Any, sizes: Tuple[int, ...], rid0: int = 0) -> None:
        futs = [session.submit(SolveRequest(rid0 + i, *traffic[n][i % 4][:4]))
                for i, n in enumerate(sizes)]
        for i, (f, n) in enumerate(zip(futs, sizes)):
            assert_allclose_by_dtype(f.result(timeout=300), traffic[n][i % 4][4], np.float64)

    observations = []
    for n in served_sizes:
        lat = {}
        for k in STREAM_CANDIDATES:
            with TridiagSession(base.replace(num_chunks=k)) as s:
                for rep in range(3):
                    serve(s, (n,) * 4, 4 * rep)
                obs = s.telemetry.snapshot()
            assert [(o.sizes, o.num_chunks, o.dispatch) for o in obs] == [((n,) * 4, k, "fused")] * 3, obs
            lat[k] = [o.latency_ms for o in obs]
            observations.extend(obs)
        log(f"  (b) 4 x {n} fused, latency_ms by k as (miss, capture, replay): "
            + " ".join(f"k{k}=({a:.3f}, {b:.3f}, {c:.3f})" for k, (a, b, c) in lat.items()))
    live_cfg = base.replace(autotune="live", refit_min_samples=len(observations), refit_interval_s=0.0,
                            max_predicted_ms=None)
    served = tuple(n for n in served_sizes for _ in range(4))
    with TridiagSession(live_cfg) as live:
        for o in observations:
            live.telemetry.record(o)
        before = [(n,) * 4 for n in served_sizes]
        assert all(live.plan_for(s).num_chunks == 1 for s in before)
        serve(live, served)  # the worker's first refit runs before its first dispatch
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            tune = live.stats["autotune"]
            if tune["refits"] >= 1 or tune["refit_errors"]:
                break
            time.sleep(0.01)
    stats = live.stats
    refitter = live._refitter
    assert stats["autotune"]["refits"] >= 1 and not stats["autotune"]["refit_errors"], stats["autotune"]
    final = refitter.last_heuristic()
    model = refitter.last_latency_model()
    assert final is not None and model is not None
    # The worker refits before every dispatch (interval 0), so batch j was
    # priced by the refit of the window it saw: the fixed-k observations
    # and the live batches before it. The refit is a pure function of them.
    window = list(observations)
    for j, pb in enumerate(stats["per_batch"]):
        h = OnlineRefitter("live", min_samples=1).refit_from(window).heuristic
        assert pb["num_chunks"] == price_chunks(h, pb["sizes"]), (j, pb["num_chunks"])
        window.append(live.telemetry.snapshot()[len(observations) + j])
    for sizes in before:
        assert live.plan_for(sizes).num_chunks == price_chunks(final, sizes), sizes
    picks = {sizes[0]: price_chunks(final, sizes) for sizes in before}
    first = OnlineRefitter("live", min_samples=1).refit_from(observations).heuristic
    log(f"  (b) live refit: {stats['autotune']['refits']} refits (worker, interval 0), "
        f"per-batch chunks {[pb['num_chunks'] for pb in stats['per_batch']]}, "
        f"picks by size of 4-system batches: first refit "
        f"{ {s[0]: price_chunks(first, s) for s in before} }, last {picks}; shipped "
        f"{ {s[0]: price_chunks(shipped, s) for s in before} }; campaign fit "
        f"{ {s[0]: price_chunks(campaign_fit, s) for s in before} }; agreement_rate="
        f"{stats['autotune']['agreement_rate']}")
    log(f"  (b) LatencyModel (ms = c0 + c1*N + c2*N/k) coef={model.coef} samples={model.samples}")
    seconds["(b) live"] = time.perf_counter() - t1

    # ---- (c) predicted admission with the refit latency model.
    t2 = time.perf_counter()
    adm_cfg = base.replace(num_chunks=None, policy=HeuristicChunkPolicy(final), max_batch=wide[0],
                           max_wait_ms=50.0, max_predicted_ms=1e4)
    doomed = system(shed_size, 400, np.float64)
    with TridiagSession(adm_cfg) as adm:
        adm._engine.set_latency_model(model)
        pred = adm._engine.predicted_batch_ms((shed_size,))
        assert pred is not None and pred > 0, pred
        counts = launch_counts()
        fut = adm.submit(SolveRequest(10_000, *doomed[:4], timeout_ms=0.9 * pred))
        err = fut.exception(timeout=60)
        assert isinstance(err, PredictedTimeoutError), err
        assert not launches_since(counts), launches_since(counts)
        assert adm.stats["shed_predicted"] == 1 and adm.stats["batches"] == 0, adm.stats
        log(f"  (c) shed: one {shed_size}-row request, predicted {pred:.3f} ms, timeout_ms="
            f"{0.9 * pred:.3f}: PredictedTimeoutError, no launch, shed_predicted=1")
        for rep in range(3):
            for n in served_sizes:
                serve(adm, (n,) * 4, 100 * rep)
        wide_sys = [system(wide[1], 500 + i, np.float64) for i in range(wide[0])]
        for rep in range(3):  # a miss, a capture, a replay
            futs = [adm.submit(SolveRequest(20_000 + i, *s[:4])) for i, s in enumerate(wide_sys)]
            for f, s in zip(futs, wide_sys):
                assert_allclose_by_dtype(f.result(timeout=300), s[4], np.float64)
        obs = adm.telemetry.snapshot()
        per_batch = adm.stats["per_batch"]
    assert all(pb["layout"] == "interleaved" and pb["systems"] == wide[0] for pb in per_batch[-3:]), per_batch
    groups: Dict[Tuple[int, ...], List[Any]] = {}
    for o in obs:
        groups.setdefault(o.sizes, []).append(o)
    for sizes, group in sorted(groups.items()):
        log(f"  (c) deadline-free {len(sizes)} x {sizes[0]} ({group[0].layout}, chunks="
            f"{group[0].num_chunks}): latency_ms {[round(o.latency_ms, 3) for o in group]}, "
            f"predicted_ms={group[0].predicted_ms:.3f}, median residual_ms="
            f"{statistics.median(o.residual_ms for o in group):.3f}")
    seconds["(c) admission"] = time.perf_counter() - t2

    launches = {name: LAUNCH_COUNTERS[name].count for name in CLOSED_LOOP_KERNELS}
    log(f"  launch counts on the closed-loop path (by the wrappers): {launches}; replayed: "
        f"{ {name: LAUNCH_COUNTERS[name].replayed for name in CLOSED_LOOP_KERNELS} }")
    if on_card:
        for name, count in launches.items():
            assert count > 0, f"kernel {name} was never launched on the closed-loop path"
    clear_executable_cache()
    log("  closed_loop seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return launches


# ----------------------------------------------------------------------- lm --
MESH_SHARDS = 4
MESH_KERNELS = MAIN_KERNELS[:6]


def flat(x: Any) -> np.ndarray:
    """A verb's answer as one fused vector: a list of systems concatenated,
    a (B, n) batch flattened."""
    return np.concatenate(x) if isinstance(x, list) else np.asarray(x).reshape(-1)


def alternating_host_ms(fns: List[Callable[[], Any]], reps: int) -> List[float]:
    """Median host-clock time (``host_ms``) of each of ``fns``, called in
    turn rep after rep, after one call of each."""
    for fn in fns:
        fn()
    times: List[List[float]] = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            ts.append(host_ms(fn, reps=1))
    return [statistics.median(ts) for ts in times]


def mesh_case(dev: torch.device, label: str, sharded: Any, unsharded: Any,
              verb: Callable[[Any], Any], sizes: Tuple[int, ...], fused: List[np.ndarray],
              x_true: np.ndarray, np_dtype: Any, reps: int = 3) -> Dict[str, Any]:
    """One case of the mesh phase: the sharded session's ``verb`` must
    raise the launch counts by one sharded set (Stage 1 and Stage 3 once a
    chunk and the reduced solve once a shard, or the three wide stages once
    a lane shard) and meet the fp64 oracle at the ladder; the sharded
    executor on the fused operands (on the card) must give the verb's bits,
    and the unsharded executor on the same plan the same bits
    (system-major) or an answer within the ladder (interleaved, the bits
    printed). Then the device path alone (the stages on the card's
    operands, no copy to the host), sharded and unsharded: CUDA events in
    turn and the card's time (``device_ms``); the host clock around the
    sharded and the unsharded session's verb in turn (the unsharded one on
    its own plan), both eager (the cache at capacity 0); and events around
    the sharded executor against the unsharded one's CUDA graph replay."""
    from functools import partial

    from repro_torch.api import FusedExecutor, set_executable_cache_capacity
    from repro_torch.core.tridiag import plan as plan_mod
    from repro_torch.kernels.common import assert_allclose_by_dtype

    plan = sharded.plan_for(sizes)
    layout = sharded._fused.resolved_layout(plan)
    devices = sharded._fused.shard_devices(plan, layout)
    shards = 1 if devices is None else len(devices)
    if layout == "interleaved":
        want = {"partition_stage1_wide": shards, "thomas_wide": shards, "partition_stage3_wide": shards}
    else:
        want = {"partition_stage1": plan.num_chunks, "thomas": shards, "partition_stage3": plan.num_chunks}
    x, rose = launches_of(lambda: verb(sharded))
    assert rose == want, (label, rose, want)
    x = flat(x)
    assert x.shape == x_true.shape and x.dtype == np_dtype and np.isfinite(x).all(), label
    assert_allclose_by_dtype(x, x_true, np_dtype)

    ops = [torch.as_tensor(a, device=dev) for a in fused]
    single = FusedExecutor("cuda", device=dev, layout=layout)

    def run_sharded() -> np.ndarray:
        return sharded._fused.execute(plan, *ops)[0]

    def run_single() -> np.ndarray:
        return single.execute(plan, *ops)[0]

    xs, x0 = run_sharded(), run_single()
    assert np.array_equal(xs, x), f"{label}: the sharded verb and executor differ"
    bits = bool(np.array_equal(xs, x0))
    if layout == "system-major":
        assert bits, f"{label}: sharded and unsharded differ on the same plan"
    else:
        assert_allclose_by_dtype(xs, x0, np_dtype)
    backend = sharded._fused.backend
    if layout == "interleaved":
        path_s = partial(plan_mod._fused_interleaved, plan, backend, *ops, devices=devices)
        path_0 = partial(plan_mod._fused_interleaved, plan, backend, *ops)
    elif devices is not None:
        path_s = partial(plan_mod._fused_sharded, plan, backend, devices, *ops)
        path_0 = partial(plan_mod._fused, plan, backend, *ops)
    else:
        path_s = path_0 = partial(plan_mod._fused, plan, backend, *ops)
    ev_s, ev_0 = alternating_ms([path_s, path_0], reps)
    dev_s, dev_0 = device_ms(path_s, reps=5), device_ms(path_0, reps=5)
    set_executable_cache_capacity(0)
    try:
        host_s, host_0 = alternating_host_ms([lambda: verb(sharded), lambda: verb(unsharded)], reps)
    finally:
        set_executable_cache_capacity(128)
    run_single(), run_single()  # the unsharded entry: a miss, then the capture
    ex_s, replay_0 = alternating_ms([run_sharded, run_single], reps)
    plan0 = unsharded.plan_for(sizes)
    log(f"  {label}: plan shards={plan.shards} chunks={plan.num_chunks} layout={layout} "
        f"launches={rose} max_err_vs_x_true={max_err(x, x_true):.3e} "
        f"bit_identical_to_unsharded_same_plan={bits}")
    log(f"    device path on card operands, sharded vs unsharded: events in turn {ev_s:.4f} vs "
        f"{ev_0:.4f} ms, device time {dev_s:.4f} vs {dev_0:.4f} ms; executor with the copy to "
        f"the host, events in turn: sharded {ex_s:.4f} vs unsharded replay {replay_0:.4f} ms; "
        f"host clock, verbs from host operands, in turn, both eager: sharded {host_s:.3f} vs "
        f"unsharded session {host_0:.3f} ms (its own plan: {plan0.num_chunks} chunks, "
        f"{unsharded._fused.resolved_layout(plan0)})")
    return {"plan": plan, "layout": layout, "shards": shards, "dev_ms": (dev_s, dev_0),
            "path_sharded": path_s, "path_single": path_0}


def mesh_phase(dev: torch.device) -> Dict[str, int]:
    """The multi-device solve on ``MESH_SHARDS`` logical shards of one card
    (``mesh=("cuda:0",) * 4``), ``backend="cuda"``, m = 10: every case
    through ``mesh_case``, the replicated reduced solves' extra device
    time, the executable cache's entries for 4, 2 and no shards, and
    ``mesh="auto"`` where more than one card is visible. Returns the
    launches of the solver's kernels over the phase."""
    from repro_torch.api import (
        FixedChunkPolicy,
        HeuristicChunkPolicy,
        SolveRequest,
        SolverConfig,
        TridiagSession,
        clear_executable_cache,
        executable_cache_stats,
    )
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator
    from repro_torch.core.tridiag import plan as plan_mod
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.thomas.ops import thomas_cuda
    from repro_torch.parallel import mesh_signature, resolve_mesh_devices

    logical = (str(dev),) * MESH_SHARDS
    heuristic = fit_stream_heuristic(StreamSimulator(seed=1).dataset(reps=2))
    cfg = SolverConfig(m=M, device=str(dev), backend="cuda", layout="auto", mesh=logical,
                       policy=HeuristicChunkPolicy(heuristic))
    big = system(10_000_000, 1, np.float64)
    odd = system(10_000_010, 7, np.float64)
    b64 = system(100_000, 3, np.float64, batch=(64,))
    wide = {np.float64: system(10_000, 6, np.float64, batch=(1024,)),
            np.float32: system(10_000, 8, np.float32, batch=(1024,))}
    # 48 ragged sizes of 10,000 ... 400,000 rows, each a multiple of 4·m, so
    # that the fused block axis splits into 4 shards.
    many = [system(10_000 + (390_000 * i // 47) // (4 * M) * (4 * M), 500 + i, np.float64)
            for i in range(48)]
    served = [system((10_000, 40_000, 50_000, 80_000)[i % 4], 600 + i, np.float64) for i in range(16)]
    many_sizes = tuple(m[4].size for m in many)
    served_sizes = tuple(m[4].size for m in served)

    def serve16(session: Any) -> List[np.ndarray]:
        futs = [session.submit(SolveRequest(i, *s[:4])) for i, s in enumerate(served)]
        return [f.result(timeout=300) for f in futs]

    def concat(systems: List[Tuple[np.ndarray, ...]]) -> List[np.ndarray]:
        return [np.concatenate([s[j] for s in systems]) for j in range(5)]

    clear_executable_cache()
    for c in LAUNCH_COUNTERS.values():
        c.reset()
    cases: Dict[str, Dict[str, Any]] = {}
    fixed8 = cfg.replace(policy=FixedChunkPolicy(8))
    with TridiagSession(fixed8) as s, TridiagSession(fixed8.replace(mesh=None)) as s0:
        want_mesh = {"devices": MESH_SHARDS, "platform": dev.type,
                     "signature": ((dev.type, dev.index),) * MESH_SHARDS}
        assert s.stats["mesh"] == want_mesh and s0.stats["mesh"] is None, s.stats["mesh"]
        log(f"  stats()['mesh'] = {s.stats['mesh']}")
        cases["solve8"] = mesh_case(dev, "solve n=1e7 fp64 FixedChunkPolicy(8)", s, s0,
                                    lambda ss: ss.solve(*big[:4]), (big[4].size,), list(big[:4]),
                                    big[4], np.float64)
    with TridiagSession(cfg) as s, TridiagSession(cfg.replace(mesh=None)) as s0:
        mesh_case(dev, "solve n=1e7 fp64 heuristic", s, s0, lambda ss: ss.solve(*big[:4]),
                  (big[4].size,), list(big[:4]), big[4], np.float64)
        case = mesh_case(dev, "solve_batched 64x100000 fp64", s, s0,
                         lambda ss: ss.solve_batched(*b64[:4]), (b64[4].shape[1],) * b64[4].shape[0],
                         [a.reshape(-1) for a in b64[:4]], b64[4].reshape(-1), np.float64)
        assert case["layout"] == "system-major", case["layout"]
        for np_dtype, ops in wide.items():
            case = mesh_case(dev, f"solve_batched 1024x10000 {np.dtype(np_dtype).name}", s, s0,
                             lambda ss, ops=ops: ss.solve_batched(*ops[:4]),
                             (ops[4].shape[1],) * ops[4].shape[0],
                             [a.reshape(-1) for a in ops[:4]], ops[4].reshape(-1), np_dtype)
            assert case["layout"] == "interleaved" and case["shards"] == MESH_SHARDS, case["layout"]
        fused_many = concat(many)
        mesh_case(dev, "solve_many 48 ragged 10000..400000 fp64", s, s0,
                  lambda ss: ss.solve_many([m[:4] for m in many]), many_sizes, fused_many[:4],
                  fused_many[4], np.float64)
        case = mesh_case(dev, "solve n=1e7+10 fp64 heuristic (1,000,001 blocks)", s, s0,
                         lambda ss: ss.solve(*odd[:4]), (odd[4].size,), list(odd[:4]), odd[4],
                         np.float64)
        assert case["plan"].shards == 1 and case["shards"] == 1, case["plan"].shards
        assert case["plan"] == s0.plan_for(odd[4].size)
    served_cfg = cfg.replace(max_batch=16, max_wait_ms=5000.0)
    with TridiagSession(served_cfg) as s, TridiagSession(served_cfg.replace(mesh=None)) as s0:
        fused_served = concat(served)
        mesh_case(dev, "submit x16 10000..80000 fp64", s, s0, serve16, served_sizes,
                  fused_served[:4], fused_served[4], np.float64)
        batches = s.stats["per_batch"]
        assert all(b["systems"] == 16 for b in batches), batches

    # The device time the replicated reduced solves add: each shard solves
    # all P = n/m reduced rows, so S shards solve them S - 1 times more.
    sm = cases["solve8"]
    plan, extra = sm["plan"], MESH_SHARDS - 1
    red = [torch.as_tensor(a, device=dev) for a in system(plan.num_blocks, 9, np.float64)[:4]]
    red_ms = device_ms(lambda: thomas_cuda(*red))
    busy = {}
    for name in ("sharded", "single"):
        entries = traced(f"mesh {name} n=1e7 k=8 device path", sm[f"path_{name}"], reps=1)
        kernels: Dict[str, int] = {}
        for us, c, k in entries:
            kernels[k[:60]] = kernels.get(k[:60], 0) + c
        busy[name] = sum(us for us, _, _ in entries) / 1e3
        log(f"    profiler, {name} n=1e7 k=8 device path (eager): device busy {busy[name]:.4f} ms; "
            f"{sum(kernels.values())} device entries: {sorted(kernels.items())}")
    log(f"  replicated reduced solves, n=1e7 fp64 ({plan.num_blocks} rows, {MESH_SHARDS} logical "
        f"shards): one reduced solve {red_ms:.4f} ms device time, so {extra} more add "
        f"{extra * red_ms:.4f} ms; the device path's device time sharded - unsharded "
        f"{sm['dev_ms'][0] - sm['dev_ms'][1]:.4f} ms; its profiler busy time sharded - unsharded "
        f"{busy['sharded'] - busy['single']:.4f} ms")

    # One cache entry each for 4 shards, 2 shards and none, the same bits.
    clear_executable_cache()
    answers = []
    for mesh in (logical, logical[:2], None):
        with TridiagSession(fixed8.replace(mesh=mesh)) as s:
            answers.append(s.solve(*big[:4]))
    with plan_mod._CACHE_LOCK:
        keys = list(plan_mod._EXEC_CACHE)
    assert executable_cache_stats()["size"] == 3, executable_cache_stats()
    assert [k[0].shards for k in keys] == [4, 2, 1] and [len(k) for k in keys] == [7, 7, 6], keys
    assert [k[-1] for k in keys[:2]] == [mesh_signature(resolve_mesh_devices(m))
                                         for m in (logical, logical[:2])]
    assert all(np.array_equal(a, answers[0]) for a in answers[1:]), "4, 2 and 1 shards differ"
    log(f"  executable cache: 3 entries for 4, 2 and no shards (keys end in "
        f"{keys[0][-1]}, {keys[1][-1]}, unsharded 6-tuple); the three answers bit_identical=True")

    if torch.cuda.device_count() > 1:
        with TridiagSession(fixed8.replace(mesh="auto")) as s, \
                TridiagSession(fixed8.replace(mesh=None)) as s0:
            assert s.stats["mesh"]["devices"] == torch.cuda.device_count()
            mesh_case(dev, f"solve n=1e7 fp64 mesh='auto' over {torch.cuda.device_count()} cards",
                      s, s0, lambda ss: ss.solve(*big[:4]), (big[4].size,), list(big[:4]),
                      big[4], np.float64)
    else:
        assert resolve_mesh_devices("auto") is None
        log("  mesh='auto': skipped, one CUDA device is visible, so it resolves to the "
            "unsharded path; no multi-card time was taken")
    clear_executable_cache()

    launches = {name: LAUNCH_COUNTERS[name].count for name in MESH_KERNELS}
    log(f"  launch counts on the mesh path (by the wrappers): {launches}; replayed from CUDA "
        f"graphs beside them: { {n: LAUNCH_COUNTERS[n].replayed for n in MESH_KERNELS} }")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was never launched on the mesh path"
    return launches


def lm_phase(dev: torch.device) -> Dict[str, int]:
    """The LM serving path on the card; returns the SSD kernel's launches
    over part (a) and the served runs of part (b)."""
    import gc

    from repro_torch.kernels import LAUNCH_COUNTERS

    for c in LAUNCH_COUNTERS.values():
        c.reset()
    log(f"  torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"(fp32 products in full fp32)")
    for arch, layers, seq in LM_PARITY:
        lm_parity(dev, arch, layers, seq)
        gc.collect()
    # The breakdowns launch the SSD kernel outside the path: their launches
    # are taken off the path's counts.
    outside = {name: 0 for name in LM_KERNELS}
    for arch in LM_SERVED:
        params, cfg = lm_serve(dev, arch)
        if arch in LM_BREAKDOWNS:
            before = {name: LAUNCH_COUNTERS[name].count for name in LM_KERNELS}
            (moe_breakdown if cfg.family == "moe" else lm_breakdown)(dev, params, cfg)
            for name in LM_KERNELS:
                outside[name] += LAUNCH_COUNTERS[name].count - before[name]
        if cfg.family == "encdec":
            encdec_frames(dev, params, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    lm_kimi(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: LAUNCH_COUNTERS[name].count - outside[name] for name in LM_KERNELS}
    log(f"  launch counts on the lm path: {launches} (the breakdowns' {outside} not counted)")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was never launched on the lm path"
    return launches


def ssm_layers(cfg: Any) -> int:
    """The SSM layers of a config: one SSD launch each a prefill."""
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


class Routes:
    """While open, records the router's expert ids and the capacity of every
    MoE dispatch (``_expert_shard``) where ``on`` is set."""

    def __init__(self) -> None:
        self.calls: List[Tuple[torch.Tensor, int]] = []
        self.on = True

    def __enter__(self) -> "Routes":
        from repro_torch.models.layers import moe

        self._inner = moe._expert_shard

        def spy(*args: Any, **kw: Any) -> torch.Tensor:
            if self.on:
                self.calls.append((args[5], kw["capacity"]))
            return self._inner(*args, **kw)

        moe._expert_shard = spy
        return self

    def __exit__(self, *exc: Any) -> None:
        from repro_torch.models.layers import moe

        moe._expert_shard = self._inner

    def dropped(self, num_experts: int,
                real: Optional[List[torch.Tensor]] = None) -> Tuple[int, int, int, int]:
        """(token, k) choices that found their expert full, all choices, and
        the same two over the tokens ``real`` marks ([T] booleans, one mask
        a call; all tokens where it is ``None``). An expert keeps its first
        ``capacity`` choices in flat order, as the layer assigns slots."""
        dropped = total = real_dropped = real_total = 0
        for c, (ids, capacity) in enumerate(self.calls):
            flat = ids.reshape(-1)
            order = torch.argsort(flat, stable=True)
            ranked = flat[order]
            first = torch.searchsorted(ranked, torch.arange(num_experts, device=flat.device))
            kept = torch.empty_like(flat, dtype=torch.bool)
            kept[order] = torch.arange(flat.numel(), device=flat.device) - first[ranked] < capacity
            mask = (torch.ones_like(kept) if real is None
                    else real[c].to(flat.device).repeat_interleave(ids.shape[-1]))
            dropped += int((~kept).sum())
            total += flat.numel()
            real_dropped += int((~kept & mask).sum())
            real_total += int(mask.sum())
        return dropped, total, real_dropped, real_total


def family_cfg(arch: str, layers: int, **changes: Any) -> Any:
    """The published config cut to ``layers`` layers (the encoder's and the
    decoder's each for the encoder-decoder)."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    depth = ({"enc_layers": layers, "dec_layers": layers, "num_layers": 2 * layers}
             if cfg.family == "encdec" else {"num_layers": layers})
    return dataclasses.replace(cfg, **depth, **changes)


def frames_of(cfg: Any, b: int, t: int, seed: int, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The encoder-decoder's frames from a seed (``{}`` for other families)."""
    if cfg.family != "encdec":
        return {}
    a = np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(np.float32)
    return {"frames": torch.from_numpy(a).to(dev, getattr(torch, cfg.dtype))}


def cache_leaves(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``caches_to_reference``'s arrays by name: ``kv.k``, ``enc_out``, ..."""
    return {(f"{key}.{f}" if isinstance(fields, dict) else key): a
            for key, fields in tree.items()
            for f, a in (fields.items() if isinstance(fields, dict) else ((key, fields),))}


def lm_parity(dev: torch.device, arch: str, layers: int, seq: int) -> None:
    """(a) Full width, ``layers`` layers, fp32: the card against the CPU on
    the same weights (drawn on the card, copied to the host), prompts of
    2 x ``seq`` tokens and 4 greedy decode steps (the encoder-decoder's
    against ``frontend_tokens`` frames from a seed); the MoE's router
    choices card against CPU."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models.convert import caches_to_reference
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.ctx import ParallelCtx

    cfg = family_cfg(arch, layers, dtype="float32")
    model, pctx = build_model(cfg), ParallelCtx()
    t0 = time.perf_counter()
    card_params = model.init(0, device=dev)
    cpu_params = model.init(0, device=dev).to("cpu")
    log(f"  (a) {arch}: weights drawn in {time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(np.random.default_rng(50).integers(0, cfg.vocab_size, size=(2, seq)))
    ssd = LAUNCH_COUNTERS["ssd_stage1"]
    runs = {}
    for where, params in (("cpu", cpu_params), ("cuda", card_params)):
        on = params.emb.embed.device
        before = ssd.count
        t0 = time.perf_counter()
        with Routes() as routes:
            batch = {"tokens": tokens.to(on), **frames_of(cfg, 2, cfg.frontend_tokens, 51, on)}
            logits, caches = model.prefill(params, batch, pctx, max_len=seq + 4)
            steps, toks = [logits.float().cpu()], []
            tok = torch.argmax(logits[:, -1:], dim=-1)
            for i in range(4):
                toks.append(tok[:, 0].tolist())
                pos = torch.full((2,), seq + i, dtype=torch.int32, device=on)
                logits, caches = model.decode_step(params, caches, {"token": tok, "pos": pos}, pctx)
                steps.append(logits[:, -1].float().cpu())
                tok = torch.argmax(logits[:, -1:], dim=-1)
        toks.append(tok[:, 0].tolist())
        if where == "cuda":
            torch.cuda.synchronize()
        runs[where] = (steps, toks, caches_to_reference(caches, cfg), ssd.count - before,
                       [ids.cpu() for ids, _ in routes.calls])
        log(f"  (a) {where}: prefill 2x{seq} + 4 decode steps in "
            f"{time.perf_counter() - t0:.2f} s, ssd_stage1 launches {ssd.count - before}")
    (c_steps, c_toks, c_caches, c_ssd, c_ids), (g_steps, g_toks, g_caches, g_ssd, g_ids) = (
        runs["cpu"], runs["cuda"])
    if cfg.family == "moe":
        # Choices in the card's top k that are not in the CPU's, by dispatch.
        assert len(g_ids) == len(c_ids) == layers * 5, (len(g_ids), len(c_ids))
        differ = [int((~(g[..., :, None] == c[..., None, :]).any(-1)).sum())
                  for g, c in zip(g_ids, c_ids)]
        reordered = sum(int((g != c).any(-1).sum()) for g, c in zip(g_ids, c_ids))
        log(f"  (a) {arch} router, card vs CPU: {sum(differ)} of "
            f"{sum(g.numel() for g in g_ids)} (token, k) expert choices differ "
            f"(per dispatch, prefill then decode, layer by layer: {differ}); tokens whose "
            f"top-{cfg.experts_per_token} order differs: {reordered}")
    assert c_ssd == 0 and g_ssd == ssm_layers(cfg), (c_ssd, g_ssd)  # the card's prefill
    errs = []
    for cl, gl in zip(c_steps, g_steps):
        np.testing.assert_allclose(gl.numpy(), cl.numpy(), rtol=1e-3, atol=1e-3)
        errs.append(max_err(gl, cl))
    cache_errs = {}
    for name, want in cache_leaves(c_caches).items():
        got = cache_leaves(g_caches)[name]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
        cache_errs[name] = max_err(got, want)
    assert g_toks == c_toks, (g_toks, c_toks)
    shape = (f"{layers} encoder + {layers} decoder layers, {cfg.frontend_tokens} frames"
             if cfg.family == "encdec" else f"{layers} layers")
    log(f"  (a) {arch} full width, {shape}, fp32, card vs CPU: logits max_abs_err per step "
        f"{['%.3e' % e for e in errs]}, final caches max_abs_err "
        f"{ {k: float('%.3e' % e) for k, e in cache_errs.items()} }, greedy tokens identical "
        f"{g_toks}")
    del card_params, cpu_params


def model_shape(cfg: Any) -> str:
    if cfg.family == "hybrid":
        return (f"{cfg.num_layers} SSM layers and {cfg.num_layers // cfg.shared_attn_every} "
                f"shared-block calls")
    if cfg.family == "moe":
        return (f"{cfg.num_layers} layers, {cfg.num_experts} experts top-{cfg.experts_per_token}"
                f" + {cfg.num_shared_experts} shared")
    if cfg.family == "encdec":
        return f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers"
    return f"{cfg.num_layers} layers"


def check_logits(logits: torch.Tensor, cfg: Any) -> None:
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())


def drop_note(routes: Routes, cfg: Any, real: Optional[List[torch.Tensor]] = None) -> str:
    """The share of MoE (token, k) choices dropped at prefill, and, where
    ``real`` marks the prompts' tokens, the share among them."""
    if cfg.family != "moe":
        return ""
    dropped, total, real_dropped, real_total = routes.dropped(cfg.num_experts, real)
    note = (f", MoE slots dropped at prefill {dropped} of {total} (token, k) choices "
            f"({dropped / max(total, 1):.2%})")
    if real is not None:
        note += (f", of the prompts' own tokens {real_dropped} of {real_total} "
                 f"({real_dropped / max(real_total, 1):.2%}; the other dropped choices are "
                 f"left pads', which route alike and take their experts' first slots)")
    return note


def lm_serve(dev: torch.device, arch: str) -> Tuple[Any, Any]:
    """(b) The real model served on the card at full depth in bf16: 8
    requests in 4 slots, 16 new tokens each, KV caches of 1040 positions."""
    import repro_torch.launch.serve as serve_mod
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import LAUNCH_COUNTERS

    cfg = get_config(arch)
    ssd = LAUNCH_COUNTERS["ssd_stage1"]
    rng = np.random.default_rng(60)
    # Batch 1 pads to 1024 tokens (4 chunks of 256); batch 2 to 197 (one odd chunk).
    lengths = (1024, 700, 512, 300, 197, 150, 64, 9)
    max_new = 16
    reqs = [serve_mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n), max_new=max_new)
            for i, n in enumerate(lengths)]
    seen: Dict[str, Any] = {"prefill_ms": [], "decode_ms": [], "params": None}
    make_prefill, make_decode = serve_mod.make_prefill_step, serve_mod.make_decode_step
    routes = Routes()

    def prefill_step(*a: Any, **k: Any) -> Callable[..., Any]:
        step = make_prefill(*a, **k)

        def run(params: Any, batch: Dict[str, torch.Tensor]) -> Any:
            seen["params"] = params
            before = ssd.count
            routes.on = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = step(params, batch)
            torch.cuda.synchronize()
            seen["prefill_ms"].append((tuple(batch["tokens"].shape), (time.perf_counter() - t0) * 1e3))
            routes.on = False
            assert ssd.count - before == ssm_layers(cfg), (ssd.count - before, ssm_layers(cfg))
            check_logits(logits, cfg)
            return logits, caches
        return run

    def decode_step(*a: Any, **k: Any) -> Callable[..., Any]:
        step = make_decode(*a, **k)

        def run(*args: Any) -> Any:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = step(*args)
            torch.cuda.synchronize()
            seen["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            check_logits(logits, cfg)
            return logits, caches
        return run

    torch.cuda.reset_peak_memory_stats(dev)
    serve_mod.make_prefill_step, serve_mod.make_decode_step = prefill_step, decode_step
    t0 = time.perf_counter()
    try:
        with routes:
            done, stats = serve_mod.serve(arch=arch, requests=reqs, batch_slots=4, smoke=False,
                                          max_len=max(lengths) + max_new, seed=0, device="cuda")
    finally:
        serve_mod.make_prefill_step, serve_mod.make_decode_step = make_prefill, make_decode
    peak = torch.cuda.max_memory_allocated(dev)
    assert stats["prefills"] == 2 and stats["tokens"] == max_new * len(reqs), stats
    for r in done:
        assert len(r.out) == max_new and all(0 <= t < cfg.vocab_size for t in r.out), (r.rid, r.out)
    real = None
    if cfg.family == "moe":
        assert len(routes.calls) == 2 * cfg.num_layers, len(routes.calls)
        # The prompts' tokens of each prefill batch (left-padded), a mask a layer.
        real = []
        for lo in (0, 4):
            rows = lengths[lo:lo + 4]
            width = max(rows)
            mask = torch.cat([torch.arange(width) >= width - n for n in rows])
            real += [mask] * cfg.num_layers
    n_params = sum(p.numel() for p in seen["params"].parameters())
    dec = seen["decode_ms"]
    frames = (f", {serve_mod.ENCDEC_FRAMES} zero frames a batch" if cfg.family == "encdec"
              else "")
    log(f"  (b) {arch} served, {model_shape(cfg)}, {cfg.dtype}, {n_params} parameters "
        f"(init and serve {time.perf_counter() - t0:.2f} s{frames}): "
        f"prefill_ms per batch {[(sh, round(ms, 3)) for sh, ms in seen['prefill_ms']]}, "
        f"decode_ms per token median {statistics.median(dec):.3f} (min {min(dec):.3f}, "
        f"max {max(dec):.3f}, {len(dec)} steps), tokens/s {stats['tokens'] / stats['wall_s']:.1f} "
        f"(wall_s {stats['wall_s']:.3f}), peak_memory_GB {peak / 1e9:.3f}; stats {stats}; "
        f"ssd_stage1 launches per prefill {ssm_layers(cfg)}{drop_note(routes, cfg, real)}; first "
        f"tokens {[r.out[:4] for r in done[:2]]}")
    return seen["params"], cfg


def lm_kimi(dev: torch.device) -> None:
    """(b) kimi-k2-1t-a32b at full width, cut to ``KIMI_LAYERS`` layers, in
    bf16 through ``Model.prefill`` and ``decode_step``: 4 x 1024 tokens,
    KV caches of 1040 positions, 16 greedy steps; then its breakdown."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.ctx import ParallelCtx

    cfg = family_cfg("kimi-k2-1t-a32b", KIMI_LAYERS)
    model, pctx = build_model(cfg), ParallelCtx()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    bsz, s, steps = 4, 1024, 16
    tokens = torch.as_tensor(np.random.default_rng(61).integers(0, cfg.vocab_size, size=(bsz, s)),
                             device=dev)
    with Routes() as routes:
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, {"tokens": tokens}, pctx, max_len=s + steps)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        check_logits(logits, cfg)
        routes.on = False
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out, dec = [], []
        t_all = time.perf_counter()
        for i in range(steps):
            out.append(tok[:, 0].tolist())
            pos = torch.full((bsz,), s + i, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, caches, {"token": tok, "pos": pos}, pctx)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
            check_logits(logits, cfg)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(0 <= t < cfg.vocab_size for row in out for t in row), out
    log(f"  (b) kimi-k2-1t-a32b at full width cut to {model_shape(cfg)} (of "
        f"{get_config('kimi-k2-1t-a32b').num_layers}), bf16, {n_params} parameters (drawn in "
        f"{init_s:.2f} s): prefill {bsz}x{s} {prefill_ms:.3f} ms (first call), decode_ms per "
        f"token median {statistics.median(dec):.3f} (min {min(dec):.3f}, max {max(dec):.3f}, "
        f"{steps} steps), tokens/s {bsz * steps / wall:.1f}, peak_memory_GB {peak / 1e9:.3f}"
        f"{drop_note(routes, cfg)}; first tokens {[row[:2] for row in out[:4]]}")
    del caches, logits
    moe_breakdown(dev, params, cfg)
    del params


def encdec_frames(dev: torch.device, params: Any, cfg: Any) -> None:
    """The encoder at its real length: one ``Model.prefill`` of 4 x 64
    tokens against [4, frontend_tokens, d] frames from a seed, the
    encoder's part of it (CUDA events around ``encode``), and 4 decode
    steps, each of which projects the cross-attention's K/V from the
    1500 encoder rows again in every decoder layer."""
    from repro_torch.models import encdec as E
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.ctx import ParallelCtx

    model, pctx = build_model(cfg), ParallelCtx()
    bsz, s, t = 4, 64, cfg.frontend_tokens
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(62).integers(0, cfg.vocab_size, size=(bsz, s)), device=dev),
        **frames_of(cfg, bsz, t, 63, dev)}
    with torch.inference_mode():
        prefill = cuda_ms(lambda: model.prefill(params, batch, pctx, max_len=s + 4), reps=3,
                          warmup=1)
        encoder = cuda_ms(lambda: E.encode(params, batch["frames"], cfg, pctx), reps=3, warmup=1)
        logits, caches = model.prefill(params, batch, pctx, max_len=s + 4)
        check_logits(logits, cfg)
        assert tuple(caches["enc_out"].shape) == (bsz, t, cfg.d_model)
        dec = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for i in range(4):
            pos = torch.full((bsz,), s + i, dtype=torch.int32, device=dev)
            ms, (logits, caches) = timed_cuda(
                lambda: model.decode_step(params, caches, {"token": tok, "pos": pos}, pctx),
                reps=1, warmup=0)
            dec.append(ms)
            check_logits(logits, cfg)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    log(f"  (b) {cfg.arch_id} at the real encoder length, frames [{bsz}, {t}, {cfg.d_model}] "
        f"{cfg.dtype}, prompts {bsz}x{s}: prefill {prefill:.3f} ms (CUDA events), of which the "
        f"encoder {encoder:.3f} ms ({encoder / prefill:.1%}) and the decoder over the prompt "
        f"{prefill - encoder:.3f}; decode steps against {t} encoder rows (ms) "
        f"{[round(ms, 3) for ms in dec]}")


def moe_breakdown(dev: torch.device, params: Any, cfg: Any) -> None:
    """Where one bf16 prefill of 4 x 1024 tokens and one decode step at
    batch 4 (after a 1024-token prompt; KV caches of 1040 positions) go for
    an MoE model: each part timed on its own with CUDA events on random
    inputs of its shape, one layer's part times the layers; the MoE layer
    split into its expert products (three batched products over E at the
    call's capacity), its shared experts and the rest of it (router, sort,
    dispatch, combine); the rest of the model by difference."""
    from repro_torch.models.layers.attention import attention_apply, make_kv_cache
    from repro_torch.models.layers.embedding import logits_out
    from repro_torch.models.layers.mlp import mlp_apply
    from repro_torch.models.layers.moe import _capacity, moe_apply
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.ctx import ParallelCtx

    model, pctx = build_model(cfg), ParallelCtx()
    layers = cfg.num_layers
    layer = params.layers[0]
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(71)
    bf16 = params.emb.embed.dtype
    bsz, t_cache = 4, 1040
    with torch.inference_mode():
        for s in (1024, 1):
            tokens = torch.randint(0, cfg.vocab_size, (bsz, s), generator=gen, device=dev)
            if s > 1:
                total = cuda_ms(lambda: model.prefill(params, {"tokens": tokens}, pctx,
                                                      max_len=t_cache), reps=3, warmup=1)
                index = torch.zeros(bsz, dtype=torch.int32, device=dev)
                positions = torch.arange(s, device=dev).expand(bsz, s)
            else:
                prompt = torch.randint(0, cfg.vocab_size, (bsz, 1024), generator=gen, device=dev)
                _, caches = model.prefill(params, {"tokens": prompt}, pctx, max_len=t_cache)
                index = torch.full((bsz,), 1024, dtype=torch.int32, device=dev)
                positions = index[:, None]
                total = cuda_ms(lambda: model.decode_step(
                    params, caches, {"token": tokens, "pos": index}, pctx), reps=10, warmup=2)
                del caches
            x = torch.randn(bsz, s, d, generator=gen, device=dev).to(bf16)
            cap = _capacity(bsz * s, cfg)
            xe = torch.randn(e, cap, d, generator=gen, device=dev).to(bf16)
            he = torch.randn(e, cap, f, generator=gen, device=dev).to(bf16)
            moe = layer.moe
            parts = {}
            cache = make_kv_cache(cfg, bsz, t_cache, bf16, device=dev)
            parts["attention (with its projections)"] = cuda_ms(
                lambda: attention_apply(layer.attn, x, positions, cfg, pctx, cache=cache,
                                        cache_index=index), reps=5) * layers
            whole = cuda_ms(lambda: moe_apply(moe, x, cfg, pctx), reps=5) * layers
            parts["MoE expert products"] = cuda_ms(
                lambda: (torch.bmm(xe, moe.w1), torch.bmm(xe, moe.w3), torch.bmm(he, moe.w2)),
                reps=5) * layers
            parts["MoE shared experts"] = (cuda_ms(
                lambda: mlp_apply(moe.shared, x, "silu_gated", pctx), reps=5) * layers
                if moe.shared is not None else 0.0)
            parts["MoE router, sort, dispatch, combine"] = (
                whole - parts["MoE expert products"] - parts["MoE shared experts"])
            parts["logits"] = cuda_ms(lambda: logits_out(params.emb, x, cfg, pctx), reps=5)
            parts["rest (norms, embedding, residuals, launches)"] = total - sum(parts.values())
            del cache
            label = f"prefill {bsz}x{s}" if s > 1 else f"decode step, batch {bsz}"
            log(f"  where the time goes, {cfg.arch_id} {label} (bf16, {model_shape(cfg)}, "
                f"capacity {cap} slots an expert): total_ms={total:.3f}; MoE layer "
                f"{whole:.3f} ({whole / total:.1%}); "
                + "; ".join(f"{k}={v:.3f} ({v / total:.1%})" for k, v in parts.items()))


def lm_breakdown(dev: torch.device, params: Any, cfg: Any) -> None:
    """Where one full-width bf16 prefill of 4 x 1024 tokens and one decode
    step at batch 4 (after a 1024-token prompt; KV caches of 1040
    positions) go: each part timed on its own with CUDA events, one SSM
    layer's part times the SSM layers and, for the hybrid, one shared-block
    call's part times its calls; the rest by difference. The SSD kernel's
    device time (``device_ms``) is printed beside."""
    from repro_torch.kernels.ssd_stage1.ops import ssd_scan_kernel, ssd_stage1_cuda
    from repro_torch.models.hybrid import SHARED_ACTIVATION, _split
    from repro_torch.models.layers.attention import attention_apply, make_kv_cache
    from repro_torch.models.layers.embedding import logits_out
    from repro_torch.models.layers.mlp import mlp_apply
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.ctx import ParallelCtx

    model, pctx = build_model(cfg), ParallelCtx()
    hybrid = cfg.family == "hybrid"
    layers = cfg.num_layers
    calls = _split(cfg)[0] if hybrid else 0
    layer = (params.ssm_layers if hybrid else params.layers)[0].ssm
    d, di, nh, p, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(70)
    bf16 = params.emb.embed.dtype
    bsz, t_cache = 4, 1040
    with torch.inference_mode():
        for s in (1024, 1):
            tokens = torch.randint(0, cfg.vocab_size, (bsz, s), generator=gen, device=dev)
            if s > 1:
                total = cuda_ms(lambda: model.prefill(params, {"tokens": tokens}, pctx,
                                                      max_len=t_cache), reps=3, warmup=1)
                index = torch.zeros(bsz, dtype=torch.int32, device=dev)
                positions = torch.arange(s, device=dev).expand(bsz, s)
            else:
                prompt = torch.randint(0, cfg.vocab_size, (bsz, 1024), generator=gen, device=dev)
                _, caches = model.prefill(params, {"tokens": prompt}, pctx, max_len=t_cache)
                index = torch.full((bsz,), 1024, dtype=torch.int32, device=dev)
                positions = index[:, None]
                total = cuda_ms(lambda: model.decode_step(
                    params, caches, {"token": tokens, "pos": index}, pctx), reps=10, warmup=2)
                del caches
            x = torch.randn(bsz, s, d, generator=gen, device=dev).to(bf16)
            y = torch.randn(bsz, s, di, generator=gen, device=dev).to(bf16)
            proj = cuda_ms(lambda: (x @ layer.w_z, x @ layer.w_x, x @ layer.w_b, x @ layer.w_c,
                                    x @ layer.w_dt, y @ layer.out_proj), reps=10) * layers
            parts = {"projections": proj}
            if hybrid:
                x2 = torch.randn(bsz, s, 2 * d, generator=gen, device=dev).to(bf16)
                parts["projections"] += cuda_ms(lambda: x2 @ params.shared.w_in, reps=10) * calls
            if s > 1:
                xh = torch.randn(bsz, s, nh, p, generator=gen, device=dev)
                dt = torch.nn.functional.softplus(torch.randn(bsz, s, nh, generator=gen, device=dev))
                a = -torch.exp(layer.a_log)
                b_in, c_in = (torch.randn(bsz, s, n, generator=gen, device=dev) for _ in range(2))
                scan = cuda_ms(lambda: ssd_scan_kernel(xh, dt, a, b_in, c_in, chunk=cfg.ssm_chunk),
                               reps=10) * layers
                g, q = bsz * s // cfg.ssm_chunk, cfg.ssm_chunk
                u, dac, bc, cc = (xh.reshape(g, q, nh, p), (dt * a).reshape(g, q, nh),
                                  b_in.reshape(g, q, n), c_in.reshape(g, q, n))
                kernel = cuda_ms(lambda: ssd_stage1_cuda(u, dac, bc, cc), reps=10) * layers
                log(f"    ssd_stage1 device time (device_ms, cold L2): "
                    f"{device_ms(lambda: ssd_stage1_cuda(u, dac, bc, cc)) * layers:.3f} ms "
                    f"for {layers} layers")
                parts.update({"ssd_stage1 kernel": kernel, "ssd stages 2-3 and glue": scan - kernel})
            if hybrid:
                cache = make_kv_cache(cfg, bsz, t_cache, bf16, device=dev)
                parts["shared attention (with its projections)"] = cuda_ms(
                    lambda: attention_apply(params.shared.attn, x, positions, cfg, pctx, cache=cache,
                                            cache_index=index), reps=5) * calls
                parts["shared MLP"] = cuda_ms(
                    lambda: mlp_apply(params.shared.mlp, x, SHARED_ACTIVATION, pctx), reps=5) * calls
            parts["logits"] = cuda_ms(lambda: logits_out(params.emb, x, cfg, pctx), reps=5)
            parts["rest (conv, norms, gating, embedding, launches)"] = total - sum(parts.values())
            label = f"prefill {bsz}x{s}" if s > 1 else f"decode step, batch {bsz}"
            shape = f"{layers} SSM layers" + (f", {calls} shared-block calls" if hybrid else "")
            log(f"  where the time goes, {cfg.arch_id} {label} (bf16, {shape}): total_ms={total:.3f}; "
                + "; ".join(f"{k}={v:.3f} ({v / total:.1%})" for k, v in parts.items()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help=f"comma list of phases, from {ALL_PHASES}")
    args = parser.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import LAUNCH_COUNTERS, build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card_line()}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    info = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(info)}")
    if "build" in phases:
        for name, item in info.items():
            regs = [ln.strip() for ln in str(item["ptxas"]).splitlines() if "registers" in ln]
            log(f"  {name}: built={item['built']} {'; '.join(regs)}")

    rows: List[Dict[str, Any]] = []
    if "kernels" in phases:
        log("kernels: each kernel against its plain version on the card")
        t0 = time.perf_counter()
        rows = kernel_phase(dev)
        log(f"kernels: {time.perf_counter() - t0:.1f} s")
    # Launch counts come from the path that runs each kernel (the main phase
    # for the solver's, the lm phase for the SSD kernel's); a kernel whose
    # path did not run has none.
    launches: Dict[str, Any] = {name: None for name in LAUNCH_COUNTERS}
    if "main" in phases:
        log("main: TridiagSession(device='cuda', backend='auto', heuristic policy)")
        t0 = time.perf_counter()
        launches.update(main_phase(dev))
        log(f"main: {time.perf_counter() - t0:.1f} s")
    if "breakdown" in phases:
        log("breakdown: where one n=1e7 fp64 solve and one interleaved 1024x10000 "
            "solve_batched spend their time (CUDA events)")
        t0 = time.perf_counter()
        breakdown_phase(dev)
        log(f"breakdown: {time.perf_counter() - t0:.1f} s")
    closed_loop: Dict[str, int] = {}
    if "closed_loop" in phases:
        log("closed_loop: staged chunk campaigns, a live refit from served telemetry and "
            "predicted-latency admission (fp64, m=10, backend='cuda')")
        t0 = time.perf_counter()
        closed_loop = closed_loop_phase(dev)
        log(f"closed_loop: {time.perf_counter() - t0:.1f} s")
    mesh: Dict[str, int] = {}
    if "mesh" in phases:
        log(f"mesh: TridiagSession(mesh=('{dev}',) * {MESH_SHARDS}), logical shards on one card, "
            f"backend='cuda', m=10")
        t0 = time.perf_counter()
        mesh = mesh_phase(dev)
        log(f"mesh: {time.perf_counter() - t0:.1f} s")
    if "lm" in phases:
        log(f"lm: {', '.join(LM_SERVED)} through repro_torch.launch.serve (Model.prefill/"
            f"decode_step, ssd_scan_kernel, attention)")
        t0 = time.perf_counter()
        launches.update(lm_phase(dev))
        log(f"lm: {time.perf_counter() - t0:.1f} s")

    for row in rows:
        row["launches"] = launches[row["name"].split("/")[0]]
        row["replayed_launches"] = REPLAYED.get(row["name"].split("/")[0])
        row["closed_loop_launches"] = closed_loop.get(row["name"].split("/")[0])
        row["mesh_launches"] = mesh.get(row["name"].split("/")[0])
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
