"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (what CI on the card runs)
    python3 chip_smoke.py --phases build,kernels

Phases:

1. ``build``: compile the five CUDA sources in ``src/repro_torch/csrc``
   (one nvcc each, all at once) and print ptxas's register report.
2. ``kernels``: each kernel against its plain PyTorch version (the
   reference stage) on the card, in fp64 and fp32, at shapes the main path
   gives it: the system-major and batched Stage 1/Stage 3, the wide
   (interleaved) Stage 1/Stage 3, ragged identity padding included, and
   the Thomas kernel on both routes; max error against the tolerance
   ladder (fp64 1e-12, fp32 1e-5), median time from CUDA events, the plain
   version's time and the bound (bytes over 3.35 TB/s or operations over
   the peak rate, whichever is larger); for Thomas also the dependent-chain
   floor, 2n steps at the per-step time of the B = 1, n = 4096 row.
3. ``main``: the port's main path through ``TridiagSession`` on
   ``device="cuda"``, ``backend="auto"`` and the fitted Eq. 4-7 heuristic.
   System-major (``layout="system-major"``): ``solve`` at n = 1e7 (fp64)
   and 1e6 (fp32), ``solve_batched`` at 64 x 100,000, ``solve_many`` on a
   ragged mix of paper sizes and 16 ``submit`` futures, and ``solve`` on
   the stacked (64, 100,000) operands, which runs the batched kernels;
   ``solve`` at n = 1e7 and on the stacked operands with 1 and 8 chunks
   must agree; a ``backend="reference"`` session on the card is the plain
   comparison. Interleaved (``layout="auto"``, which must resolve to it):
   ``solve_batched`` at 64 x 100,000 (fp64, fp32) and 1024 x 10,000,
   ``solve_many`` of 48 ragged systems and 64 served ``submit`` requests,
   and the interleaved answer against the system-major one. Staged:
   ``solve_timed`` at n = 1e7 with one CUDA stream per chunk, twice, bit
   for bit, and ``solve_batched_timed`` on the staged interleaved branch.
   Every result is checked against ``x_true``; every kernel's launch
   counter must rise.
4. ``breakdown``: where the time of one n = 1e7 fp64 solve and of one
   interleaved ``solve_batched`` of 1024 x 10,000 fp64 goes, stage by
   stage, from CUDA events and the host clock around the copies.

It exits non-zero when there is no CUDA device, when the port cannot be
imported, or when any phase fails. The line before the last is the
``{"kernels": [...]}`` record; the last is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# Peak rates outside the tensor cores, H100 SXM at 700 W (NVIDIA data sheet).
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
M = 10
ALL_PHASES = ("build", "kernels", "main", "breakdown")
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


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
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
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.partition_stage1.ops import (
        partition_stage1_cuda,
        partition_stage1_cuda_batched,
        partition_stage1_cuda_wide,
    )
    from repro_torch.kernels.partition_stage3.ops import (
        partition_stage3_cuda,
        partition_stage3_cuda_batched,
        partition_stage3_cuda_wide,
    )
    from repro_torch.kernels.thomas.ops import thomas_cuda, thomas_cuda_wide

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
    }
    # (row, dtype tag, rows per system) of every Thomas row, for the chain floor.
    chains: List[Tuple[Dict[str, Any], str, int]] = []
    rows: List[Dict[str, Any]] = []

    def check(name: str, dtype: torch.dtype, kernel: Callable[[], Any], plain: Callable[[], Any],
              nbytes: float, ops: float, reps: int = 20, plain_reps: int = 5,
              plain_warmup: int = 2) -> Tuple[Any, float]:
        """Run, compare and time one kernel against its plain version;
        returns the kernel's output and its median ms."""
        got = kernel()
        plain_ms, want = timed_cuda(plain, reps=plain_reps, warmup=plain_warmup)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            assert tuple(g.shape) == tuple(w.shape), (name, tuple(g.shape), tuple(w.shape))
            assert_allclose_by_dtype(g, w, dtype)
        err = max(max_err(g, w) for g, w in pairs)
        ms = cuda_ms(kernel, reps=reps)
        b_ms, b_by = bound(nbytes, ops, dtype)
        source, replaces = sources[name.split("/")[0]]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "chain_floor_ms": None,
        })
        log(f"  {name}: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f}")
        return got, ms

    def stage1_cost(bsz: int, p: int, es: int) -> Tuple[float, float]:
        n = p * M
        nbytes = bsz * (4 * n + 3 * p * (M - 1) + 4 * p) * es
        return nbytes, bsz * p * (6 * (M - 2) + 3 + 9 * (M - 3) + 10)

    def stage3_cost(bsz: int, p: int, es: int) -> Tuple[float, float]:
        return bsz * (3 * p * (M - 1) + p + 1 + p * M) * es, bsz * 4 * p * (M - 1)

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
        _, ms = check(name, dtype, lambda: kernel(*ops4), lambda: plain(*ops4),
                      5 * bsz * tn * es, 8 * bsz * tn, **kw)
        # The bytes/operations bound misses what limits this kernel: each
        # system is a chain of 2n dependent division steps on one thread.
        chains.append((rows[-1], tag, tn))
        log(f"    serial chain: {2 * tn} dependent steps per system, "
            f"{ms * 1e6 / (2 * tn):.1f} ns per step measured")
        return ms

    def wide_ops(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor,
                 sizes: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
        """Fused 1-D operands (boundary couplings zeroed) → wide (P, m, B)."""
        return layout.interleave_operands(dl, d, du, b, sizes, M)

    def check_wide(tag: str, dtype: torch.dtype, es: int, wide: Tuple[torch.Tensor, ...],
                   seed: int, suffix: str = "") -> Any:
        """Wide Stage 1 and Stage 3 at one interleaved shape; returns the coeffs."""
        wp, _, wb = wide[1].shape
        label = f"P={wp},m={M},B={wb}{suffix}"
        c, _ = check(f"partition_stage1_wide/{tag}/{label}", dtype,
                     lambda: partition_stage1_cuda_wide(*wide, m=M),
                     lambda: layout.partition_stage1_wide(*wide, m=M), *stage1_cost(wb, wp, es))
        s = torch.as_tensor(np.random.default_rng(seed).standard_normal((wp, wb)), device=dev).to(dtype)
        check(f"partition_stage3_wide/{tag}/{label}", dtype,
              lambda: partition_stage3_cuda_wide(c, s), lambda: layout.partition_stage3_wide(c, s),
              *stage3_cost(wb, wp, es))
        return c

    p = 1_000_000
    for np_dtype, dtype in ((np.float64, torch.float64), (np.float32, torch.float32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        es = torch.empty((), dtype=dtype).element_size()

        # Stage 1 and Stage 3 on one n = 1e7 system (P = 1e6, m = 10), the
        # unchunked shape of the main path's largest solve.
        dl, d, du, b, _ = (torch.as_tensor(a, device=dev) for a in system(p * M, 11, np_dtype))
        c, _ = check(f"partition_stage1/{tag}/P={p},m={M}", dtype,
                     lambda: partition_stage1_cuda(dl, d, du, b, m=M),
                     lambda: partition_stage1(dl, d, du, b, M), *stage1_cost(1, p, es))
        s = torch.as_tensor(np.random.default_rng(12).standard_normal(p), device=dev).to(dtype)
        check(f"partition_stage3/{tag}/P={p},m={M}", dtype,
              lambda: partition_stage3_cuda(c, s), lambda: partition_stage3(c, s),
              *stage3_cost(1, p, es))
        red = (c.red_dl, c.red_d, c.red_du, c.red_b)
        if dtype == torch.float64:
            # The main path's reduced system of the n = 1e7 fp64 solve: one
            # thread, P = 1e6 rows. The plain loop takes minutes: one call.
            check_thomas(tag, dtype, es, red, reps=3, plain_reps=1, plain_warmup=0)
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
        c, _ = check(f"partition_stage1/{tag}/B={bsz},P={bp},m={M}", dtype,
                     lambda: partition_stage1_cuda_batched(dl, d, du, b, m=M),
                     lambda: partition_stage1(dl, d, du, b, M), *stage1_cost(bsz, bp, es))
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

        if dtype == torch.float64:
            # solve_batched of 1024 x 10,000 (P = 1,000, B = 1024).
            fused = fuse_systems(*(torch.as_tensor(a, device=dev)
                                   for a in system(10_000, 19, np_dtype, batch=(1024,))[:4]))
            c = check_wide(tag, dtype, es, wide_ops(*fused, (10_000,) * 1024), seed=20)
            check_thomas(tag, dtype, es, (c.red_dl, c.red_d, c.red_du, c.red_b), wide=True,
                         reps=5, plain_reps=1, plain_warmup=1)
            del fused, c
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

    # The dependent-chain floor of every Thomas row: 2n steps at the per-step
    # time of one system of 4096 rows (B = 1), measured above in this run.
    step_ms = {tag: row["ms"] / (2 * tn) for row, tag, tn in chains
               if row["name"] == f"thomas/{tag}/B=1,n=4096"}
    for row, tag, tn in chains:
        row["chain_floor_ms"] = 2 * tn * step_ms[tag]
        log(f"  {row['name']}: chain_floor_ms={row['chain_floor_ms']:.4f} "
            f"ms/chain_floor={row['ms'] / row['chain_floor_ms']:.3f}")
    return rows


# --------------------------------------------------------------------- main --
def main_phase(dev: torch.device) -> Dict[str, int]:
    from repro_torch.api import HeuristicChunkPolicy, SolveRequest, SolverConfig, TridiagSession
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator
    from repro_torch.kernels import LAUNCH_COUNTERS
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

    for c in LAUNCH_COUNTERS.values():
        c.reset()
    with TridiagSession(cfg) as session:
        assert session.backend.name == "cuda", session.backend
        x, ms = timed(lambda: session.solve(*big[:4]))
        assert x.shape == big[4].shape and np.isfinite(x).all()
        assert_allclose_by_dtype(x, big[4], np.float64)
        log(f"  solve n=1e7 fp64: chunks={session.plan_for(big[4].size).num_chunks} "
            f"latency_ms={ms:.3f} max_err_vs_x_true={max_err(x, big[4]):.3e}")

        x, ms = timed(lambda: session.solve(*mid32[:4]))
        assert x.dtype == np.float32 and np.isfinite(x).all()
        assert_allclose_by_dtype(x, mid32[4], np.float32)
        log(f"  solve n=1e6 fp32: chunks={session.plan_for(mid32[4].size).num_chunks} "
            f"latency_ms={ms:.3f} max_err_vs_x_true={max_err(x, mid32[4]):.3e}")

        # The stacked (K, n) solve runs the batched Stage-1/Stage-3 kernels
        # once per chunk and the reduced solve as 64 systems in one launch.
        x, rose = launches_of(lambda: session.solve(*batched[:4]))
        k = session.plan_for(100_000).num_chunks
        assert rose == {"partition_stage1": k, "thomas": 1, "partition_stage3": k}, (rose, k)
        assert x.shape == (64, 100_000) and np.isfinite(x).all()
        assert_allclose_by_dtype(x, batched[4], np.float64)
        _, ms = timed(lambda: session.solve(*batched[:4]))
        log(f"  solve stacked (64, 100000) fp64: chunks={k} launches={rose} "
            f"latency_ms={ms:.3f} max_err_vs_x_true={max_err(x, batched[4]):.3e}")

        x, ms = timed(lambda: session.solve_batched(*batched[:4]))
        assert x.shape == (64, 100_000) and np.isfinite(x).all()
        assert_allclose_by_dtype(x, batched[4], np.float64)
        log(f"  solve_batched 64x100000 fp64: chunks="
            f"{session.plan_for((100_000,) * 64).num_chunks} latency_ms={ms:.3f} "
            f"max_err_vs_x_true={max_err(x, batched[4]):.3e}")

        xs, ms = timed(lambda: session.solve_many([s[:4] for s in ragged]))
        for xi, s in zip(xs, ragged):
            assert_allclose_by_dtype(xi, s[4], np.float64)
        log(f"  solve_many {ragged_sizes}: chunks={session.plan_for(ragged_sizes).num_chunks} "
            f"latency_ms={ms:.3f} max_err_vs_x_true="
            f"{max(max_err(xi, s[4]) for xi, s in zip(xs, ragged)):.3e}")

    with TridiagSession(cfg.replace(max_batch=16, max_wait_ms=50.0)) as serving:
        t0 = time.perf_counter()
        futs = [serving.submit(SolveRequest(i, *s[:4])) for i, s in enumerate(served)]
        outs = [f.result(timeout=300) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        for xi, s in zip(outs, served):
            assert_allclose_by_dtype(xi, s[4], np.float64)
        batches = serving.stats["per_batch"]
        log(f"  submit x16: batches={len(batches)} chunks={[b['num_chunks'] for b in batches]} "
            f"latency_ms={ms:.3f} max_err_vs_x_true="
            f"{max(max_err(xi, s[4]) for xi, s in zip(outs, served)):.3e}")

    # The chunk count must not change the answer, for one system and for
    # the stacked batch (whose chunks run the batched kernels with halos).
    for label, ops in (("n=1e7", big), ("stacked (64, 100000)", batched)):
        sols = {}
        for k in (1, 8):
            with TridiagSession(cfg.replace(policy=None, num_chunks=k)) as sk:
                sols[k] = sk.solve(*ops[:4])
        diff = max_err(sols[1], sols[8])
        assert_allclose_by_dtype(sols[8], sols[1], np.float64)
        log(f"  solve {label} chunks=1 vs chunks=8: max_abs_diff={diff!r} "
            f"bit_identical={diff == 0.0}")

    # The plain comparison: the same verbs on the card with backend="reference".
    small = system(100_000, 4, np.float64)
    with TridiagSession(cfg) as kern, TridiagSession(cfg.replace(backend="reference")) as plain:
        assert plain.backend.name == "reference"
        a = kern.solve(*small[:4])
        b = plain.solve(*small[:4])
        assert_allclose_by_dtype(a, b, np.float64)
        log(f"  cuda vs reference backend on the card, n=1e5 fp64: max_abs_diff={max_err(a, b):.3e}")

    interleaved_phase(cfg.replace(layout="auto"), timed, batched)
    staged_phase(cfg.replace(layout="auto"), big)

    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    log(f"  launch counts on the main path: {launches}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was never launched on the main path"
    return launches


def launches_of(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """``fn()`` and how many times each kernel launched during it."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    before = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    out = fn()
    return out, {name: c.count - before[name] for name, c in LAUNCH_COUNTERS.items() if c.count > before[name]}


WIDE_ONCE = {"partition_stage1_wide": 1, "thomas_wide": 1, "partition_stage3_wide": 1}


def interleaved_phase(cfg: Any, timed: Callable[..., Tuple[Any, float]],
                      batched: Tuple[np.ndarray, ...]) -> None:
    """The verbs that ``layout="auto"`` interleaves, at the paper's sizes."""
    from repro_torch.api import SolveRequest, TridiagSession
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
            x, rose = launches_of(lambda: session.solve_batched(*ops[:4]))
            assert rose == WIDE_ONCE, (label, rose)
            assert x.shape == (bsz, n) and x.dtype == np_dtype and np.isfinite(x).all()
            assert_allclose_by_dtype(x, ops[4], np_dtype)
            _, ms = timed(lambda: session.solve_batched(*ops[:4]))
            log(f"  solve_batched {label} layout=interleaved: launches={rose} latency_ms={ms:.3f} "
                f"max_err_vs_x_true={max_err(x, ops[4]):.3e}")

        plan = session.plan_for(RAGGED_48)
        assert session._fused.resolved_layout(plan) == "interleaved"
        xs, rose = launches_of(lambda: session.solve_many([s[:4] for s in many]))
        assert rose == WIDE_ONCE, rose
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
            f"latency_ms={ms:.3f} max_err_vs_x_true="
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


# ---------------------------------------------------------------- breakdown --
def breakdown_phase(dev: torch.device) -> None:
    from repro_torch.api import HeuristicChunkPolicy
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator
    from repro_torch.core.tridiag.plan import CudaBackend, _fused, build_plan
    from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda
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
        f"reduced_thomas_ms={s2:.3f} stage3_ms={s3:.3f} d2h_ms={d2h:.3f} "
        f"fused_device_ms={fused:.3f} (h2d+fused+d2h={total:.3f}); "
        f"reduced solve share of fused={s2 / fused:.3f}")
    del host, ops, c, red, s, x
    interleaved_breakdown(dev)


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
    s3 = cuda_ms(lambda: partition_stage3_cuda_wide(c, s), reps=5)
    xw = partition_stage3_cuda_wide(c, s)
    scatter = cuda_ms(lambda: layout.deinterleave(xw, sizes, M), reps=5)
    x = layout.deinterleave(xw, sizes, M)
    d2h = host_ms(lambda: x.cpu())
    device = cuda_ms(lambda: _fused_interleaved(plan, CudaBackend(), *fused), reps=5)
    log(f"  solve_batched 1024x10000 fp64 interleaved: h2d_ms={h2d:.3f} fuse_ms={fuse:.3f} "
        f"interleave_ms={gather:.3f} stage1_wide_ms={s1:.3f} thomas_wide_ms={s2:.3f} "
        f"stage3_wide_ms={s3:.3f} deinterleave_ms={scatter:.3f} d2h_ms={d2h:.3f} "
        f"interleaved_device_ms={device:.3f} (h2d+fuse+device+d2h={h2d + fuse + device + d2h:.3f}); "
        f"wide Thomas share of device={s2 / device:.3f}")


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
        rows = kernel_phase(dev)
    # Launch counts come from the main phase alone; without it they are
    # not measured.
    launches: Dict[str, Any] = {name: None for name in LAUNCH_COUNTERS}
    if "main" in phases:
        log("main: TridiagSession(device='cuda', backend='auto', heuristic policy)")
        launches = main_phase(dev)
    if "breakdown" in phases:
        log("breakdown: where one n=1e7 fp64 solve and one interleaved 1024x10000 "
            "solve_batched spend their time (CUDA events)")
        breakdown_phase(dev)

    for row in rows:
        row["launches"] = launches[row["name"].split("/")[0]]
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
