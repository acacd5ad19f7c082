"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (what CI on the card runs)
    python3 chip_smoke.py --phases build,kernels

Phases:

1. ``build``: compile the three CUDA sources in ``src/repro_torch/csrc``
   (one nvcc each, all at once) and print ptxas's register report.
2. ``kernels``: each kernel against its plain PyTorch version (the
   reference stage) on the card, in fp64 and fp32, at shapes the main path
   gives it, the batched Stage 1/Stage 3 included; max error against
   the tolerance ladder (fp64 1e-12, fp32 1e-5), median time from CUDA
   events, the plain version's time and the bound (bytes over 3.35 TB/s or
   operations over the peak rate, whichever is larger).
3. ``main``: the port's main path through ``TridiagSession`` on
   ``device="cuda"``, ``backend="auto"`` and the fitted Eq. 4-7 heuristic:
   ``solve`` at n = 1e7 (fp64) and 1e6 (fp32), ``solve_batched`` at
   64 x 100,000, ``solve_many`` on a ragged mix of paper sizes and 16
   ``submit`` futures, each checked against ``x_true``, and ``solve`` on the
   stacked (64, 100,000) operands, which runs the batched kernels; ``solve``
   at n = 1e7 and on the stacked operands with 1 and 8 chunks must agree;
   every kernel's launch counter must rise;
   a ``backend="reference"`` session on the card is the plain comparison.
4. ``breakdown``: where the time of one n = 1e7 fp64 solve goes, stage by
   stage, from CUDA events.

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
    from repro_torch.core.tridiag.partition import partition_stage1, partition_stage3
    from repro_torch.core.tridiag.thomas import thomas
    from repro_torch.kernels.common import assert_allclose_by_dtype
    from repro_torch.kernels.partition_stage1.ops import (
        partition_stage1_cuda,
        partition_stage1_cuda_batched,
    )
    from repro_torch.kernels.partition_stage3.ops import (
        partition_stage3_cuda,
        partition_stage3_cuda_batched,
    )
    from repro_torch.kernels.thomas.ops import thomas_cuda

    sources = {
        "partition_stage1": ("src/repro_torch/csrc/partition_stage1.cu",
                             "src/repro/kernels/partition_stage1/stage1.py:28"),
        "partition_stage3": ("src/repro_torch/csrc/partition_stage3.cu",
                             "src/repro/kernels/partition_stage3/stage3.py:17"),
        "thomas": ("src/repro_torch/csrc/thomas.cu", "src/repro/kernels/thomas/thomas.py:22"),
    }
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
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
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
                     **kw: Any) -> None:
        bsz, tn = (1, ops4[1].shape[0]) if ops4[1].ndim == 1 else tuple(ops4[1].shape)
        _, ms = check(f"thomas/{tag}/B={bsz},n={tn}", dtype, lambda: thomas_cuda(*ops4),
                      lambda: thomas(*ops4), 5 * bsz * tn * es, 8 * bsz * tn, **kw)
        # The bytes/operations bound misses what limits this kernel: each
        # system is a chain of 2n dependent division steps on one thread.
        log(f"    serial chain: {2 * tn} dependent steps per system, "
            f"{ms * 1e6 / (2 * tn):.1f} ns per step measured")

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

        # Thomas on a batch of 256 and on one system at n = 4096.
        for tb in (256, 1):
            ops_np = system(4096, 13 + tb, np_dtype, batch=(tb,) if tb > 1 else ())
            check_thomas(tag, dtype, es, tuple(torch.as_tensor(a, device=dev) for a in ops_np[:4]),
                         plain_reps=2, plain_warmup=1)
    return rows


# --------------------------------------------------------------------- main --
def main_phase(dev: torch.device) -> Dict[str, int]:
    from repro_torch.api import HeuristicChunkPolicy, SolveRequest, SolverConfig, TridiagSession
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.common import assert_allclose_by_dtype

    heuristic = fit_stream_heuristic(StreamSimulator(seed=1).dataset(reps=2))
    cfg = SolverConfig(m=M, device="cuda", backend="auto", policy=HeuristicChunkPolicy(heuristic))

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
        before = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
        x = session.solve(*batched[:4])
        k = session.plan_for(100_000).num_chunks
        rose = {name: c.count - before[name] for name, c in LAUNCH_COUNTERS.items()}
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

    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    log(f"  launch counts on the main path: {launches}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was never launched on the main path"

    # The plain comparison: the same verbs on the card with backend="reference".
    small = system(100_000, 4, np.float64)
    with TridiagSession(cfg) as kern, TridiagSession(cfg.replace(backend="reference")) as plain:
        assert plain.backend.name == "reference"
        a = kern.solve(*small[:4])
        b = plain.solve(*small[:4])
        assert_allclose_by_dtype(a, b, np.float64)
        log(f"  cuda vs reference backend on the card, n=1e5 fp64: max_abs_diff={max_err(a, b):.3e}")
    return launches


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
        log("breakdown: where one n=1e7 fp64 solve spends its time (CUDA events)")
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
