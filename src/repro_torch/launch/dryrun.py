"""Multi-pod dry run of the port, the counterpart of ``repro.launch.dryrun``.

For every (architecture × input shape × mesh) cell, one rank of the
production mesh runs its step (a train step with its optimizer, a prefill or
a decode step) on fake tensors, as one rank of a 256- or 512-rank world that
does not exist:

  fake process group (``torch.distributed``'s ``FakeProcessGroup``, through
  a backend registered here) → ``make_production_mesh`` → ``make_ctx`` →
  ``init_local`` / ``init_train_state`` under ``FakeTensorMode`` → the step
  under ``repro_torch.roofline.counting.count_step`` → three-term roofline
  (``analyze_step``) → JSON record.

"Lower" in the reference's names now means "count on fake tensors": no
tensor memory is ever allocated, and nothing runs on a device. The counts
are the port's own: its explicit SPMD code's FLOPs, the bytes its eager ops
move, its collectives and the live bytes a rank holds at its peak.

Tensors are faked on the card (``--device cuda``, the default) unless
``--device cpu`` is passed. A fake CUDA tensor's backward needs a CUDA
build of torch: on a CPU build ``cuda`` raises, naming ``--device cpu``.

Usage (add ``--device cpu`` on a host whose torch has no CUDA):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
      --out results/dryrun.json        # incremental: completed cells skipped
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --probe \\
      --out results/probe.json         # layer-count probes (roofline/probe.py)
  # one rank at a custom size (the card's real step is held against it):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \\
      --shape train_4k --batch 4 --seq 1024 --mesh one --remat none
  # kimi-k2 at full width cut to one layer:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
      --shape prefill_32k --batch 4 --seq 1024 --mesh one --layers 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, input_specs, synthesize_batch
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.optim import adafactor, adamw
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import batch_is_sharded, init_local
from repro_torch.roofline.analysis import HW_H100, analyze_step, model_flops_for
from repro_torch.roofline.counting import StepCounts, count_step
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.step import init_train_state, make_train_step

# Optimizer choice: Adafactor above this size so optimizer state doesn't
# triple the per-chip footprint (the reference's threshold).
ADAFACTOR_THRESHOLD = 100e9
#: The backend name the fake process group is registered under.
FAKE_BACKEND = "repro_fake"
#: Mesh names → world size (``"1"``: one rank, no mesh).
MESH_RANKS = {"16x16": 256, "2x16x16": 512, "1": 1}
_MESH_NAMES = {"single": ["16x16"], "multi": ["2x16x16"], "both": ["16x16", "2x16x16"],
               "one": ["1"]}


def pick_optimizer(cfg: ArchConfig) -> Tuple[Any, str]:
    if cfg.param_count() > ADAFACTOR_THRESHOLD:
        return adafactor(1e-4), "adafactor"
    return adamw(3e-4), "adamw"


def _create_fake_pg(common_opts: Any, backend_opts: Any) -> Any:
    from torch._C._distributed_c10d import FakeProcessGroup

    if hasattr(FakeProcessGroup, "_create_internal"):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)
    return FakeProcessGroup(common_opts.group_rank, common_opts.group_size)


def register_fake_backend() -> None:
    """Register ``FAKE_BACKEND``: ``torch.distributed``'s ``FakeProcessGroup``,
    which hallucinates every collective (no peer, no data moved). Raises,
    naming torch's version, where this torch cannot register it."""
    if FAKE_BACKEND.upper() in dist.Backend.__dict__:
        return
    try:
        dist.Backend.register_backend(FAKE_BACKEND, _create_fake_pg, extended_api=True,
                                      devices=["cpu", "cuda"])
    except (AttributeError, TypeError, ValueError, ImportError) as e:
        raise RuntimeError(f"torch {torch.__version__} cannot register the fake process group "
                           f"backend {FAKE_BACKEND!r}: {type(e).__name__}: {e}") from e


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """The default process group of this process: rank 0 of a fake world of
    ``world_size`` ranks, destroyed on exit. Refuses, naming the backend,
    when a process group is already initialised (one default group a
    process)."""
    if dist.is_initialized():
        raise RuntimeError(f"the dry run makes its own fake process group ({FAKE_BACKEND!r}); "
                           f"this process already has one (backend {dist.get_backend()!r}, "
                           f"world size {dist.get_world_size()})")
    register_fake_backend()
    dist.init_process_group(FAKE_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_device(device: str = "cuda") -> torch.device:
    """Where the tensors are faked: ``"cuda"`` (the first card) or ``"cpu"``."""
    if device == "cuda":
        if torch.version.cuda is None:
            raise RuntimeError(f"fake CUDA tensors need a CUDA build of torch (this is "
                               f"{torch.__version__}); pass --device cpu (device=\"cpu\")")
        return torch.device("cuda", 0)
    if device != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    return torch.device("cpu")


def _fake_like(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A tensor of ``t``'s shape, strides and dtype on ``dev`` (a fake one
    under ``FakeTensorMode``)."""
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()), dtype=t.dtype, device=dev)


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_map_tensors(v, fn) for v in tree))
    return tree


def _move_module(module: torch.nn.Module, dev: torch.device) -> None:
    """Every parameter and buffer of ``module`` replaced by one of its shape
    on ``dev`` (fake tensors cannot be copied across devices on a CPU build)."""
    for mod in module.modules():
        for k, t in list(mod._parameters.items()):
            if t is not None:
                mod._parameters[k] = torch.nn.Parameter(_fake_like(t, dev),
                                                        requires_grad=t.requires_grad)
        for k, b in list(mod._buffers.items()):
            if b is not None:
                mod._buffers[k] = _fake_like(b, dev)


def _mesh_name(multi_pod: Optional[bool]) -> str:
    return "1" if multi_pod is None else ("2x16x16" if multi_pod else "16x16")


@dataclasses.dataclass
class Cell:
    """One rank's step of a cell, ready to run: ``run()`` takes the step
    once; ``arguments`` are the tensors it reads that live before it (this
    rank's parameters, optimizer state, inputs and caches)."""
    run: Callable[[], Any]
    arguments: Any
    optimizer: Optional[str] = None


def prepare_cell(cfg: ArchConfig, shape: ShapeSpec, pctx: ParallelCtx, dev: torch.device, *,
                 fake: bool, microbatches: int = 1, seed: int = 0,
                 optimizer_of: Optional[ArchConfig] = None) -> Cell:
    """This rank's state and inputs for one step of ``shape`` on ``dev``.
    ``fake``: under a ``FakeTensorMode`` the caller entered (parameters drawn
    on the CPU, a fake draw, and laid on ``dev``; inputs of
    ``input_specs``' shapes); else real tensors, weights from ``seed`` and
    inputs from ``synthesize_batch``. The optimizer is picked by the size
    of ``optimizer_of`` (default ``cfg``): a probe's reduced variant trains
    with its full config's optimizer."""
    model = build_model(cfg)
    max_dec_len = shape.seq_len if cfg.family == "encdec" else 4096
    params = init_local(model, seed, cfg, pctx, device="cpu" if fake else dev,
                        max_dec_len=max_dec_len)
    if fake and dev.type != "cpu":
        _move_module(params, dev)
    specs = input_specs(cfg, shape)
    inputs = (_map_tensors(specs, lambda t: _fake_like(t, dev)) if fake
              else synthesize_batch(cfg, shape, seed, device=dev))
    if shape.kind == "train":
        optimizer, opt_name = pick_optimizer(optimizer_of or cfg)
        state = init_train_state(model, cfg, optimizer, seed, params=params,
                                 max_dec_len=max_dec_len)
        step_fn = make_train_step(model, cfg, pctx, optimizer, microbatches=microbatches)
        return Cell(lambda: step_fn(state, inputs),
                    (list(state.params.parameters()), state.opt_state, inputs), opt_name)
    if shape.kind == "prefill":
        prefill_fn = make_prefill_step(model, cfg, pctx, max_len=shape.seq_len)
        return Cell(lambda: prefill_fn(params, inputs), (list(params.parameters()), inputs))
    # decode: this rank's caches, the global token and positions
    b = shape.global_batch
    caches = model.make_caches(b, shape.seq_len, device="meta", pctx=pctx)
    if cfg.family == "encdec":
        caches = dict(caches)
        rows = b // pctx.dp if batch_is_sharded(b, pctx) else b  # this rank's
        caches["enc_out"] = specs["caches"]["enc_out"][:rows].contiguous()
    caches = _map_tensors(caches, (lambda t: _fake_like(t, dev)) if fake else
                          (lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev)))
    token, pos = inputs["token"], inputs["pos"]
    decode_fn = make_decode_step(model, cfg, pctx)
    return Cell(lambda: decode_fn(params, caches, token, pos),
                (list(params.parameters()), caches, token, pos))


def make_pctx(shape: ShapeSpec, multi_pod: Optional[bool], *, remat: str = "full",
              strategy: str = "tp", pctx_overrides: Optional[Dict[str, Any]] = None
              ) -> ParallelCtx:
    """The cell's context: ``make_production_mesh`` and ``make_ctx``
    (``seq_shard`` for ``long_500k``; ``remat`` for training only), or one
    rank without a mesh (``multi_pod=None``)."""
    cell_remat = remat if shape.kind == "train" else "none"
    if multi_pod is None:
        pctx = ParallelCtx(mesh=None, remat=cell_remat)
    else:
        # The fake world's groups carry no data, so the mesh's device type
        # decides nothing; "cpu" keeps init_device_mesh off the card.
        mesh = make_production_mesh(device_type="cpu", multi_pod=multi_pod)
        pctx = make_ctx(mesh, seq_shard=shape.name == "long_500k", remat=cell_remat,
                        strategy=strategy)
    if pctx_overrides:
        pctx = dataclasses.replace(pctx, **pctx_overrides)
    return pctx


def lower_cell(arch: str, shape_name: str, multi_pod: Optional[bool], *,
               remat: str = "full", microbatches: int = 1,
               cfg_override: Optional[ArchConfig] = None,
               shape_override: Optional[ShapeSpec] = None,
               strategy: str = "tp", pctx_overrides: Optional[Dict[str, Any]] = None,
               device: str = "cuda", optimizer_of: Optional[ArchConfig] = None,
               ) -> Tuple[Dict[str, Any], Optional[StepCounts]]:
    """Count one cell on fake tensors ("lower" in the reference); returns
    (record, counts). ``multi_pod``: the (2, 16, 16) mesh, the (16, 16) one,
    or ``None`` for one rank without a mesh. The default process group must
    have the mesh's ranks (:func:`fake_world`)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape_override if shape_override is not None else SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}, None

    dev = fake_device(device)
    pctx = make_pctx(shape, multi_pod, remat=remat, strategy=strategy,
                     pctx_overrides=pctx_overrides)
    n_devices = 1 if pctx.mesh is None else pctx.mesh.size()
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "status": "ok",
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "device": str(dev),
    }
    if shape_override is not None:
        record.update(global_batch=shape.global_batch, seq_len=shape.seq_len)

    t0 = time.time()
    with FakeTensorMode():
        cell = prepare_cell(cfg, shape, pctx, dev, fake=True, microbatches=microbatches,
                            optimizer_of=optimizer_of)
        if cell.optimizer is not None:
            record["optimizer"] = cell.optimizer
        record["lower_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        with count_step(cell.arguments) as counts:
            out = cell.run()
        del out, cell
        record["compile_s"] = round(time.time() - t1, 2)

    terms = analyze_step(
        counts,
        model_flops_total=model_flops_for(cfg, shape, backward=shape.kind == "train"),
        n_devices=n_devices,
    )
    record["roofline"] = terms.to_dict()
    record["argument_bytes"] = counts.argument_bytes
    record["peak_bytes"] = counts.peak_bytes
    record["fits_h100_80gb"] = counts.peak_bytes <= HW_H100["hbm_bytes"]
    return record, counts


def lower_cell_cfg(cfg: ArchConfig, shape_name: str, multi_pod: Optional[bool],
                   **kw: Any) -> Optional[StepCounts]:
    """Probe entry: count an explicit (possibly reduced) config; returns its
    counts (``None`` for a skipped cell)."""
    _, counts = lower_cell(cfg.arch_id, shape_name, multi_pod, cfg_override=cfg, **kw)
    return counts


def _summary(record: Dict[str, Any]) -> str:
    if record.get("status") != "ok":
        return ""
    r = record["roofline"]
    return (f" dominant={r['dominant']} tc={r['t_compute_s']:.4f}s tm={r['t_memory_s']:.4f}s"
            f" tx={r['t_collective_s']:.4f}s useful={r['useful_ratio']:.2f}"
            f" peak={record['peak_bytes'] / 1e9:.2f}GB")


def _load(out_path: Optional[str]) -> Dict[str, Any]:
    if out_path and Path(out_path).exists():
        return json.loads(Path(out_path).read_text())
    return {}


def _save(results: Dict[str, Any], out_path: Optional[str]) -> None:
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(results, indent=1))


def run_cells(archs: List[str], shapes: List[str], meshes: List[str],
              out_path: Optional[str], *, remat: str = "full", **kw: Any) -> Dict[str, Any]:
    """Count every cell, one fake world a mesh; records by
    ``arch|shape|mesh``, written to ``out_path`` after each (cells already
    ``ok`` or ``skipped`` there are not counted again)."""
    results = _load(out_path)
    for mesh_name in meshes:
        with fake_world(MESH_RANKS[mesh_name]):
            for arch in archs:
                for shape_name in shapes:
                    key = f"{arch}|{shape_name}|{mesh_name}"
                    if key in results and results[key].get("status") in ("ok", "skipped"):
                        print(f"[cached] {key}", flush=True)
                        continue
                    print(f"[lowering] {key}", flush=True)
                    multi_pod = None if mesh_name == "1" else mesh_name == "2x16x16"
                    try:
                        record, _ = lower_cell(arch, shape_name, multi_pod, remat=remat, **kw)
                    except Exception as e:  # record the failure, keep sweeping
                        record = {
                            "arch": arch, "shape": shape_name, "mesh": mesh_name,
                            "status": "error", "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-2000:],
                        }
                        print(f"[ERROR] {key}: {e}", flush=True)
                    results[key] = record
                    _save(results, out_path)
                    print(f"[done] {key}: {record.get('status')}{_summary(record)}", flush=True)
    return results


def run_probes(archs: List[str], shapes: List[str], out_path: Optional[str], *,
               multi_pod: bool = False, **kw: Any) -> Dict[str, Any]:
    """Layer-count probes (``roofline/probe.py``), by ``arch|shape`` (the
    single-pod mesh, as the reference; ``multi_pod`` for the other)."""
    from repro_torch.roofline.probe import probe_cell

    results = _load(out_path)
    with fake_world(MESH_RANKS["2x16x16" if multi_pod else "16x16"]):
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}|{shape_name}"
                if key in results and results[key].get("status") in ("ok", "skipped"):
                    print(f"[cached] {key}", flush=True)
                    continue
                print(f"[probing] {key}", flush=True)
                try:
                    rec = probe_cell(arch, shape_name, multi_pod=multi_pod, **kw)
                except Exception as e:
                    rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[ERROR] {key}: {e}", flush=True)
                results[key] = rec
                _save(results, out_path)
                if rec.get("status") == "ok":
                    print(f"[done] {key}: flops={rec['flops']:.3e} bytes={rec['bytes']:.3e} "
                          f"cbytes={rec['cbytes']:.3e}", flush=True)
                else:
                    print(f"[done] {key}: {rec.get('status')}", flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=list(_MESH_NAMES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--probe", action="store_true",
                    help="layer-count probes (single-pod, or --mesh multi)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the tensors are faked (cpu on a torch without CUDA)")
    ap.add_argument("--batch", type=int, default=None, help="the shape's global batch instead")
    ap.add_argument("--seq", type=int, default=None, help="the shape's sequence length instead")
    ap.add_argument("--layers", type=int, default=None,
                    help="the config cut to this many layers (one --arch)")
    args = ap.parse_args(argv)
    if dist.is_initialized():
        ap.error(f"a process group is already initialised (backend {dist.get_backend()!r}); "
                 f"the dry run makes its own ({FAKE_BACKEND!r})")
    try:
        fake_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    archs = list(list_archs()) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    kw: Dict[str, Any] = {"device": args.device}
    if args.batch is not None or args.seq is not None:
        if len(shapes) != 1:
            ap.error("--batch and --seq take one --shape")
        base = SHAPES[shapes[0]]
        kw["shape_override"] = dataclasses.replace(
            base, global_batch=args.batch or base.global_batch, seq_len=args.seq or base.seq_len)
    if args.layers is not None:
        if len(archs) != 1:
            ap.error("--layers takes one --arch")
        kw["cfg_override"] = dataclasses.replace(get_config(archs[0]), num_layers=args.layers)
    if args.probe:
        if args.mesh not in ("single", "multi"):
            ap.error("--probe takes --mesh single or multi")
        out = args.out if args.out != "results/dryrun.json" else "results/probe.json"
        run_probes(archs, shapes, out, multi_pod=args.mesh == "multi", remat=args.remat, **kw)
        return
    run_cells(archs, shapes, _MESH_NAMES[args.mesh], args.out, remat=args.remat, **kw)


if __name__ == "__main__":
    main()
