"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU.

- The arithmetic copied from the reference gives the same numbers for all
  ten configs and four shapes: ``analytic_hbm_bytes``, ``model_flops_for``,
  ``applicable`` and ``probe_plan`` (the variants' layer fields and the
  coefficient rows).
- A 128³ matmul counts 2·128³ FLOPs and a useful ratio of 1, as the
  reference's ``analyze_compiled`` gives for the same matmul.
- The bytes mode's rules (in place, views, ``_foreach_*``, allocations,
  indexed reads and writes) and the peak of live storages.
- Each collective primitive reports its payload (the larger of operand and
  result) on a fake 4-rank world, as ``tests/test_roofline.py`` holds the
  HLO parser to hand-computed payloads.
- The collective term's links: a 16-rank ``model`` group of the (16, 16)
  mesh crosses nodes, 8 consecutive ranks share NVLink.
- No module of the port imports ``torch.testing._internal``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import applicable as ref_applicable
from repro.roofline.analysis import analytic_hbm_bytes as ref_analytic_hbm_bytes
from repro.roofline.analysis import analyze_compiled
from repro.roofline.analysis import model_flops_for as ref_model_flops_for
from repro.roofline.probe import probe_plan as ref_probe_plan
from repro_torch.configs.base import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.parallel import collectives as C
from repro_torch.roofline import HW_H100, CollectiveTally, StepCounts, analyze_step, count_step
from repro_torch.roofline.analysis import analytic_hbm_bytes, link_of, model_flops_for
from repro_torch.roofline.probe import probe_plan

ARCHS = list(list_archs())
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


# ------------------------------------------------------------- parity -------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_hbm_bytes_is_the_references(arch, shape):
    cfg, ref = get_config(arch), ref_get_config(arch)
    for kw in ({}, {"remat": False}, {"n_dev": 512, "tp": 16}):
        assert analytic_hbm_bytes(cfg, SHAPES[shape], **kw) == \
            ref_analytic_hbm_bytes(ref, REF_SHAPES[shape], **kw)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_for_is_the_references(arch, shape):
    cfg, ref = get_config(arch), ref_get_config(arch)
    for backward in (True, False):
        assert model_flops_for(cfg, SHAPES[shape], backward=backward) == \
            ref_model_flops_for(ref, REF_SHAPES[shape], backward=backward)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicable_is_the_references(arch, shape):
    assert applicable(get_config(arch), SHAPES[shape]) == \
        ref_applicable(ref_get_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_plan_is_the_references(arch):
    variants, full = probe_plan(get_config(arch))
    ref_variants, ref_full = ref_probe_plan(ref_get_config(arch))
    assert full == ref_full
    assert [row for _, row in variants] == [row for _, row in ref_variants]
    fields = ("num_layers", "enc_layers", "dec_layers", "shared_attn_every")
    for (cfg, _), (ref, _) in zip(variants, ref_variants):
        assert {f: getattr(cfg, f) for f in fields} == {f: getattr(ref, f) for f in fields}
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    rows = np.array([row for _, row in variants], dtype=float)
    assert np.linalg.matrix_rank(rows) == len(full)  # identifiable


# ------------------------------------------------------------ counting ------
def test_matmul_counts_like_the_references_analysis():
    n = 128
    a, b = torch.randn(n, n), torch.randn(n, n)
    with count_step((a, b)) as counts:
        c = a @ b
    terms = analyze_step(counts, model_flops_total=2 * n**3, n_devices=1)
    assert counts.flops == 2 * n**3
    assert terms.useful_ratio == 1.0
    assert counts.bytes == 3 * n * n * 4  # two operands read, the product written
    assert counts.argument_bytes == 2 * n * n * 4 and counts.peak_bytes == 3 * n * n * 4
    assert terms.t_compute_s == 2 * n**3 / HW_H100["peak_flops"]
    assert terms.t_memory_s == 3 * n * n * 4 / HW_H100["hbm_bw"]
    assert terms.collective_bytes_per_device == 0 and terms.t_collective_s == 0
    compiled = jax.jit(lambda x, y: x @ y).lower(jnp.ones((n, n)), jnp.ones((n, n))).compile()
    ref = analyze_compiled(compiled, model_flops_total=2 * n**3, n_devices=1)
    assert ref.flops_per_device == counts.flops
    assert ref.useful_ratio == terms.useful_ratio
    assert set(ref.to_dict()) <= set(terms.to_dict())
    del c


def test_bytes_mode_rules():
    x, y = torch.ones(1000), torch.ones(1000)
    with count_step() as c:
        x.add_(1.0)
    assert c.bytes == 8000  # in place: a read and a write
    with count_step() as c:
        x.view(10, 100).t()
    assert c.bytes == 0  # views
    with count_step() as c:
        torch._foreach_add_([x, y], 1.0)
    assert c.bytes == 2 * 8000  # every tensor of the list, read and written
    with count_step() as c:
        z = torch.empty(1000)
    assert c.bytes == 0 and c.peak_bytes == 4000  # allocated, not written
    with count_step() as c:
        torch.zeros(()).expand(1000).sum()
    assert c.bytes == 4 + 4 + 4  # the zero written, its broadcast read once, the sum
    del z


def test_indexed_ops_move_the_rows_they_touch():
    cache = torch.zeros(2, 1000, 64)              # 512,000 B
    new = torch.ones(2, 1, 64)                    # 512 B
    bidx, rows = torch.arange(2)[:, None], torch.tensor([[3], [999]])
    with count_step() as c:
        cache[bidx, rows] = new                   # one row a sequence
    assert c.bytes == 16 + 16 + 512 + 512         # indices, values read; 2 rows written
    with count_step() as c:
        cache.index_put_((bidx, rows), new, accumulate=True)
    assert c.bytes == 16 + 16 + 512 + 2 * 512     # the rows read too
    table, tokens = torch.ones(1000, 64), torch.tensor([[1, 5, 7]])
    for lookup in (lambda: table[tokens], lambda: torch.nn.functional.embedding(tokens, table),
                   lambda: table.index_select(0, tokens[0])):
        with count_step() as c:
            lookup()
        assert c.bytes == 24 + 3 * 256 + 3 * 256  # indices, 3 rows read, 3 rows written
    index, src = torch.tensor([[0, 2], [1, 0]]), torch.zeros(3, 64)
    with count_step() as c:
        torch.gather(table, 1, index)
    assert c.bytes == 32 + 4 * 4 + 4 * 4
    with count_step() as c:
        table.index_copy_(0, tokens[0], src)
    assert c.bytes == 24 + 768 + 768
    with count_step() as c:
        table.index_add_(0, tokens[0], src)
    assert c.bytes == 24 + 768 + 768 + 768        # the target rows read too
    counts, ones = torch.zeros(8), torch.ones(3)
    at, at2 = torch.tensor([1, 1, 3]), torch.tensor([1, 3])
    with count_step() as c:
        counts.scatter_add_(0, at, ones)
    assert c.bytes == 24 + 12 + 12 + 12
    with count_step() as c:
        counts.scatter_(0, at2, 2.0)
    assert c.bytes == 16 + 8


def test_peak_counts_a_storage_once_and_frees_it():
    with count_step() as c:
        a = torch.ones(1000)          # 4000 live
        v = a[10:20] * 1              # + 40
        w = a[:500]                   # a view: nothing new
        del a                         # the view keeps the storage
        b = torch.ones(2000)          # + 8000: 12040
        del w, b                      # 40
        d = torch.ones(3000)          # + 12000: 12040 again
    assert c.peak_bytes == 12040
    assert c.output_bytes == 40 + 12000
    del v, d


def test_a_kernel_without_formula_raises_under_a_count():
    from repro_torch.roofline import counting

    counting.check_launch("thomas")  # no count: nothing to charge
    with count_step():
        counting.check_launch("ssd_stage1")
        with pytest.raises(RuntimeError, match="'thomas'.*no FLOP and byte formula"):
            counting.check_launch("thomas")


def test_ssd_formulas_are_charged_once_on_the_plain_route():
    from repro_torch.kernels.ssd_stage1.ops import (
        SSDStage1Function,
        ssd_stage1_bwd_cost,
        ssd_stage1_cost,
    )

    g, q, nh, p, n = 2, 8, 3, 4, 5
    gen = torch.Generator().manual_seed(0)
    u = torch.randn(g, q, nh, p, generator=gen, requires_grad=True)
    dac = -torch.rand(g, q, nh, generator=gen)
    b, c = torch.randn(g, q, n, generator=gen), torch.randn(g, q, n, generator=gen)
    with count_step() as counts:
        y, s = SSDStage1Function.apply(u, dac, b, c)
        torch.autograd.grad(y.sum() + s.sum(), [u])
    assert counts.flops_by_op["repro_torch.ssd_stage1"] == 2 * ssd_stage1_cost(g, q, nh, p, n)[1]
    assert counts.flops_by_op["repro_torch.ssd_stage1_bwd"] == \
        2 * ssd_stage1_bwd_cost(g, q, nh, p, n)[1]
    # The plain version's einsums are not counted beside the formulas.
    assert set(counts.flops_by_op) == {"repro_torch.ssd_stage1", "repro_torch.ssd_stage1_bwd"}
    # mamba2-1.3b's backward at G = 16: 17.6 GFLOP (PERF.md §6, row 7b).
    assert round(2 * ssd_stage1_bwd_cost(16, 256, 64, 64, 128)[1] / 1e9, 1) == 17.6


# ---------------------------------------------------------- collectives -----
def _payloads(fn):
    """Bytes and calls by op that ``fn(group)`` reports on a fake 4-rank world."""
    tally = CollectiveTally()
    with fake_world(4):
        group = dist.new_group([0, 1, 2, 3])
        with C.tallied(tally):
            fn(group)
    total, by_op, calls = tally.collective_bytes()
    assert total == sum(by_op.values())
    return by_op, calls


T = torch.ones(8, 6)  # 192 bytes; 4 ranks
PRIMITIVES = {
    "all_reduce_": (lambda g: C.all_reduce_(T.clone(), g), {"all-reduce": 192}, {"all-reduce": 1}),
    "gather_tensor": (lambda g: C.gather_tensor(T, g, 0), {"all-gather": 768}, {"all-gather": 1}),
    "scatter_sum": (lambda g: C.scatter_sum(T, g, 0), {"reduce-scatter": 192},
                    {"reduce-scatter": 1}),
    "copy_to": (lambda g: _fwd_bwd(C.copy_to, g), {"all-reduce": 192}, {"all-reduce": 1}),
    "reduce_from": (lambda g: _fwd_bwd(C.reduce_from, g), {"all-reduce": 192}, {"all-reduce": 1}),
    "all_gather": (lambda g: _fwd_bwd(lambda x, gr: C.all_gather(x, gr, 0), g),
                   {"all-gather": 768, "reduce-scatter": 768},
                   {"all-gather": 1, "reduce-scatter": 1}),
    "all_gather_slice_back": (
        lambda g: _fwd_bwd(lambda x, gr: C.all_gather(x, gr, 0, scatter_back=False), g),
        {"all-gather": 768}, {"all-gather": 1}),
    "reduce_scatter": (lambda g: _fwd_bwd(lambda x, gr: C.reduce_scatter(x, gr, 0), g),
                       {"reduce-scatter": 192, "all-gather": 192},
                       {"reduce-scatter": 1, "all-gather": 1}),
    "split": (lambda g: _fwd_bwd(lambda x, gr: C.split(x, gr, 0), g), {"all-gather": 192},
              {"all-gather": 1}),
    # int8 payload [2, 4, 3] gathered along 1 (4 · 24 B) and its scales
    # [1, 2] fp32 (4 · 8 B); backward: the fp32 gradient [2, 16, 3].
    "int8_all_gather": (lambda g: _fwd_bwd(lambda x, gr: C.int8_all_gather(x, gr, 1), g,
                                           torch.ones(2, 4, 3)),
                        {"all-gather": 96 + 32, "reduce-scatter": 384},
                        {"all-gather": 2, "reduce-scatter": 1}),
    # one bucket: one flat buffer a dtype (192 B fp32, 10 B bf16)
    "bucketed_all_reduce": (lambda g: _bucketed(g), {"all-reduce": 202}, {"all-reduce": 2}),
    "measure_link": (lambda g: C.measure_link(g, torch.device("cpu")), {}, {}),
}


def _fwd_bwd(prim, group, x=None):
    x = (T.clone() if x is None else x).requires_grad_()
    out = prim(x, group)
    torch.autograd.grad(out.sum(), [x])


def _bucketed(group):
    like = {"a": torch.ones(8, 6), "b": torch.ones(5, dtype=torch.bfloat16)}
    reduce = C.BucketedAllReduce(like, group, 1)
    reduce.add("a", torch.ones(8, 6))
    reduce.add("b", torch.ones(5, dtype=torch.bfloat16))
    reduce.result()


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_each_primitive_reports_its_payload(name):
    fn, by_op, calls = PRIMITIVES[name]
    assert _payloads(fn) == (by_op, calls)


def test_nothing_is_reported_without_a_tally_or_with_one_rank():
    assert C._TALLIES == []
    tally = CollectiveTally()
    with C.tallied(tally):
        C.all_reduce_(T.clone(), None)
        C.gather_tensor(T, None, 0)
    assert tally.collective_bytes() == (0, {}, {})


# ---------------------------------------------------------------- links -----
def test_the_collective_term_charges_the_slowest_link():
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        pctx = make_ctx(mesh)
        model_ranks = dist.get_process_group_ranks(pctx.model_group)
        data_ranks = dist.get_process_group_ranks(pctx.group(pctx.batch_axes))
        node = dist.new_group(list(range(8)))
        tally = CollectiveTally()
        tally.add("all-reduce", pctx.model_group, 1000)
        tally.add("all-gather", pctx.group(pctx.batch_axes), 3000)
        tally.add("all-reduce", node, 9000)
    assert model_ranks == list(range(16))  # 16 consecutive ranks: two nodes
    assert data_ranks == list(range(0, 256, 16))
    assert link_of(model_ranks) == "network" and link_of(data_ranks) == "network"
    assert link_of(range(8)) == "nvlink" and link_of(range(8, 16)) == "nvlink"
    assert link_of(range(4, 12)) == "network"
    terms = analyze_step(StepCounts(collectives=tally), model_flops_total=0, n_devices=256)
    assert terms.collective_by_link == {"network": 4000, "nvlink": 9000}
    assert terms.collective_by_group_size == {16: 4000, 8: 9000}
    assert terms.t_collective_s == 4000 / 50e9 + 9000 / 450e9
    assert terms.collective_by_op == {"all-reduce": 10000, "all-gather": 3000}
    assert terms.collective_counts == {"all-reduce": 2, "all-gather": 1}


def test_fake_world_refuses_an_initialised_group():
    with fake_world(1):
        with pytest.raises(RuntimeError, match="repro_fake.*backend 'repro_fake'"):
            with fake_world(1):
                pass
    assert not dist.is_initialized()


# -------------------------------------------------------------- imports -----
@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_port_imports_no_torch_testing_internal(path):
    assert "testing._internal" not in path.read_text()
