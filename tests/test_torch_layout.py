"""The port's interleaved layout against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``repro.core.tridiag.layout`` and
the Pallas wide kernels (interpret mode) and through the port's layout
module, its plain wide stages and its wide kernel wrappers (their plain path
on CPU tensors), then through both packages' executors and sessions; results
are compared at the tolerance ladder, the gathers bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
import jax.numpy as jnp  # noqa: E402

from repro.core.tridiag import layout as jlayout  # noqa: E402
from repro.core.tridiag import plan as jplan  # noqa: E402
from repro.core.tridiag.ragged import fuse_ragged as jax_fuse_ragged  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system, thomas_numpy  # noqa: E402
from repro.kernels.partition_stage1.ops import partition_stage1_pallas_wide  # noqa: E402
from repro.kernels.partition_stage3.ops import partition_stage3_pallas_wide  # noqa: E402
from repro.kernels.thomas.ops import thomas_pallas_wide  # noqa: E402
from repro_torch.api import SolveRequest, SolverConfig, TridiagSession  # noqa: E402
from repro_torch.core.tridiag import layout as tlayout  # noqa: E402
from repro_torch.core.tridiag import plan as tplan  # noqa: E402
from repro_torch.core.tridiag.partition import PartitionCoeffs  # noqa: E402
from repro_torch.core.tridiag.ragged import fuse_ragged, split_ragged  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_wide  # noqa: E402
from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_wide  # noqa: E402
from repro_torch.kernels.thomas.ops import thomas_cuda_wide  # noqa: E402

DTYPES = [np.float32, np.float64]
SHAPES = {
    "uniform": (60,) * 5,
    "ragged": (40, 300, 120, 10, 70),
    "m2": (8, 4, 12),
}


def _systems(sizes, dtype, seed=0):
    return [make_diag_dominant_system(n, seed=seed + i, dtype=dtype) for i, n in enumerate(sizes)]


def _fused(sizes, dtype, seed=0):
    """Fused (Σnᵢ,) numpy operands, zeroed at every system boundary."""
    return jax_fuse_ragged([s[:4] for s in _systems(sizes, dtype, seed)])[:4]


def _m(kind):
    return 2 if kind == "m2" else 10


def _wide(kind, dtype):
    """The JAX package's interleaved operands of one fused batch (numpy)."""
    sizes, m = SHAPES[kind], _m(kind)
    return tuple(np.asarray(a) for a in jlayout.interleave_operands(*_fused(sizes, dtype), sizes, m))


# ------------------------------------------------------------ resolve_layout --
def _waste_sizes(rest):
    # One system of 100 rows sets P_max = 10; 31 more of `rest` rows: 70 →
    # padding 1.41x (under the 1.5 bound), 60 → 1.63x (over it).
    return (100,) + (rest,) * 31


RESOLVE_CASES = [(n,) * b for n in (50, 100) for b in (1, 31, 32, 33)] + [
    _waste_sizes(70),
    _waste_sizes(60),
    (10,) + (1000,) * 40,
]


@pytest.mark.parametrize("batch_shards", [1, 2])
@pytest.mark.parametrize("lead_ndim", [0, 1])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("layout", ["system-major", "interleaved", "auto"])
@pytest.mark.parametrize("sizes", RESOLVE_CASES, ids=lambda s: f"B={len(s)},total={sum(s)}")
def test_resolve_layout_matches_reference(sizes, layout, fused, lead_ndim, batch_shards):
    kw = dict(fused=fused, lead_ndim=lead_ndim, batch_shards=batch_shards)
    try:
        want = jlayout.resolve_layout(layout, sizes, 10, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="interleaved"):
            tlayout.resolve_layout(layout, sizes, 10, **kw)
        return
    assert tlayout.resolve_layout(layout, sizes, 10, **kw) == want


def test_layout_constants_and_bad_arguments_match_reference():
    assert tlayout.LAYOUTS == jlayout.LAYOUTS
    assert tlayout.AUTO_INTERLEAVE_MIN_BATCH == jlayout.AUTO_INTERLEAVE_MIN_BATCH == 32
    assert tlayout.AUTO_INTERLEAVE_MAX_WASTE == jlayout.AUTO_INTERLEAVE_MAX_WASTE == 1.5
    for bad in (dict(layout="lane-major"), dict(batch_shards=0)):
        args = {"layout": "auto", "batch_shards": 1, **bad}
        for mod in (jlayout, tlayout):
            with pytest.raises(ValueError):
                mod.resolve_layout(args["layout"], (10,), 10, fused=True, batch_shards=args["batch_shards"])
    with pytest.raises(ValueError, match="divisible"):
        tlayout.interleave(torch.zeros(25), (25,), 10)


# ------------------------------------------------------- interleave gathers --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_interleave_is_bit_identical_to_reference(kind, dtype):
    sizes, m = SHAPES[kind], _m(kind)
    fused = _fused(sizes, dtype, seed=3)
    want = jlayout.interleave_operands(*fused, sizes, m)
    got = tlayout.interleave_operands(*(torch.from_numpy(a) for a in fused), sizes, m)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.is_contiguous() and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_deinterleave_is_bit_identical_to_reference_and_inverts(kind, dtype):
    sizes, m = SHAPES[kind], _m(kind)
    xw = np.random.default_rng(4).standard_normal((max(sizes) // m, m, len(sizes))).astype(dtype)
    want = np.asarray(jlayout.deinterleave(jnp.asarray(xw), sizes, m))
    got = tlayout.deinterleave(torch.from_numpy(xw), sizes, m)
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.from_numpy(_fused(sizes, dtype)[3])
    torch.testing.assert_close(tlayout.deinterleave(tlayout.interleave(x, sizes, m), sizes, m), x, rtol=0, atol=0)


def test_ragged_padding_forms_identity_blocks():
    sizes, m = SHAPES["ragged"], 10
    dlw, dw, duw, bw = tlayout.interleave_operands(*(torch.from_numpy(a) for a in _fused(sizes, np.float64)), sizes, m)
    short = sizes.index(10)  # one block, padded by 29 identity blocks
    assert torch.all(dw[1:, :, short] == 1) and torch.all(bw[1:, :, short] == 0)
    assert torch.all(dlw[1:, :, short] == 0) and torch.all(duw[:, :, short].flatten()[9:] == 0)


def test_index_maps_match_reference_and_device_copies_are_cached():
    sizes = SHAPES["ragged"]
    for got, want in zip(tlayout._index_maps(sizes, 10), jlayout._index_maps(sizes, 10)[:2]):
        np.testing.assert_array_equal(got, want)
    a = tlayout._device_maps(sizes, 10, torch.device("cpu"))
    assert tlayout._device_maps(sizes, 10, torch.device("cpu")) is a
    assert a[0].shape == (30, 10, 5) and a[1].shape == (sum(sizes),)


# -------------------------------------------------- plain wide stages + wrappers --
def _tensors(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_wide_stage1_matches_pallas(fn, kind, dtype):
    wide, m = _wide(kind, dtype), _m(kind)
    want = partition_stage1_pallas_wide(*(jnp.asarray(a) for a in wide), m=m, block_rows=8, block_b=128)
    stage1 = tlayout.partition_stage1_wide if fn == "plain" else partition_stage1_cuda_wide
    got = stage1(*_tensors(wide), m=m)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == _tensors(wide)[0].dtype
        assert_allclose_by_dtype(g, np.asarray(w), dtype)
    # Zero past each lane's last block: no system couples to the next block row.
    assert torch.all(got.red_du[-1] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,bsz", [(1, 3), (17, 5), (40, 64), (9, 130)])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_wide_thomas_matches_pallas(fn, n, bsz, dtype):
    ops = make_diag_dominant_system(n, seed=n + bsz, batch=(bsz,), dtype=dtype)[:4]
    wide = tuple(np.ascontiguousarray(a.T) for a in ops)  # (n, B)
    want = thomas_pallas_wide(*(jnp.asarray(a) for a in wide), block_b=128)
    solve = tlayout.thomas_wide if fn == "plain" else thomas_cuda_wide
    got = solve(*_tensors(wide))
    assert tuple(got.shape) == (n, bsz)
    assert_allclose_by_dtype(got, np.asarray(want), dtype)
    assert_allclose_by_dtype(got.T, thomas_numpy(*ops), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_wide_stage3_matches_pallas(fn, kind, dtype):
    wide, m = _wide(kind, dtype), _m(kind)
    jc = partition_stage1_pallas_wide(*(jnp.asarray(a) for a in wide), m=m, block_rows=8, block_b=128)
    s = np.random.default_rng(5).standard_normal(jc.red_d.shape).astype(dtype)
    want = partition_stage3_pallas_wide(jc, jnp.asarray(s), block_rows=8, block_b=128)
    stage3 = tlayout.partition_stage3_wide if fn == "plain" else partition_stage3_cuda_wide
    got = stage3(PartitionCoeffs(*_tensors(jc)), torch.from_numpy(s))
    assert tuple(got.shape) == tuple(want.shape) == (max(SHAPES[kind]) // m, m, len(SHAPES[kind]))
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_backend_wide_entries_on_cpu_are_the_plain_stages(dtype):
    """On CPU tensors CudaBackend's wide trio runs the plain wide stages:
    bit for bit the reference backend's."""
    wide = _tensors(_wide("ragged", dtype))
    kern, ref = tplan.CudaBackend(), tplan.ReferenceBackend()
    ck, cr = kern.make_wide_stage1(10)(*wide), ref.make_wide_stage1(10)(*wide)
    for a, b in zip(ck, cr):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    red = (ck.red_dl, ck.red_d, ck.red_du, ck.red_b)
    s = kern.make_wide_reduced_solve()(*red)
    torch.testing.assert_close(s, ref.make_wide_reduced_solve()(*red), rtol=0, atol=0)
    torch.testing.assert_close(kern.make_wide_stage3()(ck, s), ref.make_wide_stage3()(cr, s), rtol=0, atol=0)


def test_wide_stage3_casts_host_fp64_interface_values():
    wide = _wide("uniform", np.float32)
    c = partition_stage1_cuda_wide(*_tensors(wide), m=10)
    s = torch.ones(c.red_d.shape, dtype=torch.float64)
    assert partition_stage3_cuda_wide(c, s).dtype == torch.float32


@pytest.mark.parametrize(
    "case", ["m_mismatch", "not_3d", "shape_mismatch", "thomas_1d", "s_shape"]
)
def test_wide_wrappers_reject_what_the_kernels_do_not_take(case):
    wide = _tensors(_wide("uniform", np.float64))
    with pytest.raises(ValueError):
        if case == "m_mismatch":
            partition_stage1_cuda_wide(*wide, m=5)
        elif case == "not_3d":
            partition_stage1_cuda_wide(*(a.reshape(-1) for a in wide), m=10)
        elif case == "shape_mismatch":
            partition_stage1_cuda_wide(wide[0][:-1], *wide[1:], m=10)
        elif case == "thomas_1d":
            thomas_cuda_wide(*(a.reshape(-1) for a in wide))
        else:
            c = partition_stage1_cuda_wide(*wide, m=10)
            partition_stage3_cuda_wide(c, c.red_d.T)


# ------------------------------------------------------------ the executors --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("layout", ["system-major", "interleaved"])
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_fused_executor_layouts_match_reference(kind, layout, backend, dtype):
    sizes = SHAPES[kind]
    fused = _fused(sizes, dtype, seed=7)
    jex = jplan.FusedExecutor(layout=layout, donate=False)
    want, _ = jex.execute(jplan.build_plan(sizes, 10, num_chunks=3), *fused)
    ex = tplan.FusedExecutor(backend, device="cpu", layout=layout)
    plan = tplan.build_plan(sizes, 10, num_chunks=3)
    assert ex.resolved_layout(plan) == layout
    got, timing = ex.execute(plan, *fused)
    assert got.dtype == np.dtype(dtype) and timing.num_chunks == 3 and timing.t_total_ms > 0
    assert_allclose_by_dtype(got, want, dtype)


def test_ragged_interleaved_solve_with_one_short_system_matches_oracle():
    """One system of one block among 31 of 20 blocks: P_max pads it with 19
    identity blocks, the waste stays under 1.5, and "auto" interleaves."""
    sizes = (200,) * 15 + (10,) + (200,) * 16
    systems = _systems(sizes, np.float64, seed=11)
    dl, d, du, b, got_sizes = fuse_ragged([s[:4] for s in systems])
    plan = tplan.build_plan(got_sizes, 10, num_chunks=2)
    waste = max(sizes) * len(sizes) / sum(sizes)
    assert waste <= tlayout.AUTO_INTERLEAVE_MAX_WASTE
    for backend in ("reference", "cuda"):
        ex = tplan.FusedExecutor(backend, device="cpu", layout="auto")
        assert ex.resolved_layout(plan) == "interleaved"
        x, _ = ex.execute(plan, dl, d, du, b)
        for xi, s in zip(split_ragged(x, sizes), systems):
            assert_allclose_by_dtype(xi, thomas_numpy(*s[:4]), np.float64)
            assert_allclose_by_dtype(xi, s[4], np.float64)


def test_interleaved_with_stacked_operands_raises_as_reference():
    ops = make_diag_dominant_system(40, seed=1, batch=(3,))[:4]
    plan = tplan.build_plan(40, 10)
    with pytest.raises(ValueError, match="interleaved"):
        tplan.FusedExecutor(device="cpu", layout="interleaved").execute(plan, *ops)
    with TridiagSession(SolverConfig(device="cpu", layout="interleaved")) as s:
        with pytest.raises(ValueError, match="interleaved"):
            s.solve(*ops)
    with pytest.raises(ValueError, match="layout"):
        tplan.FusedExecutor(device="cpu", layout="lane-major")


# -------------------------------------------------------------- the session --
VERB_RAGGED = (40, 300, 120, 10, 70)


def _verb_inputs(verb, dtype):
    if verb == "solve":
        return make_diag_dominant_system(600, seed=1, dtype=dtype)[:4]
    if verb == "batched":
        return make_diag_dominant_system(150, seed=2, batch=(4,), dtype=dtype)[:4]
    return [make_diag_dominant_system(n, seed=n, dtype=dtype)[:4] for n in VERB_RAGGED]


def _run(session, verb, ops, request_cls):
    if verb == "solve":
        return session.solve(*ops)
    if verb == "batched":
        return session.solve_batched(*ops)
    if verb == "many":
        return session.solve_many(ops)
    futs = [session.submit(request_cls(i, *o)) for i, o in enumerate(ops)]
    return [f.result(timeout=60) for f in futs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["system-major", "interleaved"])
@pytest.mark.parametrize("verb", ["solve", "batched", "many", "submit"])
def test_session_verbs_match_jax_session_in_both_layouts(verb, layout, dtype):
    ops = _verb_inputs(verb, dtype)
    jcfg = japi.SolverConfig(m=10, num_chunks=3, layout=layout, max_batch=len(VERB_RAGGED))
    with japi.TridiagSession(jcfg) as js:
        want = _run(js, verb, ops, japi.SolveRequest)
    cfg = SolverConfig(m=10, num_chunks=3, layout=layout, max_batch=len(VERB_RAGGED), device="cpu")
    with TridiagSession(cfg) as s:
        got = _run(s, verb, ops, SolveRequest)
        if verb == "submit":
            assert [b["layout"] for b in s.stats["per_batch"]] == [layout]
    for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
        assert g.dtype == np.dtype(dtype) and g.shape == np.asarray(w).shape
        assert_allclose_by_dtype(g, np.asarray(w), dtype)


def test_served_batches_record_the_layout_auto_resolves_to():
    """32 served requests of one size interleave under "auto"; a batch of 4
    stays system-major, as the reference resolves both."""
    *ops, x_true = make_diag_dominant_system(60, seed=9)
    with TridiagSession(SolverConfig(device="cpu", num_chunks=2, max_batch=32, max_wait_ms=20.0)) as s:
        futs = [s.submit(SolveRequest(i, *ops)) for i in range(32)]
        for f in futs:
            assert_allclose_by_dtype(f.result(timeout=60), x_true, np.float64)
        small = [s.submit(SolveRequest(100 + i, *ops)) for i in range(4)]
        for f in small:
            f.result(timeout=60)
        layouts = [(b["systems"], b["layout"]) for b in s.stats["per_batch"]]
    want = {n: jlayout.resolve_layout("auto", (60,) * n, 10, fused=True) for n in (32, 4)}
    assert want == {32: "interleaved", 4: "system-major"}
    assert layouts == [(32, "interleaved"), (4, "system-major")]
