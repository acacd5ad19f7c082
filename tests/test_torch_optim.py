"""The port's optimizers against the JAX reference's, on the CPU.

The same parameter trees (dicts of numpy arrays from a seed: matrices,
a vector, a stacked 3-d leaf and a [1, n] leaf, which Adafactor does not
factor) and the same gradients at every step go through
``repro.optim`` and ``repro_torch.optim`` for several steps; each side
adds its updates in the parameter's dtype, as the training step does.
Tolerances: fp32 parameters and updates within 1e-6 relative plus 1e-6 of
the tensor's largest magnitude (2e-6 for Adafactor, whose factored
statistics sum in another order: a parameter near zero takes an update as
large as the others'), states within the same relative tolerance over an
absolute floor of 1e-9; bf16 parameters and updates within one bf16 ulp
(2**-7, relative and of the largest magnitude). ``cosine_warmup`` is the
reference's at every step to 5e-7 relative (a few fp32 ulps: the two
cosines may differ in their last bits); the EF-int8 compressor's
dequantized gradients and error buffers within 1e-6.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adafactor as ref_adafactor  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import cosine_warmup as ref_cosine  # noqa: E402
from repro.optim.grad_compress import ef_int8_compressor as ref_ef  # noqa: E402
from repro_torch.optim import adafactor, adamw, cosine_warmup, ef_int8_compressor  # noqa: E402

SHAPES = {"w": (8, 16), "b": (16,), "stack": (3, 4, 5), "row": (1, 7)}
STEPS = 6
BF16_ULP = 2.0**-7


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed, step):
    rng = np.random.default_rng(1000 * seed + step)
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
            for k, s in SHAPES.items()}


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().astype(np.float64)
    a = jnp.asarray(t)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, np.float64)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _run_both(ref_opt, opt, dtype, seed):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    p0 = _params(seed)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    js, ts = ref_opt.init(jp), opt.init(tp)
    history = []
    for step in range(STEPS):
        g = _grads(seed, step)
        ju, js = ref_opt.update({k: jnp.asarray(v).astype(jdt) for k, v in g.items()}, js, jp,
                                jnp.asarray(step, jnp.int32))
        tu, ts = opt.update({k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts, tp, step)
        jp = {k: jp[k] + ju[k].astype(jdt) for k in jp}
        tp = {k: tp[k] + tu[k].to(tdt) for k in tp}
        history.append((ju, tu, js, ts, jp, tp))
    return history


def _check(history, dtype, rtol):
    for ju, tu, js, ts, jp, tp in history:
        for k in tp:
            assert tu[k].dtype == tp[k].dtype
        r = BF16_ULP if dtype == "bfloat16" else rtol
        for k in tp:
            for got, want in ((tp[k], jp[k]), (tu[k], ju[k])):
                want = _np(want)
                np.testing.assert_allclose(_np(got), want, rtol=r, atol=r * np.abs(want).max(),
                                           err_msg=k)
        jflat, tflat = _flat(js), _flat(ts)
        assert set(jflat) == set(tflat)
        for k in tflat:
            assert tflat[k].dtype == torch.float32, k  # fp32 statistics for every dtype
            np.testing.assert_allclose(_np(tflat[k]), _np(jflat[k]), rtol=rtol, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_reference(dtype, schedule):
    lr = (3e-2, 3e-2) if schedule == "constant" else (ref_cosine(3e-2, 2, STEPS),
                                                      cosine_warmup(3e-2, 2, STEPS))
    _check(_run_both(ref_adamw(lr[0]), adamw(lr[1]), dtype, seed=1), dtype, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_matches_reference(dtype, weight_decay):
    _check(_run_both(ref_adafactor(1e-2, weight_decay=weight_decay),
                     adafactor(1e-2, weight_decay=weight_decay), dtype, seed=2), dtype, 2e-6)


def test_adafactor_state_is_factored():
    st = adafactor(1e-3).init({"w": torch.zeros(128, 256), "row": torch.zeros(1, 7),
                               "stack": torch.zeros(3, 4, 5)})
    assert st["w"]["vr"].shape == (128,) and st["w"]["vc"].shape == (256,)
    assert st["stack"]["vr"].shape == (3, 4) and st["stack"]["vc"].shape == (3, 5)
    assert st["row"]["v"].shape == (1, 7)


@pytest.mark.parametrize("peak,warmup,total", [(3e-3, 2, 30), (1.0, 10, 100), (1e-4, 1, 5)])
def test_cosine_warmup_matches_reference(peak, warmup, total):
    ref, port = ref_cosine(peak, warmup, total), cosine_warmup(peak, warmup, total)
    got = np.array([port(s) for s in range(total + 3)])
    want = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


def test_ef_int8_compressor_matches_reference():
    r_init, r_apply = ref_ef()
    init, apply = ef_int8_compressor()
    g0 = _grads(3, 0)
    rs, ts = r_init({k: jnp.asarray(v) for k, v in g0.items()}), init(
        {k: torch.from_numpy(v) for k, v in g0.items()})
    for step in range(STEPS):
        g = _grads(3, step)
        rd, rs = r_apply({k: jnp.asarray(v) for k, v in g.items()}, rs)
        td, ts = apply({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in g:
            np.testing.assert_allclose(_np(td[k]), _np(rd[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(_np(ts.error[k]), _np(rs.error[k]), rtol=1e-6, atol=1e-9)
            assert ts.error[k].dtype == torch.float32


def test_ef_int8_error_feedback_converges():
    init, apply = ef_int8_compressor()
    grads = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=512) * 0.1).float()}
    deq, _ = apply(grads, init(grads))
    err = float((deq["w"] - grads["w"]).abs().max())
    assert 0 < err < 0.01
    st = init(grads)
    total_deq = torch.zeros(512)
    for _ in range(50):
        deq, st = apply(grads, st)
        total_deq += deq["w"]
    rel = float(torch.linalg.norm(total_deq - 50 * grads["w"]) / torch.linalg.norm(50 * grads["w"]))
    assert rel < 1e-3


def test_per_tensor_statistics_span_the_references_stacked_leaves():
    rng = np.random.default_rng(5)
    mats = [(rng.standard_normal((6, 5)) * 0.1).astype(np.float32) for _ in range(3)]
    head = (rng.standard_normal((5, 4)) * 0.1).astype(np.float32)
    port = {f"layers.{i}.w": torch.from_numpy(m) for i, m in enumerate(mats)}
    port["head"] = torch.from_numpy(head)

    def as_ref(t):  # the port's per-layer tensors as the reference's stacked leaf
        return {"layers": {"w": jnp.stack([jnp.asarray(t[f"layers.{i}.w"]) for i in range(3)])[:, None]},
                "head": jnp.asarray(t["head"])}

    def as_port(tree):
        out = {f"layers.{i}.w": np.asarray(tree["layers"]["w"][i, 0]) for i in range(3)}
        out["head"] = np.asarray(tree["head"])
        return out

    for ref_opt, opt in ((ref_adafactor(1e-2), adafactor(1e-2)),):
        rp, tp = as_ref(port), dict(port)
        rs, ts = ref_opt.init(rp), opt.init(tp)
        for step in range(3):
            g = {k: torch.from_numpy((rng.standard_normal(v.shape) * 10.0 ** (i - 2)).astype(np.float32))
                 for i, (k, v) in enumerate(port.items())}
            ru, rs = ref_opt.update(as_ref(g), rs, rp, jnp.asarray(step, jnp.int32))
            tu, ts = opt.update(g, ts, tp, step)
            for k, want in as_port(ru).items():
                np.testing.assert_allclose(tu[k].numpy(), want, rtol=2e-6, atol=2e-6 * np.abs(want).max())
            rp = jax.tree.map(lambda a, b: a + b, rp, ru)
            tp = {k: tp[k] + tu[k] for k in tp}
    r_init, r_apply = ref_ef()
    init, apply = ef_int8_compressor()
    rs, ts = r_init(as_ref(port)), init(port)
    for step in range(3):
        g = {k: torch.from_numpy((rng.standard_normal(v.shape) * 10.0 ** (i - 2)).astype(np.float32))
             for i, (k, v) in enumerate(port.items())}
        rd, rs = r_apply(as_ref(g), rs)
        td, ts = apply(g, ts)
        for k, want in as_port(rd).items():
            np.testing.assert_allclose(td[k].numpy(), want, rtol=1e-6, atol=1e-9)
        for k, want in as_port(rs.error).items():
            np.testing.assert_allclose(ts.error[k].numpy(), want, rtol=1e-6, atol=1e-9)


def test_adamw_takes_the_same_steps_in_chunks(monkeypatch):
    """The elementwise math runs on chunks of parameters: the chunking
    changes no value."""
    import importlib

    adamw_mod = importlib.import_module("repro_torch.optim.adamw")  # the package's adamw is the function
    params = {k: torch.from_numpy(v) for k, v in _params(4).items()}
    grads = {k: torch.from_numpy(v) for k, v in _grads(4, 0).items()}
    opt = adamw(1e-2)
    whole = opt.update(grads, opt.init(params), params, 0)
    monkeypatch.setattr(adamw_mod, "CHUNK_ELEMENTS", 50)
    assert len(list(adamw_mod._chunks(params))) > 1
    chunked = opt.update(grads, opt.init(params), params, 0)
    flat_whole, flat_chunked = _flat(dict(zip("us", whole))), _flat(dict(zip("us", chunked)))
    assert list(flat_whole) == list(flat_chunked)
    for k, a in flat_whole.items():
        assert torch.equal(a, flat_chunked[k]), k
