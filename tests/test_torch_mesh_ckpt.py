"""Checkpoints on the port's sharded LM path (mamba2-1.3b, four ranks of a
(data = 2, model = 2) mesh on the CPU).

The file format is the unsharded one: logical tensors under the same keys.
So a checkpoint written on the mesh restores unsharded, and an unsharded
one on the mesh, bit for bit; a (2, 2) checkpoint restores on a (4, 1)
mesh; Adafactor's factored statistics are gathered by their parameter's
spec less the dim they reduce; the step is stored as an int; a write that
fails on the writing rank raises on every rank at ``wait``; and a
``run_training`` on the mesh preempted on one rank and resumed gives the
unbroken run's losses.
"""

import json

import numpy as np
import pytest
import torch

import torch_mesh_ref as mr
import torch_mesh_rig as rig

from repro_torch.ckpt.checkpoint import leaf_spec, logical_leaves
from repro_torch.ckpt.checkpoint import restore_checkpoint
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adafactor, adamw
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.train.step import init_train_state, make_train_step

ARCH = "mamba2-1.3b"


def _state(port, ref, optimizer, **kw):
    params = params_from_reference(ref["params"], port["cfg"], device="cpu")
    return init_train_state(port["model"], port["cfg"], optimizer, 0, params=params, **kw)


def _step(port, ref, optimizer, **kw):
    """The unsharded state after one train step."""
    st = _state(port, ref, optimizer, compress_grads=kw.get("compress_grads", False))
    st, _ = make_train_step(port["model"], port["cfg"], ParallelCtx(), optimizer, **kw)(
        st, port["batch"])
    return st


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        else:
            assert type(got[k]) is int and got[k] == w, k


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    ref = mr.reference(ARCH)
    port = mr.port_unsharded(ARCH, {}, ref)
    plain = _step(port, ref, adamw(mr.LR), compress_grads=True)
    mgr = CheckpointManager(root / "plain", async_save=False)
    mgr.maybe_save(plain.step, plain, force=True)
    (root / "blocked").write_text("a file where the checkpoint directory should be")
    ranks = rig.run_ranks(root, rig.ckpt_rank, ARCH, port["named"], port["batch"], mr.LR,
                          str(root))
    return dict(root=root, ref=ref, port=port, plain=logical_leaves(plain), ranks=ranks)


def test_mesh_checkpoint_restores_unsharded(run):
    port, ref = run["port"], run["ref"]
    saved = run["ranks"][0]["saved"]
    assert [r["writer"] for r in run["ranks"]] == [True, False, False, False]
    for r in run["ranks"]:
        _same(r["saved"], saved)
    target = _state(port, ref, adamw(mr.LR), compress_grads=True)
    restored, step = restore_checkpoint(run["root"] / "mesh", target)
    assert step == 1
    _same(logical_leaves(restored), saved)


def test_unsharded_checkpoint_restores_on_the_mesh(run):
    for r in run["ranks"]:
        assert r["plain_step"] == 1
        _same(r["from_plain"], run["plain"])


def test_checkpoint_reshards_from_2x2_to_4x1(run):
    for r in run["ranks"]:
        assert r["mesh_step"] == 1 and r["latest_4x1"] == 1
        _same(r["on_4x1"], run["ranks"][0]["saved"])


def test_adafactor_factored_state(run):
    port, ref = run["port"], run["ref"]
    saved = run["ranks"][0]["af_saved"]
    for r in run["ranks"]:
        assert r["af_local_equal"]
        _same(r["af_saved"], saved)
    want = logical_leaves(_step(port, ref, adafactor(mr.LR)))
    factored = [k for k in want if k.endswith("/vr") or k.endswith("/vc")]
    assert factored
    for k in factored:  # the whole statistics: full shapes, the unsharded values
        mr.close_to_max(saved[k].numpy(), want[k].numpy(), mr.TOL, k)
    restored, _ = restore_checkpoint(run["root"] / "adafactor", _state(port, ref, adafactor(mr.LR)))
    _same(logical_leaves(restored), saved)


def test_step_is_saved_as_an_int(run):
    for name in ("mesh", "adafactor"):
        (path,) = (run["root"] / name).iterdir()
        manifest = json.loads((path / "manifest.json").read_text())
        assert path.name == "step_00000001" and manifest["step"] == 1
        assert manifest["dtypes"]["step"] == "int"
        with np.load(path / "arrays.npz") as zf:
            assert zf["step"].dtype == np.int64 and int(zf["step"]) == 1
    assert type(run["ranks"][0]["saved"]["step"]) is int


def test_write_error_raises_on_every_rank(run):
    errors = [r["write_error"] for r in run["ranks"]]
    assert errors[0] == "FileExistsError", errors
    assert errors[1:] == ["RuntimeError"] * 3, errors


def test_leaf_spec_follows_the_parameter():
    specs = {"layers.0.ssm.w_x": ("data", "model"), "emb.embed": ("model", "data")}
    assert leaf_spec("params/layers.0.ssm.w_x", specs) == ("data", "model")
    assert leaf_spec("opt_state/m/emb.embed", specs) == ("model", "data")
    assert leaf_spec("ef_state/error/layers.0.ssm.w_x", specs) == ("data", "model")
    assert leaf_spec("opt_state/layers.0.ssm.w_x/vr", specs) == ("data",)
    assert leaf_spec("opt_state/layers.0.ssm.w_x/vc", specs) == ("model",)
    assert leaf_spec("opt_state/emb.embed/v", specs) == ("model", "data")
    assert leaf_spec("step", specs) is None


def test_preempted_mesh_run_resumes_as_unbroken(tmp_path):
    steps, at = 5, 4  # the pipeline stages step 4 while step 2 or 3 runs
    results = rig.run_ranks(tmp_path, rig.resume_rank, ARCH, str(tmp_path / "ckpt"), steps,
                            at, 1)
    for r in results:
        assert r == {**results[0], "saved": r["saved"]}  # every rank the same losses
        assert len(r["unbroken"]) == steps
        assert 0 < len(r["first"]) < steps and len(r["first"]) + len(r["second"]) == steps
        np.testing.assert_allclose(r["first"] + r["second"], r["unbroken"], rtol=1e-5, atol=0)
    assert results[0]["saved"] == [f"step_{len(results[0]['first']):08d}", f"step_{steps:08d}"]
