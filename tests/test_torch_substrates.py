"""The port's training substrates against the JAX reference's, on the CPU:
the synthetic data and ``synthesize_batch`` (bit for bit), the input specs,
the prefetch pipeline (order, resume, errors), checkpoints (round trip,
bf16, atomicity, keep-k, the asynchronous save's snapshot, restore into a
module), the straggler watchdog and the preemption handler, and the
overlap tuners (the same answers for the same inputs).
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.core.autotune import overlap as ref_overlap  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as RefDataset  # noqa: E402
from repro_torch.ckpt.checkpoint import (  # noqa: E402
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.autotune import overlap  # noqa: E402
from repro_torch.data.pipeline import PrefetchPipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.ft.preemption import PreemptionHandler  # noqa: E402
from repro_torch.ft.watchdog import StepWatchdog  # noqa: E402
from repro_torch.models.convert import caches_to_reference  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

ARCHS = ["mamba2-1.3b", "zamba2-7b", "qwen3-4b", "gemma2-27b", "codeqwen1.5-7b",
         "nemotron-4-340b", "internvl2-2b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
         "whisper-medium"]


# ------------------------------------------------------------------- data ---
@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 100, 16, 4), (3, 50_280, 64, 2),
                                                  (7, 512, 33, 5)])
def test_synthetic_dataset_is_the_references_bit_for_bit(seed, vocab, seq, batch):
    ref = RefDataset(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    port = SyntheticLMDataset(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in (0, 1, 7, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    np.testing.assert_array_equal(port.batch_at(7)["labels"][:, :-1], port.batch_at(7)["tokens"][:, 1:])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synthesize_batch_is_the_references(arch, kind):
    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    spec = dict(name=f"{kind}_smoke", seq_len=32, global_batch=2, kind=kind)
    want = ref_shapes.synthesize_batch(ref_cfg, ref_shapes.ShapeSpec(**spec), seed=11)
    got = shapes.synthesize_batch(cfg, shapes.ShapeSpec(**spec), seed=11, device="cpu")
    assert list(got) == list(want)
    for k, v in got.items():
        if k == "caches":
            layout = caches_to_reference(v, cfg)
            ref_leaves = {(key, f): np.asarray(a)
                          for key, tree in want["caches"].items() if key != "enc_out"
                          for f, a in (tree._asdict() if hasattr(tree, "_asdict") else tree).items()}
            got_leaves = {(key, f): a for key, tree in layout.items() if key != "enc_out"
                          for f, a in tree.items()}
            assert set(got_leaves) == set(ref_leaves)
            for name, a in got_leaves.items():
                assert a.shape == ref_leaves[name].shape and not a.any(), name
            if "enc_out" in want["caches"]:
                assert tuple(v["enc_out"].shape) == want["caches"]["enc_out"].shape
            continue
        w = np.asarray(want[k].astype(np.float32) if want[k].dtype.name == "bfloat16" else want[k])
        assert np.array_equal(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy(), w), k


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-4b", "internvl2-2b", "whisper-medium"])
def test_input_specs_are_meta_tensors_of_the_references_shapes(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name, shape in shapes.SHAPES.items():
        assert shapes.applicable(cfg, shape) == ref_shapes.applicable(ref_cfg, ref_shapes.SHAPES[name])
        if shape.kind == "decode":
            continue  # full-size caches: the smoke test above compares them
        specs = shapes.input_specs(cfg, shape)
        ref_specs = ref_shapes.input_specs(ref_cfg, ref_shapes.SHAPES[name])
        assert list(specs) == list(ref_specs)
        for k, t in specs.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == ref_specs[k].shape
            assert str(t.dtype).removeprefix("torch.") == str(ref_specs[k].dtype)
    assert shapes.WHISPER_ENC_FRAMES == ref_shapes.WHISPER_ENC_FRAMES


def test_decode_caches_on_the_meta_device_hold_no_memory():
    model = build_model(get_config("qwen3-4b"))
    caches = model.make_caches(128, 32_768, device="meta")
    assert all(c.k.device.type == "meta" for c in caches["kv"])


def test_prefetch_pipeline_orders_and_resumes():
    ds = SyntheticLMDataset(vocab_size=50, seq_len=8, global_batch=2)
    pipe = PrefetchPipeline(ds.batch_at, start_step=5, depth=2, num_chunks=2, device="cpu")
    try:
        assert pipe.num_chunks == 2
        steps = [next(pipe)[0] for _ in range(4)]
        assert steps == [5, 6, 7, 8]
        step, batch = next(pipe)
        assert isinstance(batch["tokens"], torch.Tensor)
        np.testing.assert_array_equal(batch["tokens"].numpy(), ds.batch_at(step)["tokens"])
    finally:
        pipe.close()


def test_prefetch_pipeline_takes_the_references_chunk_count():
    ds = SyntheticLMDataset(vocab_size=50_000, seq_len=4096, global_batch=64)
    pipe = PrefetchPipeline(ds.batch_at, device="cpu", step_compute_s=0.05)
    try:
        batch_bytes = float(sum(a.nbytes for a in ds.batch_at(0).values()))
        want, _ = ref_overlap.tune_prefetch_chunks(batch_bytes=batch_bytes, host_link_Bps=10e9,
                                                   step_compute_s=0.05)
        assert pipe.num_chunks == want
    finally:
        pipe.close()


def test_prefetch_pipeline_raises_the_workers_error():
    def batch_fn(step):
        if step == 2:
            raise ValueError("no batch 2")
        return {"tokens": np.zeros((2, 4), np.int32)}

    pipe = PrefetchPipeline(batch_fn, device="cpu")
    try:
        assert [next(pipe)[0] for _ in range(2)] == [0, 1]
        with pytest.raises(ValueError, match="no batch 2"):
            next(pipe)
    finally:
        pipe.close()


def test_prefetch_pipeline_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    ds = SyntheticLMDataset(vocab_size=50, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefetchPipeline(ds.batch_at)


# ------------------------------------------------------------------- ckpt ---
def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 1e-3], dtype=torch.bfloat16)},
            "step": 7, "none": None}
    save_checkpoint(tmp_path, 3, tree)
    assert latest_step(tmp_path) == 3
    target = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.bfloat16)},
              "step": 0, "none": None}
    restored, step = restore_checkpoint(tmp_path, target)
    assert step == 3 and restored["step"] == 7 and restored["none"] is None
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16 and torch.equal(restored["b"]["c"], tree["b"]["c"])
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as zf:
        assert zf["b/c"].dtype == np.uint16  # bf16 as its bit pattern
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_torn_checkpoints_are_skipped_and_failed_writes_leave_nothing(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(3)})
    (tmp_path / "step_00000009").mkdir()  # torn: no manifest
    assert latest_step(tmp_path) == 1
    with pytest.raises(TypeError):
        save_checkpoint(tmp_path, 2, {"w": torch.ones(3), "bad": object()})
    assert latest_step(tmp_path) == 1
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path, {"w": torch.zeros(3), "other": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", {"w": torch.zeros(3)})


def test_checkpoint_restores_a_module_in_place(tmp_path):
    src = torch.nn.Linear(4, 3)
    save_checkpoint(tmp_path, 5, {"params": src, "step": 5})
    dst = torch.nn.Linear(4, 3)
    restored, step = restore_checkpoint(tmp_path, {"params": dst, "step": 0})
    assert restored["params"] is dst and restored["step"] == 5 and step == 5
    assert torch.equal(dst.weight, src.weight) and torch.equal(dst.bias, src.bias)


def test_checkpoint_manager_keep_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, save_every=1, async_save=False)
    for s in range(1, 6):
        mgr.maybe_save(s, {"w": torch.zeros(3)}, force=True)
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()) == [4, 5]
    mgr2 = CheckpointManager(tmp_path, keep=2, save_every=10, async_save=False)
    assert not mgr2.maybe_save(7, {"w": torch.zeros(3)}) and not mgr2.maybe_save(0, {})


def test_checkpoint_manager_async_saves_the_state_as_it_was(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, save_every=1, async_save=True)
    w = torch.ones(1000)
    mgr.maybe_save(1, {"w": w}, force=True)
    w.add_(1.0)  # a step that runs while the save is written
    mgr.wait()
    restored, step = mgr.restore({"w": torch.zeros(1000)})
    assert step == 1 and torch.equal(restored["w"], torch.ones(1000))


def test_checkpoint_manager_surfaces_a_failed_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path / "file", keep=3, save_every=1, async_save=True)
    (tmp_path / "file").write_text("not a directory")
    mgr.maybe_save(1, {"w": torch.ones(2)}, force=True)
    with pytest.raises(OSError):
        mgr.wait()


# --------------------------------------------------------------------- ft ---
def test_watchdog_flags_stragglers():
    wd = StepWatchdog(window=20, k_mad=3.0, hang_timeout_s=9999)
    try:
        for i in range(15):
            assert not wd.beat(i, 0.1 + 0.001 * (i % 3))
        assert wd.beat(15, 1.5)  # 15x median
        assert wd.straggler_events[0]["step"] == 15
    finally:
        wd.close()


def test_watchdog_fires_on_a_hang():
    fired = threading.Event()
    wd = StepWatchdog(hang_timeout_s=0.2, on_hang=fired.set)
    try:
        assert fired.wait(5.0)
    finally:
        wd.close()


def test_preemption_handler_sets_flag_and_restores():
    prev = signal.getsignal(signal.SIGUSR1)
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    try:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert h.requested
    finally:
        h.restore()
    assert signal.getsignal(signal.SIGUSR1) == prev


# ---------------------------------------------------------------- overlap ---
@pytest.mark.parametrize("grad_bytes", [1e3, 1e6, 1e8, 2e9])
@pytest.mark.parametrize("backward_s", [1e-4, 1e-2, 0.5])
def test_gradient_bucket_tuner_is_the_references(grad_bytes, backward_s):
    kw = dict(grad_bytes=grad_bytes, link_bandwidth_Bps=50e9, backward_compute_s=backward_s)
    assert overlap.tune_gradient_buckets(**kw) == ref_overlap.tune_gradient_buckets(**kw)


@pytest.mark.parametrize("batch_bytes", [1e3, 1e6, 3.3e7, 1e9])
@pytest.mark.parametrize("step_s", [1e-3, 0.1])
def test_prefetch_chunk_tuner_is_the_references(batch_bytes, step_s):
    kw = dict(batch_bytes=batch_bytes, host_link_Bps=10e9, step_compute_s=step_s)
    assert overlap.tune_prefetch_chunks(**kw) == ref_overlap.tune_prefetch_chunks(**kw)


def test_ssm_chunk_tuner_and_learned_overhead_are_the_references():
    kw = dict(seq_len=4096, d_inner=4096, ssm_state=128, head_dim=64)
    assert overlap.tune_ssm_chunk(**kw) == ref_overlap.tune_ssm_chunk(**kw)
    spec = dict(sum_overlappable_s=3e-3, per_chunk_latency_s=2e-5, log2_quadratic_s=1e-5,
                bytes_total=5e7)
    assert (overlap.tune_overlap_granularity(overlap.OverlapSpec(**spec))
            == ref_overlap.tune_overlap_granularity(ref_overlap.OverlapSpec(**spec)))
    rng = np.random.default_rng(0)
    size = rng.uniform(1e3, 1e6, 60)
    n = rng.choice([2, 4, 8, 16], 60).astype(float)

    def form(x, a, b, c):
        return a + b * np.log(x[0]) + c * x[1]

    t = form((size, n), 1e-4, 2e-6, 3e-5) * (1 + 0.01 * rng.standard_normal(60))
    ref = ref_overlap.LearnedOverheadTuner(form=form, p0=[1e-4, 1e-6, 1e-5]).fit(size, n, t)
    port = overlap.LearnedOverheadTuner(form=form, p0=[1e-4, 1e-6, 1e-5]).fit(size, n, t)
    np.testing.assert_allclose(port.popt, ref.popt, rtol=1e-9)
    for sz, s in ((1e4, 1e-3), (5e5, 1e-2)):
        assert port.predict_optimum(sz, s) == ref.predict_optimum(sz, s)

