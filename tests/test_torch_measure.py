"""The port's wall-clock campaigns (`repro_torch.core.streams.measure`)
against the JAX package's, on the CPU.

``_measure_cell`` is driven by an injected ``run(k)`` returning fixed
timings in both packages and must give the reference's rows field for field;
each campaign then runs end to end at tiny sizes through the port's staged
session, on both stage backends (the kernels' wrappers run their plain
versions on CPU tensors), with the reference campaign's row structure.
"""

import numpy as np
import pytest

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
from repro.core.streams import measure as jax_measure  # noqa: E402
from repro.core.tridiag.plan import ChunkTiming as JaxChunkTiming  # noqa: E402
from repro_torch.core.autotune.heuristic import fit_batched_stream_heuristic  # noqa: E402
from repro_torch.core.streams import measure  # noqa: E402
from repro_torch.core.tridiag.plan import ChunkTiming  # noqa: E402

STRUCTURE = ("size", "num_str", "rep", "batch", "mix")


def _schedule(cls, seed):
    """Per-k queues of timings (warm-up first) with random phase splits."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in (1, 2, 4):
        out[k] = []
        for _ in range(1 + 2):
            s1, s2, s3 = rng.uniform(0.5, 5.0, size=3)
            out[k].append(cls(num_chunks=k, t_stage1_ms=s1, t_stage2_ms=s2, t_stage3_ms=s3,
                              t_total_ms=s1 + s2 + s3, n=600))
    return out


def _timing(k, total, s1, s3, n=600):
    return ChunkTiming(num_chunks=k, t_stage1_ms=s1, t_stage2_ms=total - s1 - s3,
                       t_stage3_ms=s3, t_total_ms=total, n=n)


def test_measure_cell_baseline_phases_come_from_single_best_rep():
    """t_non and sum come from the single best-total baseline rep; minima
    over different reps would pair mismatched phases and could drive the
    Eq. 5 overhead negative."""
    schedule = {
        1: [_timing(1, 11.0, 5.0, 5.0),   # warm-up, discarded
            _timing(1, 10.0, 4.0, 4.0),   # best total, s = 8
            _timing(1, 12.0, 1.0, 1.0)],  # worse total, s = 2
        2: [_timing(2, 9.0, 3.0, 3.0),    # warm-up, discarded
            _timing(2, 8.5, 3.0, 3.0),
            _timing(2, 8.5, 3.0, 3.0)],
    }
    rows = []
    measure._measure_cell(rows, lambda k: schedule[k].pop(0), size=600, batch=None,
                          candidates=(1, 2), reps=2)
    assert len(rows) == 2
    for row in rows:
        assert row["t_non_str"] == 10.0
        assert row["sum"] == 8.0
        assert row["t_overhead"] == (8.5 - 10.0) + 0.5 * 8.0
        assert row["t_overhead"] >= 0.0


@pytest.mark.parametrize("batch,mix", [(None, None), (4, None), (None, (100, 200, 300))])
@pytest.mark.parametrize("seed", [0, 1])
def test_measure_cell_rows_match_the_reference(seed, batch, mix):
    port_sched, ref_sched = _schedule(ChunkTiming, seed), _schedule(JaxChunkTiming, seed)
    port_rows, ref_rows = [], []
    kw = dict(size=600, batch=batch, candidates=(1, 2, 4), reps=2, mix=mix)
    measure._measure_cell(port_rows, lambda k: port_sched[k].pop(0), **kw)
    jax_measure._measure_cell(ref_rows, lambda k: ref_sched[k].pop(0), **kw)
    assert port_rows == ref_rows  # field for field, bit for bit
    assert all(not q for q in port_sched.values())  # every timing consumed


def _structure(rows):
    return [tuple(r.get(key) for key in STRUCTURE) for r in rows]


def _check_rows(port, ref):
    assert _structure(port.rows) == _structure(ref.rows)
    for row in port.rows:
        assert row.keys() == next(iter(ref.rows)).keys()
        for key in ("sum", "t_str", "t_non_str", "t_overhead"):
            assert np.isfinite(row[key]), key
        assert row["t_str"] > 0 and row["t_non_str"] > 0


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_measure_dataset_on_the_cpu(backend):
    kw = dict(candidates=(1, 2, 4), reps=1)
    port = measure.measure_dataset((120, 400), backend=backend, device="cpu", **kw)
    _check_rows(port, jax_measure.measure_dataset((120, 400), **kw))


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_measure_batched_dataset_on_the_cpu(backend):
    kw = dict(batches=(1, 3), candidates=(1, 2), reps=1)
    port = measure.measure_batched_dataset((120,), backend=backend, device="cpu", **kw)
    _check_rows(port, jax_measure.measure_batched_dataset((120,), **kw))
    assert {r["batch"] for r in port.rows} == {1, 3}


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_measure_ragged_dataset_on_the_cpu(backend):
    kw = dict(candidates=(1, 2), reps=1)
    mixes = [(40, 120, 60), (200, 100)]
    port = measure.measure_ragged_dataset(mixes, backend=backend, device="cpu", **kw)
    _check_rows(port, jax_measure.measure_ragged_dataset(mixes, **kw))
    assert [r["size"] for r in port.rows] == [220, 300]


def test_campaign_fits_and_picks_a_candidate():
    """A CPU campaign feeds the paper's fit, which picks a candidate."""
    candidates = (1, 2, 4)
    data = measure.measure_batched_dataset((200, 2000), batches=(1, 2), candidates=candidates,
                                           reps=1, device="cpu")
    heuristic = fit_batched_stream_heuristic(data, candidates=candidates)
    for n in (200, 2000, 20_000):
        assert heuristic.predict_optimum(n) in candidates


def test_campaigns_ask_for_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the missing-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA"):
        measure.measure_dataset((120,), candidates=(1, 2), reps=1)
