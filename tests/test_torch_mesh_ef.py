"""EF-int8 gradient compression on the port's sharded LM path (mamba2-1.3b,
four ranks of a (data = 2, model = 2) mesh on the CPU).

Each rank quantizes its slice of a reduced gradient with the scale of the
whole leaf (the reference's ``max|g + e|`` over the logical array, taken
over the port's stacked-leaf group), its largest magnitude all-reduced
with MAX over the axes the leaf is split on. The error buffers start with
one large entry in ``layers.0.ssm.w_x``, at [0, 0], which only rank
(data 0, model 0) holds: a rank that took its own scale would quantize
that leaf differently, and nothing else would fail.

(a) The compressor alone, two calls with the error carried: the gathered
dequantized gradients and errors equal the unsharded compressor's bit for
bit (the same sums and the same scale), and each rank's own scale does
not. (b) One train step with ``compress_grads`` against the unsharded EF
step on the same weights and batch, at the training gate of
``torch_mesh_ref`` (loss 1e-5 relative; error buffers and parameters
within 1e-4). Quantization is discontinuous: where the two gradients,
which differ within the gate, fall on the two sides of a rounding
boundary, the dequantized values differ by one quantum. Such elements
must lie within the gate of a boundary and move by one quantum; they are
left out of the element comparisons and counted (at most 1e-4 of the
elements).
"""

import numpy as np
import torch

import torch_mesh_ref as mr
import torch_mesh_rig as rig

from repro_torch.optim import adamw, ef_int8_compressor
from repro_torch.optim.groups import grouped
from repro_torch.optim.grad_compress import EFState
from repro_torch.models.convert import params_from_reference
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.train.step import init_train_state, make_train_step

ARCH = "mamba2-1.3b"
SPIKE_LEAF = "layers.0.ssm.w_x"
FLIP_SHARE = 1e-4


def _e0(named, gmax):
    """Zero error buffers but one entry of ``SPIKE_LEAF``, 100 times the
    largest gradient, on rank 0's slice only."""
    e0 = {k: torch.zeros(p.shape, dtype=torch.float32) for k, p in named.items()}
    e0[SPIKE_LEAF][0, 0] = 100.0 * gmax
    return e0


def _scales(summed):
    """Each parameter's scale, from its stacked-leaf group's whole values."""
    out = {}
    for members in grouped(summed).values():
        amax = max(float(summed[k].abs().max()) for k in members)
        out.update((k, max(amax, 1e-12) / 127.0) for k in members)
    return out


def test_compressor_and_step_take_the_whole_leafs_scale(tmp_path):
    ref = mr.reference(ARCH)
    port = mr.port_unsharded(ARCH, {}, ref)
    named, batch = port["named"], port["batch"]
    rng = np.random.default_rng(11)
    grads_seq = [{k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                  for k, p in named.items()} for _ in range(2)]
    gmax = max(float(g.abs().max()) for g in port["grads"].values())
    e0 = _e0(named, gmax)

    # The unsharded side: the compressor twice, and one EF train step.
    _, apply = ef_int8_compressor()
    state, want_calls = EFState(error={k: v.clone() for k, v in e0.items()}), []
    for g in grads_seq:
        deq, state = apply(g, state)
        want_calls.append((deq, state.error))
    model, opt = port["model"], adamw(mr.LR)
    params = params_from_reference(ref["params"], port["cfg"], device="cpu")
    st = init_train_state(model, port["cfg"], opt, 0, params=params, compress_grads=True)
    st = st._replace(ef_state=EFState(error={k: v.clone() for k, v in e0.items()}))
    st, out = make_train_step(model, port["cfg"], ParallelCtx(), opt, compress_grads=True)(
        st, batch)
    want_err = st.ef_state.error
    want_after = {k: p.detach() for k, p in st.params.named_parameters()}

    results = rig.run_ranks(tmp_path, rig.ef_rank, ARCH, named, batch, mr.LR, grads_seq, e0)
    for r in results:
        # (a) bit for bit, and each rank's own scale is wrong for the spike's leaf
        for (deq, err), (w_deq, w_err) in zip(r["calls"], want_calls):
            for k in w_deq:
                assert torch.equal(deq[k], w_deq[k]), k
                assert torch.equal(err[k], w_err[k]), k
        assert not torch.equal(r["own"][SPIKE_LEAF], want_calls[0][0][SPIKE_LEAF])

        # (b) the step at the training gate
        assert abs(r["loss"] - float(out["loss"])) <= mr.LOSS_TOL * abs(float(out["loss"]))
        summed = {k: port["grads"][k].float() + e0[k] for k in named}
        scales = _scales(summed)
        flips = total = 0
        for k in named:
            g = port["grads"][k].double().numpy()
            tol = mr.TOL * np.abs(g).max()
            s_u, scale = summed[k].double().numpy(), scales[k]
            q_u = np.round((s_u - want_err[k].double().numpy()) / scale)
            q_s = np.round((s_u - r["error"][k].double().numpy()) / scale)
            flipped = q_s != q_u
            if flipped.any():
                assert (np.abs(q_s - q_u)[flipped] == 1).all(), k
                frac = np.abs(s_u[flipped] / scale - np.floor(s_u[flipped] / scale) - 0.5)
                assert (frac <= tol / scale + 1e-6).all(), (k, frac.max(), tol / scale)
            err_diff = np.abs(r["error"][k].double().numpy() - want_err[k].double().numpy())
            assert (err_diff[~flipped] <= tol).all(), (k, err_diff[~flipped].max(), tol)
            w = want_after[k].double().numpy()
            resolved = (np.abs(g) > mr.TOL * np.abs(g).max()) & (np.abs(g) > 1e3 * mr.ADAMW_EPS)
            diff = np.abs(r["after"][k].double().numpy() - w)
            assert (diff[resolved & ~flipped] <= mr.TOL * np.abs(w).max()).all(), k
            flips += int(flipped.sum())
            total += flipped.size
        assert flips <= FLIP_SHARE * total, (flips, total)
