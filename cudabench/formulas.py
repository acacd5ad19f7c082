"""The benchmark's fixed counts of the work a call needs, from its shapes.

These are the yardstick of the roofline and utilisation metrics. They are
written from the published shapes and do not follow the program: a change
to the program moves the measured time, never these counts.

- A tridiagonal solve of ``n`` unknowns reads its four operands (``dl``,
  ``d``, ``du``, ``b``) once and writes its solution once.
- A Mamba-2 training step: 6 × parameters × tokens for the dense products
  (forward 2, backward 4), plus the SSD chunked scan's products (forward,
  and twice that in the backward), with no recomputation.
- SSD Stage 1 (``csrc/ssd_stage1.cu``) and its backward
  (``csrc/ssd_stage1_bwd.cu``): the multiply-adds and bytes of
  ``ssd_stage1_cost`` / ``ssd_stage1_bwd_cost`` in
  ``src/repro_torch/kernels/ssd_stage1/ops.py``, copied here.
"""

from __future__ import annotations

from typing import Dict, Tuple

from cudabench import peaks

#: Operands a solve reads (dl, d, du, b) and arrays it writes (x).
SOLVE_ARRAYS_IN, SOLVE_ARRAYS_OUT = 4, 1


def solve_bytes(unknowns: int, itemsize: int) -> int:
    """Bytes a solve of ``unknowns`` unknowns must move: each operand read
    once, the solution written once."""
    return (SOLVE_ARRAYS_IN + SOLVE_ARRAYS_OUT) * itemsize * unknowns


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    return -(-vocab // multiple) * multiple


def mamba2_dims(arch: Dict) -> Dict[str, int]:
    """The Mamba-2 widths of a configuration file's ``arch`` group."""
    ssm = arch["ssm_cfg"]
    d = arch["d_model"]
    di = ssm["expand"] * d
    return {"layers": arch["n_layer"], "d": d, "di": di, "n": ssm["d_state"],
            "p": ssm["headdim"], "h": di // ssm["headdim"], "k": ssm["d_conv"],
            "q": ssm["chunk_size"], "v": arch["vocab_size"],
            "vp": padded_vocab(arch["vocab_size"])}


def mamba2_params(arch: Dict) -> int:
    """Parameters of the model as trained: the tied embedding (its padded
    rows), and per layer the five input projections, the three causal
    convolutions with biases, dt_bias, a_log, d_skip, the output projection
    and the two norms' scales; the final norm."""
    m = mamba2_dims(arch)
    d, di, n, h, k = m["d"], m["di"], m["n"], m["h"], m["k"]
    layer = (d * (2 * di + 2 * n + h) + (k + 1) * (di + 2 * n) + 3 * h
             + di * d + d + di)
    return m["vp"] * d + m["layers"] * layer + d


def ssd_stage1_cost(g: int, q: int, h: int, p: int, n: int) -> Tuple[int, int]:
    """(bytes, multiply-adds) of SSD Stage 1's forward on ``g`` chunks."""
    causal = q * (q + 1) // 2
    macs = g * (causal * n + h * causal * p + h * q * p * n)
    nbytes = 4 * g * (2 * q * h * p + q * h + 2 * q * n + h * p * n)
    return nbytes, macs


def ssd_stage1_bwd_cost(g: int, q: int, h: int, p: int, n: int) -> Tuple[int, int]:
    """(bytes, multiply-adds) of SSD Stage 1's backward on ``g`` chunks."""
    causal = q * (q + 1) // 2
    macs = g * (3 * causal * n + 2 * h * causal * p + 2 * h * q * p * n)
    nbytes = 4 * g * (3 * q * h * p + 2 * q * h + 4 * q * n + h * p * n)
    return nbytes, macs


def ssd_scan_macs(g: int, q: int, h: int, p: int, n: int) -> int:
    """Multiply-adds of the whole chunked scan's forward on ``g`` chunks:
    Stage 1, the inter-chunk recurrence (Stage 2) and the incoming state's
    contribution to each output (Stage 3)."""
    _, stage1 = ssd_stage1_cost(g, q, h, p, n)
    return stage1 + g * h * p * n + g * q * n * h * p


def mamba2_step_flops(arch: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` × ``seq`` tokens."""
    m = mamba2_dims(arch)
    tokens = batch * seq
    g = batch * (seq // min(m["q"], seq))
    q = min(m["q"], seq)
    scan = 2 * ssd_scan_macs(g, q, m["h"], m["p"], m["n"])
    return 6.0 * mamba2_params(arch) * tokens + 3.0 * m["layers"] * scan


def ssd_bound_s(arch: Dict, batch: int, seq: int) -> float:
    """The least device time of one step's SSD Stage 1 forward and backward
    launches (one each a layer): per launch the larger of its operations
    over the TF32 peak and its bytes over the HBM bandwidth."""
    m = mamba2_dims(arch)
    q = min(m["q"], seq)
    g = batch * (seq // q)
    total = 0.0
    for cost in (ssd_stage1_cost, ssd_stage1_bwd_cost):
        nbytes, macs = cost(g, q, m["h"], m["p"], m["n"])
        total += max(2.0 * macs / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return m["layers"] * total
