"""Layer-count probes, the counterpart of ``repro.roofline.probe``.

The reference's probe corrects a trip count: XLA's ``cost_analysis``
counts a scanned layer body once, so it compiles 2-3 reduced-depth variants
with every scan unrolled and extrapolates. The port's layer loops are
Python loops, so a full-depth count (``launch/dryrun.py``) is exact already.
Here the probe is a check of per-layer linearity and a fast path for deep
cells: it counts the reduced-depth variants of :func:`probe_plan`, fits
the exact linear model ``cost = fixed + Σ_i n_i · unit_i`` in rational
arithmetic (the rows are square and identifiable; the reference's fit
clamps units below zero, an exact one needs no clamp) and extrapolates to the
full layer count. For per-layer-identical models (all of ours) the
extrapolation equals the full-depth count exactly.

Probe variants per family:
  default / gemma-pairs / ssm : k ∈ {2, 3} layer groups → (fixed, per_group)
  hybrid (zamba2)             : (12,e6) (18,e6) (6,e3) → (fixed, shared, mamba)
  encdec (whisper)            : enc=dec ∈ {2, 3}       → (fixed, per_enc+dec)

A hybrid whose layer count ``e`` does not divide has tail layers after the
last shared block (zamba2-7b: 81 = 13 · 6 + 3). They are not
rematerialised (as in the reference), so under ``remat`` a tail layer costs
less than a trunk layer and the three unknowns do not fit; the port adds a
fourth variant, 2e layers and the tail (:func:`_tail_variant`), and a
fourth unknown, a tail layer's cost beside a trunk layer's.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, List, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.roofline.analysis import HW_H100

METRICS = ("flops", "bytes", "cbytes", "cbytes_nvlink", "cbytes_network")


def _group(cfg: ArchConfig) -> int:
    return 2 if cfg.alternate_local_global else 1


def probe_plan(cfg: ArchConfig) -> Tuple[List[Tuple[ArchConfig, List[float]]], List[float]]:
    """Returns ([(variant_cfg, coeff_row)], full_coeff_row)."""
    g = _group(cfg)
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        n_super = cfg.num_layers // e
        tail = cfg.num_layers - n_super * e
        variants = [
            (dataclasses.replace(cfg, num_layers=2 * e), [1, 2, 2 * e]),
            (dataclasses.replace(cfg, num_layers=3 * e), [1, 3, 3 * e]),
            (dataclasses.replace(cfg, num_layers=2 * (e // 2), shared_attn_every=e // 2),
             [1, 2, 2 * (e // 2)]),
        ]
        full = [1, n_super, cfg.num_layers]
        del tail  # tail mamba layers are covered by the total layer count
        return variants, full
    if cfg.family == "encdec":
        variants = [
            (dataclasses.replace(cfg, num_layers=2 * k, enc_layers=k, dec_layers=k), [1, k])
            for k in (2, 3)
        ]
        return variants, [1, cfg.enc_layers]
    variants = [
        (dataclasses.replace(cfg, num_layers=g * k), [1, k]) for k in (2, 3)
    ]
    return variants, [1, cfg.num_layers // g]


def _tail_variant(cfg: ArchConfig) -> Tuple[ArchConfig, List[float]] | None:
    """The hybrid's fourth variant when it has tail layers: 2e trunk layers
    and the tail, as the row [1, 2, 2e + tail, tail]."""
    if cfg.family != "hybrid":
        return None
    e = cfg.shared_attn_every
    tail = cfg.num_layers - (cfg.num_layers // e) * e
    if not tail:
        return None
    return dataclasses.replace(cfg, num_layers=2 * e + tail), [1, 2, 2 * e + tail, tail]


def _extract(counts: Any) -> Dict[str, int]:
    total, _, _ = counts.collectives.collective_bytes()
    by_link = counts.collectives.bytes_by_link(HW_H100)
    return {
        "flops": int(counts.flops),
        "bytes": int(counts.bytes),
        "cbytes": int(total),
        "cbytes_nvlink": int(by_link.get("nvlink", 0)),
        "cbytes_network": int(by_link.get("network", 0)),
    }


def _solve(rows: Sequence[Sequence[float]], obs: Sequence[int]) -> List[Fraction]:
    """The exact solution of the square system ``rows · units = obs``
    (Gauss-Jordan over the rationals)."""
    n = len(rows)
    a = [[Fraction(x) for x in row] + [Fraction(o)] for row, o in zip(rows, obs)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        for r in range(n):
            if r != col and a[r][col] != 0:
                f = a[r][col] / a[col][col]
                a[r] = [x - f * y for x, y in zip(a[r], a[col])]
    return [a[i][n] / a[i][i] for i in range(n)]


def _number(x: Fraction) -> Union[int, float]:
    return int(x) if x.denominator == 1 else float(x)


def probe_cell(arch: str, shape_name: str, multi_pod: bool = False, **kw: Any) -> Dict:
    """Per-device (flops, bytes, collective bytes) for one cell from its
    reduced-depth variants. Extra kwargs reach ``lower_cell``
    (``cfg_override`` for another config, ``shape_override``, ``remat``,
    ``strategy``, ``device``, ...). The default process group must have the
    mesh's ranks (``launch.dryrun.fake_world``)."""
    from repro_torch.launch.dryrun import lower_cell_cfg

    cfg = kw.pop("cfg_override", None) or get_config(arch)
    shape = kw.get("shape_override") or SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}

    variants, full = probe_plan(cfg)
    tail = _tail_variant(cfg)
    if tail is not None:
        variants = [(v, row + [0]) for v, row in variants] + [tail]
        full = full + [tail[1][-1]]
    rows, obs = [], {m: [] for m in METRICS}
    for vcfg, coeffs in variants:
        # The full config's optimizer (the reference picks the variant's:
        # Adafactor's cells would probe AdamW).
        counts = lower_cell_cfg(vcfg, shape_name, multi_pod, optimizer_of=cfg, **kw)
        ex = _extract(counts)
        rows.append(coeffs)
        for m in METRICS:
            obs[m].append(ex[m])
        del counts

    out: Dict[str, Any] = {"status": "ok", "variant_rows": rows, "observations": obs}
    assert all(len(row) == len(rows) for row in rows), rows  # square: an exact fit
    for m in METRICS:
        units = _solve(rows, obs[m])
        out[m] = _number(sum((Fraction(c) * u for c, u in zip(full, units)), Fraction(0)))
        out[f"{m}_units"] = [_number(u) for u in units]
    return out
