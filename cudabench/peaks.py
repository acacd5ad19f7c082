"""Published peaks of one NVIDIA H100 SXM5 (80 GB), the data sheet's dense
rates without sparsity at the full 700 W power limit.

Copied from ``src/repro_torch/roofline/analysis.py`` (``HW_H100``), with the
TF32 rate of the same data sheet beside them. The benchmark keeps its own
copy so that a change to the program does not move its yardstick.
"""

#: bf16 dense tensor-core peak, FLOP/s.
BF16_FLOPS = 989.4e12
#: TF32 dense tensor-core peak, FLOP/s (the SSD kernels' split TF32 products).
TF32_FLOPS = 494.7e12
#: HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: HBM capacity, bytes.
HBM_BYTES = 80e9
