"""One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W
power limit), as ``src/repro_torch/analysis/roofline.py`` (commit d455ed1)
states them."""

BF16_FLOPS = 989.4e12  # tensor cores, bf16 dense
HBM_BYTES = 3.35e12  # bytes/s
