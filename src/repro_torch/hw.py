"""Target-hardware constants used by the data-flow cost model.

Mirrors `repro.hw`.  `CHIP` stays `TPU_V5E` so the port's optimizer prices
plans exactly as the reference does and picks the same plans; `H100_SXM`
describes the card the port runs on and can be passed through
`physical.Ctx(chip=...)` to price against it instead.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float  # FLOP/s per chip
    hbm_bandwidth: float    # bytes/s per chip
    hbm_capacity: float     # bytes per chip
    ici_link_bandwidth: float  # bytes/s per ICI link
    dcn_bandwidth: float    # bytes/s per chip across pods (data-center network)
    vmem_bytes: int         # per-core VMEM
    ici_latency_s: float = 1e-6  # per-collective launch + link latency (s)


TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_bf16_flops=197e12,
    hbm_bandwidth=819e9,
    hbm_capacity=16 * 1024**3,
    ici_link_bandwidth=50e9,
    dcn_bandwidth=6.25e9,  # ~25 GB/s per host / 4 chips
    vmem_bytes=128 * 1024**2,
    ici_latency_s=1e-6,
)

# NVIDIA H100 SXM (data sheet, dense rates): 989 TFLOP/s bf16, 80 GB HBM3 at
# 3.35 TB/s, NVLink 900 GB/s per card (450 GB/s each way), one 400 Gb/s
# NDR InfiniBand port per card across hosts.  The per-block shared memory
# (227 KB) takes the place of VMEM.  The 2 us collective launch latency is
# an assumption, not a measurement.
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80 * 1000**3,
    ici_link_bandwidth=450e9,
    dcn_bandwidth=50e9,
    vmem_bytes=232_448,
    ici_latency_s=2e-6,
)

# Default chip used throughout (the reference's, so plans match it).
CHIP = TPU_V5E


def mesh_chip_count(mesh_shape: tuple[int, ...]) -> int:
    n = 1
    for s in mesh_shape:
        n *= s
    return n
