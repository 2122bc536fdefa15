"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Data plane (the paper's local strategies, ports of `repro.kernels`; the
CUDA sources are in `repro_torch/csrc/`):
  sorted_probe   — join probe: a binary search per query (`csrc/sorted_probe.cu`)
  segmented_scan — grouped aggregation: segmented add/max/min scan and the
                   segment_reduce entry (`csrc/segmented_scan.cu`)
  span_compact   — a megakernel span's interior boundary: the stable
                   valids-first pack of the live columns and the observed
                   count (`csrc/span_compact.cu`)
  span_segment   — segment numbering of a just-packed Reduce input inside a
                   span, and the group count (`csrc/span_segment.cu`)

Model plane:
  flash_attention — causal / sliding-window GQA attention with an online
                   softmax, every prefill layer under attn_impl="flash"
                   (`csrc/flash_attention.cu`)

`megakernel.py` plans and runs the fused spans, `ops.py` holds the wrappers
and launch counts, `ref.py` the plain torch versions, `build.py` the nvcc
build.  The RWKV-6 and linear-scan kernels of `repro` are not ported yet
(ROADMAP.md, Queue 2).
"""
