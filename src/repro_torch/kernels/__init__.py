"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Data plane (the paper's local strategies, ports of `repro.kernels`; the
CUDA sources are in `repro_torch/csrc/`):
  sorted_probe   — join probe: a binary search per query; its
                   `probe_positions` entry also clamps, in the same launch
                   (`csrc/sorted_probe.cu`)
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
  rwkv6_scan     — the RWKV-6 WKV recurrence, with an optional state in and
                   out, every rwkv6 prefill layer under use_kernel=True
                   (`csrc/rwkv6_scan.cu`)
  linear_scan    — the RG-LRU's diagonal recurrence h_t = a_t h_{t-1} + b_t
                   with an optional h0, every RG-LRU prefill layer under
                   use_kernel=True (`csrc/linear_scan.cu`)

`megakernel.py` plans and runs the fused spans, `ops.py` holds the wrappers
and launch counts, `ref.py` the plain torch versions, `build.py` the nvcc
build.
"""
