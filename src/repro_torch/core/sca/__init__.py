"""Static code analysis of black-box UDFs (paper Sec. 5).

Two analyzers produce the same `UdfProperties`:

* `bytecode`  — the paper-faithful port: conservative dataflow analysis over
  CPython bytecode (the paper analyses Java 3-address code with Soot).
* `trace_sca` — the tracing analyzer (port of `repro`'s jaxpr analyzer):
  runs the UDF on tensors under a dependence-tracking torch function mode
  and computes exact read/write dependence (beyond-paper; strictly
  tighter).

`analyze_udf` is the entry point; mode='auto' prefers the tracing analyzer
and falls back to bytecode when the UDF is untraceable.
"""

from .analyze import analyze_udf, infer_add_dtypes  # noqa: F401
