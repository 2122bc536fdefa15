"""Serving (port of `repro.serve`): the token-serving engine
(`serve.engine`) and the multi-tenant data-flow engine (`serve.dataflow`,
exported here)."""

from .dataflow import DataflowEngine, ServeConfig, ServeRequest

__all__ = ["DataflowEngine", "ServeConfig", "ServeRequest"]
