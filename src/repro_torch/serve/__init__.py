"""Serving (port of `repro.serve`): the token-serving engine so far."""
