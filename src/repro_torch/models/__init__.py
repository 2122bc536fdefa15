"""The model plane (port of `repro.models`): the dense, rwkv6 and hybrid
families so far."""

from .config import ModelConfig  # noqa: F401
from .model import Model, make_model  # noqa: F401
