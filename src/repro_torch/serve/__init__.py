"""Serving: quantize-once weight packing and the lockstep engine."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
