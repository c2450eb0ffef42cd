"""Model builders of the port (parity: paddle_tpu.models)."""
from . import transformer  # noqa: F401

__all__ = ['transformer']
