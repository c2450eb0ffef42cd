"""Model builders of the port (parity: paddle_tpu.models)."""
from . import deepfm  # noqa: F401
from . import transformer  # noqa: F401

__all__ = ['deepfm', 'transformer']
