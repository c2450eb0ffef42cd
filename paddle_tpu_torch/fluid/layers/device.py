"""Device placement helpers (parity: the JAX package's
fluid/layers/device.py and the reference layers/device.py get_places). The
port counts the CUDA cards where the JAX package counts jax.devices()."""
__all__ = []


def get_places(device_count=None, device_type=None):
    """[0, ..., n - 1] for n = device_count, else the number of CUDA cards
    (at least 1: the CPU when there is none)."""
    import torch
    n = device_count or max(torch.cuda.device_count(), 1)
    return list(range(n))
