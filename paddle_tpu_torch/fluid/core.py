"""Device places and dtype helpers.

Parity: reference paddle/fluid/platform/place.h (CPUPlace/CUDAPlace) and the
JAX package's fluid/core.py. Here a Place names a torch.device: CUDAPlace is
a real CUDA place (the JAX package aliases it to its TPU place), and
TPUPlace stays as an alias of CUDAPlace so code written against the JAX
package keeps running. A CUDAPlace on a machine without a usable card
raises when it is asked for its device — the port never drops to the CPU
on its own.
"""
import numpy as np
import torch

__all__ = ['Place', 'CPUPlace', 'CUDAPlace', 'TPUPlace', 'CUDAPinnedPlace',
           'is_compiled_with_cuda', 'get_cuda_device_count',
           'convert_dtype', 'torch_dtype']


class Place(object):
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    def __init__(self):
        super(CPUPlace, self).__init__(0)

    def torch_device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    """One CUDA card (reference platform::CUDAPlace)."""

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                '%r: no CUDA device is available; pass CPUPlace() to run '
                'on the CPU' % (self,))
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise RuntimeError('%r: only %d CUDA device(s) present'
                               % (self, n))
        # fp32 products in full fp32 on the card, as on the JAX package's
        # CPU path: TF32 keeps ~3 decimal digits and would move the port
        # off the reference by more than the stated tolerances
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bf16 products (AMP) accumulate in fp32 throughout, as the JAX
        # rules' preferred_element_type=float32: no reduced-precision
        # split-K reduction (torch's default allows one)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        return torch.device('cuda', self.device_id)


# Alias so code written against the JAX package's accelerator place runs.
TPUPlace = CUDAPlace
CUDAPinnedPlace = CPUPlace


def is_compiled_with_cuda():
    return torch.cuda.is_available()


def get_cuda_device_count():
    return torch.cuda.device_count()


# Fluid VarDesc dtype enum compatibility (reference: framework.proto VarType).
class VarDesc(object):
    class VarType(object):
        BOOL = 0
        INT16 = 1
        INT32 = 2
        INT64 = 3
        FP16 = 4
        FP32 = 5
        FP64 = 6
        UINT8 = 20
        BF16 = 22


_DTYPE_ENUM_TO_NP = {
    VarDesc.VarType.BOOL: np.bool_,
    VarDesc.VarType.INT16: np.int16,
    VarDesc.VarType.INT32: np.int32,
    VarDesc.VarType.INT64: np.int64,
    VarDesc.VarType.FP16: np.float16,
    VarDesc.VarType.FP32: np.float32,
    VarDesc.VarType.FP64: np.float64,
    VarDesc.VarType.UINT8: np.uint8,
}

_TORCH_DTYPES = {
    'bool': torch.bool, 'uint8': torch.uint8, 'int8': torch.int8,
    'int16': torch.int16, 'int32': torch.int32, 'int64': torch.int64,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'float64': torch.float64,
}
_NAMES_OF_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype):
    """Normalize str / np.dtype / torch.dtype / VarType enum to a canonical
    dtype string ('float32', 'int64', 'bfloat16', ...)."""
    if isinstance(dtype, torch.dtype):
        return _NAMES_OF_TORCH[dtype]
    if isinstance(dtype, int):
        dtype = _DTYPE_ENUM_TO_NP[dtype]
    if dtype == 'bfloat16':
        return 'bfloat16'
    return np.dtype(dtype).name


def torch_dtype(dtype):
    """The torch.dtype of a Fluid dtype (any form convert_dtype takes)."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


def __getattr__(name):
    # reference book code instantiates Scope through `fluid.core.Scope`;
    # lazy alias to avoid a core <-> executor import cycle
    if name == 'Scope':
        from .executor import Scope
        return Scope
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
