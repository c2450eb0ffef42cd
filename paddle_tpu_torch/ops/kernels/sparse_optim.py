"""Fused sparse Adagrad and Adam updates: hand-written CUDA kernels for
Hopper beside their plain torch versions.

Parity: the JAX package's ops/kernels/sparse_optim.py (fused_sparse_adagrad
:97, fused_sparse_adam :134). The TPU kernels replaced are its two
pallas_calls (:109 over _adagrad_kernel :57, :149 over _adam_kernel :72);
the CUDA source and its design note are paddle_tpu_torch/csrc/
sparse_optim.cu.

The contract is the JAX one. The inputs are _merge_sparse's output (uids
[N], merged gradient rows gm [N, D], valid [N]; invalid slots carry id 0
and zero rows) and the full tables [V, D]. `lr` is a device scalar tensor
(Adam's already bias-corrected), so nothing waits for the card. Invalid
slots are exact no-ops. Unlike the JAX functions these update the tables
IN PLACE, as the TPU kernel does through input_output_aliases, and return
them: only the touched rows move.

Dispatch is by the tables' device, with no fallback and no switch: a CUDA
tensor launches the kernel (built at first use) or raises; a CPU tensor
takes the plain version.
"""
import ctypes

import torch

from .._cuda import CudaKernel

__all__ = ['fused_sparse_adagrad', 'fused_sparse_adam',
           'fused_sparse_adagrad_plain', 'fused_sparse_adam_plain',
           'KERNEL_ADAGRAD', 'KERNEL_ADAM']

KERNEL_ADAGRAD = CudaKernel(
    name='sparse_adagrad',
    source='csrc/sparse_optim.cu',
    entry='sparse_adagrad',
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p],
    # fused_sparse_adagrad's pallas_call (_adagrad_kernel :57)
    replaces='paddle_tpu/ops/kernels/sparse_optim.py:109')
KERNEL_ADAM = CudaKernel(
    name='sparse_adam',
    source='csrc/sparse_optim.cu',
    entry='sparse_adam',
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 5 + [ctypes.c_void_p],
    # fused_sparse_adam's pallas_call (_adam_kernel :72)
    replaces='paddle_tpu/ops/kernels/sparse_optim.py:149')

# what an invalid slot adds in the plain versions: x + (-0.0) is x, bit
# for bit, for every x (+0.0 included), so those slots are exact no-ops
# as the kernels' skipped stores are
_NO_OP = -0.0


def fused_sparse_adagrad_plain(p, m, uids, gm, valid, lr, eps):
    """The adagrad kernel's arithmetic in plain torch: gather the touched
    moment rows, the elementwise update of the JAX package's sparse
    adagrad rule (ops_impl/optim_ops.py:110-115), and index_add_ of the
    deltas into p and m in place. Returns (p, m)."""
    vm = valid[:, None]
    m_rows = m[uids]
    m_new = m_rows + gm * gm
    p_delta = -lr * gm / (torch.sqrt(m_new) + eps)
    p.index_add_(0, uids, torch.where(vm, p_delta, _NO_OP))
    m.index_add_(0, uids, torch.where(vm, m_new - m_rows, _NO_OP))
    return p, m


def fused_sparse_adam_plain(p, m1, m2, uids, gm, valid, lr, b1, b2, eps):
    """The adam kernel's arithmetic in plain torch (the JAX package's lazy
    sparse adam rule, ops_impl/optim_ops.py:150-157), updating p, m1 and
    m2 in place. `lr` is the bias-corrected rate. Returns (p, m1, m2)."""
    vm = valid[:, None]
    m1_rows, m2_rows = m1[uids], m2[uids]
    m1_new = b1 * m1_rows + (1 - b1) * gm
    m2_new = b2 * m2_rows + (1 - b2) * gm * gm
    p_delta = -lr * m1_new / (torch.sqrt(m2_new) + eps)
    p.index_add_(0, uids, torch.where(vm, p_delta, _NO_OP))
    m1.index_add_(0, uids, torch.where(vm, m1_new - m1_rows, _NO_OP))
    m2.index_add_(0, uids, torch.where(vm, m2_new - m2_rows, _NO_OP))
    return p, m1, m2


def _check(kernel, tables, uids, gm, valid, lr):
    """What the kernels take: fp32 contiguous tables of one [V, D] shape,
    the merge's int64 uids [N] (each valid one a row of the tables, as the
    lookup that made them checked), fp32 gm [N, D], bool valid [N] and a
    one-element fp32 lr, all contiguous on the tables' card."""
    p = tables[0]
    dev = p.device

    def bad(what):
        raise ValueError('%s kernel: %s' % (kernel.name, what))

    if p.dim() != 2:
        bad('tables must be [V, D], got %s' % (tuple(p.shape),))
    for t in tables:
        if t.dtype != torch.float32 or t.shape != p.shape \
                or not t.is_contiguous() or t.device != dev:
            bad('every table must be a contiguous float32 %s tensor on %s, '
                'got %s %s on %s' % (tuple(p.shape), dev, t.dtype,
                                     tuple(t.shape), t.device))
    n, d = uids.shape[0], p.shape[1]
    for name, t, dtypes, shape in (
            ('uids', uids, (torch.int64,), (n,)),
            ('gm', gm, (torch.float32,), (n, d)),
            ('valid', valid, (torch.bool,), (n,))):
        if t.dtype not in dtypes or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != dev:
            bad('%s must be a contiguous %s tensor of %s on %s, got %s %s '
                'on %s' % (name, '/'.join(str(x) for x in dtypes), shape,
                           dev, t.dtype, tuple(t.shape), t.device))
    if not isinstance(lr, torch.Tensor) or lr.dtype != torch.float32 \
            or lr.numel() != 1 or not lr.is_contiguous() \
            or lr.device != dev:
        bad('lr must be a one-element float32 tensor on %s' % dev)
    if n * d >= 2 ** 31:
        bad('%d slots of width %d exceed the grid' % (n, d))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(kernel, tables, uids, gm, valid, lr, *scalars):
    _check(kernel, tables, uids, gm, valid, lr)
    n, d = gm.shape
    if n == 0 or d == 0:
        return
    kernel.launch(*[t.data_ptr() for t in tables],
                  uids.data_ptr(), gm.data_ptr(), valid.data_ptr(),
                  lr.data_ptr(), n, d, *scalars, _stream(tables[0]))


def fused_sparse_adagrad(p, m, uids, gm, valid, lr, eps):
    """Apply the merged sparse adagrad update to p and m in place; returns
    (p, m). Invalid slots are exact no-ops."""
    if not p.is_cuda:
        return fused_sparse_adagrad_plain(p, m, uids, gm, valid, lr, eps)
    _launch(KERNEL_ADAGRAD, (p, m), uids, gm, valid, lr, float(eps))
    return p, m


def fused_sparse_adam(p, m1, m2, uids, gm, valid, lr, b1, b2, eps):
    """Apply the merged sparse adam update to p, m1 and m2 in place; `lr`
    is the bias-corrected rate. Returns (p, m1, m2)."""
    if not p.is_cuda:
        return fused_sparse_adam_plain(p, m1, m2, uids, gm, valid, lr, b1,
                                       b2, eps)
    # (1 - b) is formed in double and rounded to fp32 once, as the plain
    # version's python scalar is
    _launch(KERNEL_ADAM, (p, m1, m2), uids, gm, valid, lr, float(b1),
            float(1 - b1), float(b2), float(1 - b2), float(eps))
    return p, m1, m2
