"""Fused sparse Adagrad and Adam updates: hand-written CUDA kernels for
Hopper beside their plain torch versions.

Parity: the JAX package's ops/kernels/sparse_optim.py (fused_sparse_adagrad
:97, fused_sparse_adam :134). The TPU kernels replaced are its two
pallas_calls (:109 over _adagrad_kernel :57, :149 over _adam_kernel :72);
the CUDA source and its design note are paddle_tpu_torch/csrc/
sparse_optim.cu.

Two ways in, one kernel per optimizer:

* the merged form, the JAX contract: fused_sparse_adagrad / _adam take
  merge_rows' output (uids [N], merged gradient rows gm [N, D], valid
  [N]; invalid slots carry id 0 and zero rows) and the full tables
  [V, D]. Invalid slots are exact no-ops.
* the rows form, the sparse rules' path: fused_sparse_adagrad_rows /
  _adam_rows take the gradient as it comes (ids [C] with repeats, rows
  [C, D]). On the card the ids are sorted (sort_ids) and ONE launch sums
  each id's rows in sorted order and updates its table row, so the merge
  costs no launches of its own and is deterministic. Its plain version is
  merge_rows and then the merged form's plain version.

`lr` is a device scalar tensor (Adam's already bias-corrected), so nothing
waits for the card. Unlike the JAX functions these update the tables IN
PLACE, as the TPU kernel does through input_output_aliases, and return
them: only the touched rows move.

Dispatch is by the tables' device, with no fallback and no switch: a CUDA
tensor launches the kernel (built at first use) or raises; a CPU tensor
takes the plain version.
"""
import ctypes

import torch
from torch.profiler import record_function

from ...embedding.lookup import dedup_plan
from .._cuda import CudaKernel

__all__ = ['fused_sparse_adagrad', 'fused_sparse_adam',
           'fused_sparse_adagrad_plain', 'fused_sparse_adam_plain',
           'fused_sparse_adagrad_rows', 'fused_sparse_adam_rows',
           'fused_sparse_adagrad_rows_plain', 'fused_sparse_adam_rows_plain',
           'merge_rows', 'sort_ids', 'launch_sorted',
           'KERNEL_ADAGRAD', 'KERNEL_ADAM']

# the C entry points' leading arguments: the tables, ids, id width, order,
# rows, valid, lr, n, d
_COMMON = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int]
KERNEL_ADAGRAD = CudaKernel(
    name='sparse_adagrad',
    source='csrc/sparse_optim.cu',
    entry='sparse_adagrad',
    argtypes=[ctypes.c_void_p] * 2 + _COMMON + [ctypes.c_float,
                                                ctypes.c_void_p],
    # fused_sparse_adagrad's pallas_call (_adagrad_kernel :57)
    replaces='paddle_tpu/ops/kernels/sparse_optim.py:109')
KERNEL_ADAM = CudaKernel(
    name='sparse_adam',
    source='csrc/sparse_optim.cu',
    entry='sparse_adam',
    argtypes=[ctypes.c_void_p] * 3 + _COMMON + [ctypes.c_float] * 5
    + [ctypes.c_void_p],
    # fused_sparse_adam's pallas_call (_adam_kernel :72)
    replaces='paddle_tpu/ops/kernels/sparse_optim.py:149')
# the kernel of each optimizer, by its number of tables
_BY_TABLES = {2: KERNEL_ADAGRAD, 3: KERNEL_ADAM}

# what an invalid slot adds in the plain versions: x + (-0.0) is x, bit
# for bit, for every x (+0.0 included), so those slots are exact no-ops
# as the kernels' skipped stores are
_NO_OP = -0.0


def merge_rows(ids, rows):
    """Merge duplicate ids (reference MergeAdd, operators/math/
    selected_rows_functor.cc), static shapes, through dedup_plan: returns
    (uids [C], merged [C, D], valid bool [C]) where the slots past the
    unique count carry id 0 and zero rows. Each id's rows are added in
    ascending sorted position from 0.0 (index_add_ on the CPU; on the
    card its atomics add them in run-to-run order)."""
    n = ids.shape[0]
    uids, seg, order, n_unique = dedup_plan(ids)
    merged = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                         device=rows.device)
    merged.index_add_(0, seg, rows[order])
    valid = torch.arange(n, device=ids.device) < n_unique
    # invalid slots carry dedup_plan's sentinel id: clamp it to 0 so the
    # moment gathers at uids stay in bounds (the updates skip those slots)
    uids = torch.where(valid, uids, torch.zeros_like(uids))
    return uids, merged, valid


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


def fused_sparse_adagrad_rows_plain(p, m, ids, rows, lr, eps):
    """The rows form in plain torch: merge_rows, then the merged form's
    plain update. Returns (p, m)."""
    return fused_sparse_adagrad_plain(p, m, *merge_rows(ids, rows), lr, eps)


def fused_sparse_adam_rows_plain(p, m1, m2, ids, rows, lr, b1, b2, eps):
    """The rows form in plain torch: merge_rows, then the merged form's
    plain update. Returns (p, m1, m2)."""
    return fused_sparse_adam_plain(p, m1, m2, *merge_rows(ids, rows), lr,
                                   b1, b2, eps)


def _bad(kernel, what):
    raise ValueError('%s kernel: %s' % (kernel.name, what))


def _check(kernel, tables, lr, named):
    """What the kernels take: fp32 contiguous tables of one [V, D] shape, a
    one-element fp32 lr, and the `named` (name, tensor, dtypes, shape)
    inputs, all contiguous on the tables' card."""
    p = tables[0]
    dev = p.device
    if p.dim() != 2:
        _bad(kernel, 'tables must be [V, D], got %s' % (tuple(p.shape),))
    for t in tables:
        if t.dtype != torch.float32 or t.shape != p.shape \
                or not t.is_contiguous() or t.device != dev:
            _bad(kernel, 'every table must be a contiguous float32 %s tensor '
                 'on %s, got %s %s on %s' % (tuple(p.shape), dev, t.dtype,
                                             tuple(t.shape), t.device))
    for name, t, dtypes, shape in named:
        if t.dtype not in dtypes or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != dev:
            _bad(kernel, '%s must be a contiguous %s tensor of %s on %s, got '
                 '%s %s on %s' % (name, '/'.join(str(x) for x in dtypes),
                                  shape, dev, t.dtype, tuple(t.shape),
                                  t.device))
    if not isinstance(lr, torch.Tensor) or lr.dtype != torch.float32 \
            or lr.numel() != 1 or not lr.is_contiguous() \
            or lr.device != dev:
        _bad(kernel, 'lr must be a one-element float32 tensor on %s' % dev)
    n, d = named[0][3][0], p.shape[1]
    if n * d >= 2 ** 31:
        _bad(kernel, '%d slots of width %d exceed the grid' % (n, d))


def _scalars(n_tables, hyper):
    """The kernel's float arguments: (eps,) for Adagrad; (b1, 1 - b1, b2,
    1 - b2, eps) for Adam, (1 - b) formed in double and rounded to fp32
    once, as the plain version's python scalar is."""
    if n_tables == 2:
        (eps,) = hyper
        return (float(eps),)
    b1, b2, eps = hyper
    return (float(b1), float(1 - b1), float(b2), float(1 - b2), float(eps))


def _launch(tables, ids, order, g, valid, lr, hyper):
    kernel = _BY_TABLES[len(tables)]
    n, d = g.shape
    if n == 0 or d == 0:
        return
    kernel.launch(*[t.data_ptr() for t in tables], ids.data_ptr(),
                  ids.element_size(),
                  None if order is None else order.data_ptr(), g.data_ptr(),
                  None if valid is None else valid.data_ptr(), lr.data_ptr(),
                  n, d, *_scalars(len(tables), hyper),
                  torch.cuda.current_stream(tables[0].device).cuda_stream)


def _launch_merged(tables, uids, gm, valid, lr, hyper):
    n, d = uids.shape[0], tables[0].shape[1]
    _check(_BY_TABLES[len(tables)], tables, lr, (
        ('uids', uids, (torch.int64,), (n,)),
        ('gm', gm, (torch.float32,), (n, d)),
        ('valid', valid, (torch.bool,), (n,))))
    _launch(tables, uids, None, gm, valid, lr, hyper)


def sort_ids(ids, vocab):
    """The rows form's sort on the card: (ids sorted, stable order [C]
    int64, sorted position -> occurrence). Ids of a vocabulary that fits
    int32 are sorted as int32 (half the key width of the radix sort, as
    the JAX merge sorts them). A torch sort, as the JAX package leaves its
    sort to XLA: id bookkeeping, not a TPU kernel."""
    with record_function('sparse_optim.sort_ids'):
        if vocab < 2 ** 31 and ids.dtype != torch.int32:
            ids = ids.to(torch.int32)
        return torch.sort(ids, stable=True)


def launch_sorted(tables, sids, order, rows, lr, *hyper):
    """One launch of the rows-form kernel on ids sort_ids has sorted:
    Adagrad on two tables (hyper: eps), Adam on three (hyper: b1, b2,
    eps). Updates the tables in place."""
    n, d = rows.shape[0], tables[0].shape[1]
    if not tables[0].is_cuda:
        _bad(_BY_TABLES[len(tables)], 'launch_sorted runs the kernel on the '
             'card; CPU tensors take the rows form\'s plain version')
    _check(_BY_TABLES[len(tables)], tables, lr, (
        ('sorted ids', sids, (torch.int32, torch.int64), (n,)),
        ('order', order, (torch.int64,), (n,)),
        ('rows', rows, (torch.float32,), (n, d))))
    _launch(tables, sids, order, rows, None, lr, hyper)


def _rows_form(tables, ids, rows, lr, hyper):
    n, d = rows.shape[0], tables[0].shape[1]
    # the ids and rows as they come, before the sort touches them
    _check(_BY_TABLES[len(tables)], tables, lr, (
        ('ids', ids, (torch.int32, torch.int64), (n,)),
        ('rows', rows, (torch.float32,), (n, d))))
    sids, order = sort_ids(ids, tables[0].shape[0])
    _launch(tables, sids, order, rows, None, lr, hyper)


def fused_sparse_adagrad(p, m, uids, gm, valid, lr, eps):
    """Apply the merged sparse adagrad update to p and m in place; returns
    (p, m). Invalid slots are exact no-ops."""
    if not p.is_cuda:
        return fused_sparse_adagrad_plain(p, m, uids, gm, valid, lr, eps)
    _launch_merged((p, m), uids, gm, valid, lr, (eps,))
    return p, m


def fused_sparse_adam(p, m1, m2, uids, gm, valid, lr, b1, b2, eps):
    """Apply the merged sparse adam update to p, m1 and m2 in place; `lr`
    is the bias-corrected rate. Returns (p, m1, m2)."""
    if not p.is_cuda:
        return fused_sparse_adam_plain(p, m1, m2, uids, gm, valid, lr, b1,
                                       b2, eps)
    _launch_merged((p, m1, m2), uids, gm, valid, lr, (b1, b2, eps))
    return p, m1, m2


def fused_sparse_adagrad_rows(p, m, ids, rows, lr, eps):
    """Apply sparse adagrad for the gradient rows [C, D] of ids [C]
    (repeats summed first) to p and m in place; returns (p, m)."""
    if not p.is_cuda:
        return fused_sparse_adagrad_rows_plain(p, m, ids, rows, lr, eps)
    _rows_form((p, m), ids, rows, lr, (eps,))
    return p, m


def fused_sparse_adam_rows(p, m1, m2, ids, rows, lr, b1, b2, eps):
    """Apply lazy sparse adam for the gradient rows [C, D] of ids [C]
    (repeats summed first) to p, m1 and m2 in place; `lr` is the
    bias-corrected rate. Returns (p, m1, m2)."""
    if not p.is_cuda:
        return fused_sparse_adam_rows_plain(p, m1, m2, ids, rows, lr, b1,
                                            b2, eps)
    _rows_form((p, m1, m2), ids, rows, lr, (b1, b2, eps))
    return p, m1, m2
