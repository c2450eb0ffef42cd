"""Optimizer update rules.

Parity: the JAX package's fluid/ops_impl/optim_ops.py (_merge_sparse :19,
sgd :60, adagrad :88, adam :122, adam_beta_pow_update :165; reference
paddle/fluid/operators/{sgd,adagrad,adam}_op.*); momentum waits with its
optimizer (ROADMAP.md). They run after the autodiff marker, under
torch.no_grad().

Dense gradients: the rules are pure, as in the JAX package. Each returns
new tensors and the Executor binds them under the output names (the same
vars as the inputs), so a tensor a caller fetched keeps its value.

SparseRows gradients (is_sparse embedding tables, fluid/executor.py):
only the touched rows change. SGD is linear, so its rows are index_add_-ed
as they come, duplicates and all. Adagrad and Adam are not: their merge
(_merge_sparse) sums the rows of each id first, then the fused kernels
(ops/kernels/sparse_optim.py) update the merged rows. Those two branches
are the one place where a rule is not pure: they update the table and its
moments IN PLACE and return them, as the TPU kernel does through
input_output_aliases, so the vocab-sized tables are never copied. The
tensors the scope holds change under the caller: a tensor fetched with
return_numpy=False aliases them, a numpy fetch is a copy and keeps its
value. A dense rule handed a SparseRows raises; it never densifies.
"""
import torch
from torch.profiler import record_function

from ...embedding.lookup import dedup_plan
from ...ops.kernels import fused_sparse_adagrad, fused_sparse_adam
from ..lowering import register, data_of, SparseRows


def _dense_grad(ins, op_type):
    g = ins['Grad'][0]
    if isinstance(g, SparseRows) or g.layout != torch.strided:
        raise NotImplementedError(
            '%s: no sparse-row branch for this rule; the port will not '
            'densify a sparse gradient' % op_type)
    return data_of(g)


def _lr(ins):
    return data_of(ins['LearningRate'][0]).reshape(())


def _merge_sparse(g):
    """Merge duplicate ids of a SparseRows grad (reference MergeAdd,
    operators/math/selected_rows_functor.cc): nonlinear updates (adagrad's
    g^2, adam's moments) must see each touched row ONCE with its summed
    gradient. Static shapes, through embedding.lookup.dedup_plan: returns
    (uids [N], merged [N, D], valid bool [N]) where the slots past the
    unique count carry id 0 and zero rows. The JAX package's pinning of
    these intermediates under a mesh waits for the parallel slice."""
    ids, rows = g.ids, g.rows
    n = ids.shape[0]
    # a torch.profiler range (tools/torch_train_profile.py reads the
    # merge's device time from it); without a profiler it costs ~1 us
    with record_function('optim.merge_sparse'):
        uids, seg, order, n_unique = dedup_plan(ids)
        merged = torch.zeros((n,) + tuple(rows.shape[1:]),
                             dtype=rows.dtype, device=rows.device)
        merged.index_add_(0, seg, rows[order])
        valid = torch.arange(n, device=ids.device) < n_unique
        # invalid slots carry dedup_plan's sentinel id: clamp it to 0 so
        # the moment gathers at uids stay in bounds (the updates skip
        # those slots)
        uids = torch.where(valid, uids, torch.zeros_like(uids))
    return uids, merged, valid


@register('sgd')
def _sgd(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = ins['Grad'][0]
    if isinstance(g, SparseRows):
        # index-based row update (reference sgd_op.h SelectedRows branch):
        # duplicates add up as in the dense gradient, and the vocab-sized
        # gradient never exists. Pure, like the dense branch.
        return {'ParamOut': p.index_add(0, g.ids, -_lr(ins) * g.rows)}
    return {'ParamOut': p - _lr(ins) * _dense_grad(ins, 'sgd')}


@register('adagrad')
def _adagrad(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = ins['Grad'][0]
    m = data_of(ins['Moment'][0])
    eps = attrs.get('epsilon', 1e-6)
    lr = _lr(ins)
    if isinstance(g, SparseRows):
        # touched rows only, on merged duplicates (reference adagrad_op.h
        # SelectedRows branch: MergeAdd, then the per-row update), in place
        uids, gm, valid = _merge_sparse(g)
        p_out, m_out = fused_sparse_adagrad(p, m, uids, gm, valid, lr, eps)
        return {'ParamOut': p_out, 'MomentOut': m_out}
    g = _dense_grad(ins, 'adagrad')
    m_out = m + g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {'ParamOut': p_out, 'MomentOut': m_out}


@register('adam')
def _adam(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = ins['Grad'][0]
    m1 = data_of(ins['Moment1'][0])
    m2 = data_of(ins['Moment2'][0])
    b1p = data_of(ins['Beta1Pow'][0]).reshape(())
    b2p = data_of(ins['Beta2Pow'][0]).reshape(())
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    if isinstance(g, SparseRows):
        # lazy SelectedRows semantics (reference adam_op.h sparse branch):
        # only touched rows' moments decay and update, each row once with
        # its merged gradient; lr is already bias-corrected, as the kernel
        # applies it per row. In place.
        uids, gm, valid = _merge_sparse(g)
        p_out, m1_out, m2_out = fused_sparse_adam(
            p, m1, m2, uids, gm, valid, lr, b1, b2, eps)
        return {'ParamOut': p_out, 'Moment1Out': m1_out,
                'Moment2Out': m2_out}
    g = _dense_grad(ins, 'adam')
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr * m1_out / (torch.sqrt(m2_out) + eps)
    return {'ParamOut': p_out, 'Moment1Out': m1_out, 'Moment2Out': m2_out}


@register('adam_beta_pow_update')
def _adam_beta_pow_update(ins, attrs, ctx):
    b1p = data_of(ins['Beta1Pow'][0])
    b2p = data_of(ins['Beta2Pow'][0])
    return {'Beta1PowOut': b1p * attrs.get('beta1', 0.9),
            'Beta2PowOut': b2p * attrs.get('beta2', 0.999)}
