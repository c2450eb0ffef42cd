"""Optimizer update rules.

Parity: the JAX package's fluid/ops_impl/optim_ops.py (_merge_sparse :19,
sgd :60, momentum :73, adagrad :88, adam :122, adam_beta_pow_update :165,
adamax :173, decayed_adagrad :192, rmsprop :204, adadelta :220, ftrl :236;
reference paddle/fluid/operators/{sgd,momentum,adagrad,adam,adamax,
decayed_adagrad,rmsprop,adadelta,ftrl}_op.*). They run after the autodiff
marker, under torch.no_grad(). Adamax, DecayedAdagrad, RMSProp, Adadelta
and Ftrl take dense gradients only.

Dense gradients: the rules are pure, as in the JAX package. Each returns
new tensors and the Executor binds them under the output names (the same
vars as the inputs), so a tensor a caller fetched keeps its value.

SparseRows gradients (is_sparse embedding tables, fluid/executor.py):
only the touched rows change. SGD is linear, so its rows are index_add_-ed
as they come, duplicates and all. Adagrad and Adam are not: each id's
rows are summed first, then its row updated, by the rows-form kernels
(ops/kernels/sparse_optim.py: one launch after the ids' sort on the card,
merge_rows and the plain update on the CPU). Those two branches
are the one place where a rule is not pure: they update the table and its
moments IN PLACE and return them, as the TPU kernel does through
input_output_aliases, so the vocab-sized tables are never copied. The
tensors the scope holds change under the caller: a tensor fetched with
return_numpy=False aliases them, a numpy fetch is a copy and keeps its
value. A dense rule handed a SparseRows raises; it never densifies.
"""
import torch
from torch.profiler import record_function

from ...ops.kernels import fused_sparse_adagrad_rows, \
    fused_sparse_adam_rows, merge_rows
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


def _promote(*ts):
    """The tensors cast to their common dtype as jnp promotes them: the
    learning rate is a 0-d fp32 array there, a strong type, so a bf16
    parameter (a net built on a bf16 data var declares its weights bf16)
    updates in fp32 and comes out fp32, as the JAX rules' do. torch would
    keep the bf16 of the dimensioned tensor. A no-op when all are fp32."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _merge_sparse(g):
    """Merge duplicate ids of a SparseRows grad (reference MergeAdd,
    operators/math/selected_rows_functor.cc) into (uids [N], merged [N, D],
    valid bool [N]), the merged form the JAX package's rules hand its
    kernels: ops/kernels/sparse_optim.merge_rows, whose slots past the
    unique count carry id 0 and zero rows. The rules' rows-form kernels
    merge inside their one launch on the card and through merge_rows on
    the CPU; this stays for the merged form's callers (its parity with the
    JAX merge, and the merged route timed against the rows form). The JAX
    package's pinning of these intermediates under a mesh waits for the
    parallel slice."""
    # a torch.profiler range (tools/torch_train_profile.py reads the
    # merge's device time from it); without a profiler it costs ~1 us
    with record_function('optim.merge_sparse'):
        return merge_rows(g.ids, g.rows)


@register('sgd')
def _sgd(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = ins['Grad'][0]
    if isinstance(g, SparseRows):
        # index-based row update (reference sgd_op.h SelectedRows branch):
        # duplicates add up as in the dense gradient, and the vocab-sized
        # gradient never exists. Pure, like the dense branch.
        return {'ParamOut': p.index_add(0, g.ids, -_lr(ins) * g.rows)}
    p, lr, g = _promote(p, _lr(ins), _dense_grad(ins, 'sgd'))
    return {'ParamOut': p - lr * g}


@register('momentum')
def _momentum(ins, attrs, ctx):
    """Dense only, as the JAX rule: v' = mu * v + g, then p - lr * v', or
    with use_nesterov p - (g + mu * v') * lr."""
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'momentum')
    v = data_of(ins['Velocity'][0])
    mu = attrs['mu']
    lr = _lr(ins)
    v_out = mu * v + g
    if attrs.get('use_nesterov', False):
        p, step, lr = _promote(p, g + mu * v_out, lr)
        p_out = p - step * lr
    else:
        p, lr, step = _promote(p, lr, v_out)
        p_out = p - lr * step
    return {'ParamOut': p_out, 'VelocityOut': v_out}


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
        p_out, m_out = fused_sparse_adagrad_rows(p, m, g.ids, g.rows, lr, eps)
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
        p_out, m1_out, m2_out = fused_sparse_adam_rows(
            p, m1, m2, g.ids, g.rows, lr, b1, b2, eps)
        return {'ParamOut': p_out, 'Moment1Out': m1_out,
                'Moment2Out': m2_out}
    g = _dense_grad(ins, 'adam')
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p, lr, m1_step, denom = _promote(p, lr, m1_out, torch.sqrt(m2_out) + eps)
    p_out = p - lr * m1_step / denom
    return {'ParamOut': p_out, 'Moment1Out': m1_out, 'Moment2Out': m2_out}


@register('adam_beta_pow_update')
def _adam_beta_pow_update(ins, attrs, ctx):
    b1p = data_of(ins['Beta1Pow'][0])
    b2p = data_of(ins['Beta2Pow'][0])
    return {'Beta1PowOut': b1p * attrs.get('beta1', 0.9),
            'Beta2PowOut': b2p * attrs.get('beta2', 0.999)}


@register('adamax')
def _adamax(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'adamax')
    m = data_of(ins['Moment'][0])
    inf_norm = data_of(ins['InfNorm'][0])
    b1p = data_of(ins['Beta1Pow'][0]).reshape(())
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, g.abs())
    p, lr, m_step, denom = _promote(p, _lr(ins) / (1 - b1p), m_out,
                                    inf_out + eps)
    return {'ParamOut': p - lr * m_step / denom, 'MomentOut': m_out,
            'InfNormOut': inf_out}


@register('decayed_adagrad')
def _decayed_adagrad(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'decayed_adagrad')
    m = data_of(ins['Moment'][0])
    decay = attrs.get('decay', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    m_out = decay * m + (1 - decay) * g * g
    p, lr, g, denom = _promote(p, _lr(ins), g, torch.sqrt(m_out) + eps)
    return {'ParamOut': p - lr * g / denom, 'MomentOut': m_out}


@register('rmsprop')
def _rmsprop(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'rmsprop')
    ms = data_of(ins['MeanSquare'][0])
    mom = data_of(ins['Moment'][0])
    rho = attrs.get('decay', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    ms_out = rho * ms + (1 - rho) * g * g
    mom_out = attrs.get('momentum', 0.0) * mom \
        + _lr(ins) * g / torch.sqrt(ms_out + eps)
    p, mom_out = _promote(p, mom_out)
    return {'ParamOut': p - mom_out, 'MomentOut': mom_out,
            'MeanSquareOut': ms_out}


@register('adadelta')
def _adadelta(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'adadelta')
    avg_sq_g = data_of(ins['AvgSquaredGrad'][0])
    avg_sq_u = data_of(ins['AvgSquaredUpdate'][0])
    rho = attrs.get('rho', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * g * g
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * update * update
    return {'ParamOut': p + update, 'AvgSquaredGradOut': g2,
            'AvgSquaredUpdateOut': u2}


@register('ftrl')
def _ftrl(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'ftrl')
    sq = data_of(ins['SquaredAccumulator'][0])
    lin = data_of(ins['LinearAccumulator'][0])
    l1 = attrs.get('l1', 0.0)
    l2 = attrs.get('l2', 0.0)
    lr_power = attrs.get('lr_power', -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if lr_power == -0.5:
        new_acc, old_acc = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        new_acc, old_acc = torch.pow(new_sq, -lr_power), \
            torch.pow(sq, -lr_power)
    new_lin = lin + g - (new_acc - old_acc) / lr * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    return {'ParamOut': pre / (new_acc / lr + 2 * l2),
            'SquaredAccumOut': new_sq, 'LinearAccumOut': new_lin}
