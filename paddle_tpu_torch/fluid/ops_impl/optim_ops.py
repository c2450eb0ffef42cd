"""Optimizer update rules, dense gradients.

Parity: the JAX package's fluid/ops_impl/optim_ops.py (sgd :60, adam :122,
adam_beta_pow_update :165; reference paddle/fluid/operators/{sgd,adam}_op.*);
momentum and adagrad wait with their optimizers (ROADMAP.md). Like the JAX
rules, these are pure: each returns new tensors and the Executor binds them
under the output names (the same vars as the inputs), so nothing is
updated in place and a tensor a caller fetched keeps its value. They run
after the autodiff marker, under torch.no_grad().

The SparseRows gradient branches (touched-rows updates for is_sparse
embeddings) and the fused sparse Adagrad/Adam kernels wait for the sparse
slice of the port; a sparse gradient raises here and is never densified.
"""
import torch

from ..lowering import register, data_of


def _dense_grad(ins, op_type):
    g = ins['Grad'][0]
    if not isinstance(g, torch.Tensor) or g.layout != torch.strided:
        raise NotImplementedError(
            '%s: sparse-row gradients (is_sparse=True embeddings) are not '
            'ported yet; the port will not densify them' % op_type)
    return data_of(g)


def _lr(ins):
    return data_of(ins['LearningRate'][0]).reshape(())


@register('sgd')
def _sgd(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    return {'ParamOut': p - _lr(ins) * _dense_grad(ins, 'sgd')}


@register('adam')
def _adam(ins, attrs, ctx):
    p = data_of(ins['Param'][0])
    g = _dense_grad(ins, 'adam')
    m1 = data_of(ins['Moment1'][0])
    m2 = data_of(ins['Moment2'][0])
    b1p = data_of(ins['Beta1Pow'][0]).reshape(())
    b2p = data_of(ins['Beta2Pow'][0]).reshape(())
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
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
