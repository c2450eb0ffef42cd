"""The op rules the port's training steps add (noam_decay's arithmetic, the
optimizer updates, clip and regularizer ops, DeepFM's loss, activations
and auc) against the JAX package's rule for the same op type, on the same
numpy inputs, at 1e-6 (fp32 on the CPU in both; only summation orders
differ), as tests/test_torch_ops.py does for the serving rules."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid  # noqa: F401  (registers the JAX rules)
from paddle_tpu.fluid import lowering as jlow
import paddle_tpu_torch.fluid  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.fluid import lowering as tlow

TOL = 1e-6
R = np.random.RandomState(7)


def _f32(*shape):
    return np.asarray(R.randn(*shape), 'float32')


def _check(op_type, ins, attrs, slots=('Out',)):
    jctx = jlow.Ctx(jax.random.key(0), platform='cpu')
    jouts = jlow.get_rule(op_type)(
        {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        attrs, jctx)
    tctx = tlow.Ctx(torch.device('cpu'), torch.Generator())
    touts = tlow.get_rule(op_type)(
        {s: [torch.from_numpy(np.array(a)) for a in vs]
         for s, vs in ins.items()}, attrs, tctx)
    for slot in slots:
        j, t = np.asarray(jouts[slot]), touts[slot].numpy()
        if j.dtype == np.int32:     # the JAX package runs with x64 off
            j = j.astype(np.int64)
        assert j.shape == t.shape and j.dtype == t.dtype, \
            (slot, j.shape, t.shape, j.dtype, t.dtype)
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL,
                                   err_msg='%s.%s' % (op_type, slot))
    return touts


@pytest.mark.parametrize('op_type', ['elementwise_min', 'elementwise_max',
                                     'elementwise_pow'])
@pytest.mark.parametrize('yshape', [(3, 4), (4,), ()])
def test_binary_rules(op_type, yshape):
    x = np.abs(_f32(3, 4)) + 0.1
    y = _f32(*yshape) if op_type != 'elementwise_pow' \
        else np.full(yshape, -0.5, 'float32')
    _check(op_type, {'X': [x], 'Y': [y]}, {'axis': -1})


def test_noam_decay_arithmetic_on_the_step_counter():
    """counter [1] ** scalar () and min with the warmup ramp, as
    noam_decay builds them."""
    step = np.array([3.0], 'float32')
    _check('elementwise_pow', {'X': [step], 'Y': [np.array(-0.5, 'float32')]},
           {'axis': -1})
    _check('elementwise_min', {'X': [step ** -0.5], 'Y': [step * 4e-3]},
           {'axis': -1})


@pytest.mark.parametrize('x,step', [(np.array([0.0], 'float32'), 1.0),
                                    (np.array([41.0], 'float32'), 2.5),
                                    (np.array([7], 'int64'), 1.0)])
def test_increment_keeps_the_dtype(x, step):
    _check('increment', {'X': [x]}, {'step': step})


@pytest.mark.parametrize('op_type', ['sqrt', 'square', 'sign', 'sigmoid',
                                     'mean'])
def test_unary_rules(op_type):
    x = _f32(4, 5)
    if op_type == 'sqrt':
        x = np.abs(x)
    _check(op_type, {'X': [x]}, {})


def test_sum():
    _check('sum', {'X': [_f32(2, 3), _f32(2, 3), _f32(2, 3)]}, {})


def _lr(v=0.01):
    return np.array([v], 'float32')


def test_sgd():
    _check('sgd', {'Param': [_f32(5, 4)], 'Grad': [_f32(5, 4)],
                   'LearningRate': [_lr(0.3)]}, {}, slots=('ParamOut',))


@pytest.mark.parametrize('b1p,b2p', [(0.9, 0.98), (0.9 ** 7, 0.98 ** 7)])
def test_adam(b1p, b2p):
    _check('adam', {'Param': [_f32(6, 4)], 'Grad': [_f32(6, 4)],
                    'LearningRate': [_lr(2e-3)],
                    'Moment1': [_f32(6, 4) * 0.1],
                    'Moment2': [np.abs(_f32(6, 4)) * 0.01],
                    'Beta1Pow': [np.array([b1p], 'float32')],
                    'Beta2Pow': [np.array([b2p], 'float32')]},
           {'beta1': 0.9, 'beta2': 0.98, 'epsilon': 1e-9},
           slots=('ParamOut', 'Moment1Out', 'Moment2Out'))


def test_adagrad():
    _check('adagrad', {'Param': [_f32(6, 4)], 'Grad': [_f32(6, 4)],
                       'LearningRate': [_lr(0.05)],
                       'Moment': [np.abs(_f32(6, 4))]},
           {'epsilon': 1e-6}, slots=('ParamOut', 'MomentOut'))


@pytest.mark.parametrize('axis', [0, 1])
def test_concat(axis):
    _check('concat', {'X': [_f32(3, 2), _f32(3, 2), _f32(3, 2)]},
           {'axis': axis})


def test_sigmoid_cross_entropy_with_logits():
    x = _f32(8, 1) * 4
    x[0] = 0.0
    label = (R.rand(8, 1) > 0.5).astype('float32')
    _check('sigmoid_cross_entropy_with_logits', {'X': [x], 'Label': [label]},
           {})


@pytest.mark.parametrize('width', [1, 2])
def test_auc_carries_the_jax_histograms(width):
    """Histograms and AUC as the JAX rule computes them; a state carried
    from the JAX package arrives as int32 and leaves as int64."""
    prob = R.rand(64, 1).astype('float32')
    if width == 2:
        prob = np.concatenate([1 - prob, prob], axis=1)
    label = (R.rand(64, 1) > 0.4).astype('int64')
    stats = [R.randint(0, 9, 20).astype('int32') for _ in range(2)]
    _check('auc', {'Predict': [prob], 'Label': [label],
                   'StatPos': [stats[0]], 'StatNeg': [stats[1]]},
           {'num_thresholds': 20}, slots=('AUC', 'StatPosOut', 'StatNegOut'))


def test_adam_beta_pow_update():
    _check('adam_beta_pow_update',
           {'Beta1Pow': [np.array([0.81], 'float32')],
            'Beta2Pow': [np.array([0.9604], 'float32')]},
           {'beta1': 0.9, 'beta2': 0.98},
           slots=('Beta1PowOut', 'Beta2PowOut'))


@pytest.mark.parametrize('op_type', ['sgd', 'adam', 'adagrad'])
def test_a_sparse_gradient_raises_and_is_never_densified(op_type):
    """A torch sparse tensor is no SparseRows: every rule refuses it."""
    g = torch.sparse_coo_tensor([[1, 3]], torch.ones((2, 4)), (5, 4),
                                check_invariants=True)
    ins = {'Param': [torch.zeros((5, 4))], 'Grad': [g],
           'LearningRate': [torch.ones(1)],
           'Moment': [torch.zeros((5, 4))],
           'Moment1': [torch.zeros((5, 4))], 'Moment2': [torch.zeros((5, 4))],
           'Beta1Pow': [torch.ones(1) * 0.9],
           'Beta2Pow': [torch.ones(1) * 0.99]}
    with pytest.raises(NotImplementedError, match='sparse'):
        tlow.get_rule(op_type)(ins, {}, None)
