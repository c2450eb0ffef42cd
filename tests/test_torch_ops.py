"""Every op rule of the PyTorch port (paddle_tpu_torch.fluid.ops_impl)
against the JAX package's rule for the same op type, on the same numpy
inputs, at 1e-6 (fp32 on the CPU in both; only summation orders differ).
Random ops cannot share bits across the two frameworks' generators: they
are held to their distribution, shape and dtype instead."""
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


def _run_both(op_type, ins, attrs, is_test=False):
    """ins: {slot: [ndarray, ...]} -> (jax outs, torch outs) as numpy."""
    jctx = jlow.Ctx(jax.random.key(0), is_test=is_test, platform='cpu')
    jouts = jlow.get_rule(op_type)(
        {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        attrs, jctx)
    gen = torch.Generator()
    gen.manual_seed(0)
    tctx = tlow.Ctx(torch.device('cpu'), gen, is_test=is_test)
    touts = tlow.get_rule(op_type)(
        {s: [torch.from_numpy(np.array(a)) for a in vs]
         for s, vs in ins.items()}, attrs, tctx)
    return jouts, touts


def _check(op_type, ins, attrs, slots=('Out',), is_test=False, tol=TOL):
    jouts, touts = _run_both(op_type, ins, attrs, is_test=is_test)
    for slot in slots:
        j, t = np.asarray(jouts[slot]), touts[slot].numpy()
        assert j.shape == t.shape, (slot, j.shape, t.shape)
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol,
                                   err_msg='%s.%s' % (op_type, slot))
    return jouts, touts


R = np.random.RandomState(0)


def _f32(*shape):
    return R.randn(*shape).astype('float32')


@pytest.mark.parametrize('padding_idx', [-1, 3])
@pytest.mark.parametrize('trailing_one', [False, True])
def test_lookup_table(padding_idx, trailing_one):
    ids = R.randint(0, 10, (2, 6)).astype('int64')
    ids[0, 0] = 3
    if trailing_one:
        ids = ids[..., None]
    _check('lookup_table', {'Ids': [ids], 'W': [_f32(10, 4)]},
           {'padding_idx': padding_idx, 'is_sparse': False,
            'is_distributed': False})


@pytest.mark.parametrize('xn', [1, 2])
def test_mul_flattens_at_x_num_col_dims(xn):
    x = _f32(2, 3, 8)
    y = _f32(24 if xn == 1 else 8, 5)
    _check('mul', {'X': [x], 'Y': [y]},
           {'x_num_col_dims': xn, 'y_num_col_dims': 1})


@pytest.mark.parametrize('op_type', ['elementwise_add', 'elementwise_sub',
                                     'elementwise_mul', 'elementwise_div'])
@pytest.mark.parametrize('yshape,axis', [((2, 5, 4), -1), ((5, 4), 1),
                                         ((4,), -1), ((2, 5), 0)])
def test_elementwise_broadcast_axis(op_type, yshape, axis):
    y = _f32(*yshape)
    if op_type == 'elementwise_div':
        y = np.abs(y) + 0.5
    _check(op_type, {'X': [_f32(2, 5, 4)], 'Y': [y]}, {'axis': axis})


@pytest.mark.parametrize('attrs', [
    {'scale': 1e9, 'bias': -1e9, 'bias_after_scale': True},
    {'scale': 22.6, 'bias': 0.0, 'bias_after_scale': True},
    {'scale': 0.5, 'bias': 2.0, 'bias_after_scale': False}])
def test_scale(attrs):
    x = R.randint(0, 2, (3, 7)).astype('float32') if attrs['scale'] == 1e9 \
        else _f32(3, 7)
    _check('scale', {'X': [x]}, attrs)


def test_clip_relu_cast():
    x = _f32(4, 6) * 3
    _check('clip', {'X': [x]}, {'min': 0.0, 'max': 1.0})
    _check('relu', {'X': [x]}, {})
    ids = R.randint(0, 5, (4, 6)).astype('int64')
    _check('cast', {'X': [ids]}, {'in_dtype': 'int64',
                                  'out_dtype': 'float32'})


@pytest.mark.parametrize('shape,new', [((2, 3, 8), [0, 0, 2, 4]),
                                       ((2, 3, 8), [-1, 8]),
                                       ((6, 1), [-1, 1])])
def test_reshape_copy_dims(shape, new):
    _check('reshape', {'X': [_f32(*shape)]}, {'shape': new})


def test_transpose():
    _check('transpose', {'X': [_f32(2, 3, 4, 5)]}, {'axis': [0, 2, 1, 3]})


def test_constant_ops():
    vals = _f32(4, 3)
    _check('assign_value', {}, {'shape': [4, 3], 'dtype': 'float32',
                                'values': vals.reshape(-1).tolist()})
    _check('fill_constant', {}, {'shape': [2, 5], 'dtype': 'float32',
                                 'value': 0.25})
    _check('assign', {'X': [vals]}, {})


@pytest.mark.parametrize('axis', [1, 2])
def test_layer_norm(axis):
    x = _f32(2, 3, 8) * 4 + 1
    n = int(np.prod(x.shape[axis:]))
    _check('layer_norm', {'X': [x], 'Scale': [_f32(n)], 'Bias': [_f32(n)]},
           {'epsilon': 1e-5, 'begin_norm_axis': axis},
           slots=('Y', 'Mean', 'Variance'))


def test_dropout_inference_scales_by_keep_probability():
    jouts, touts = _check('dropout', {'X': [_f32(4, 8)]},
                          {'dropout_prob': 0.1, 'is_test': True,
                           'fix_seed': False, 'seed': 0})
    assert jouts['Mask'] is None and touts['Mask'] is None


def test_dropout_training_masks_with_keep_probability():
    x = np.ones((200, 100), 'float32')
    _, touts = _run_both('dropout', {'X': [x]},
                         {'dropout_prob': 0.25, 'is_test': False,
                          'fix_seed': False, 'seed': 0})
    out, mask = touts['Out'].numpy(), touts['Mask'].numpy()
    assert set(np.unique(mask)) <= {0.0, 1.0}
    np.testing.assert_array_equal(out, x * mask)
    assert abs(mask.mean() - 0.75) < 0.02


@pytest.mark.parametrize('soft', [False, True])
def test_softmax_with_cross_entropy(soft):
    logits = _f32(6, 10)
    if soft:
        label = np.abs(_f32(6, 10))
        label /= label.sum(-1, keepdims=True)
    else:
        label = R.randint(0, 10, (6, 1)).astype('int64')
    _check('softmax_with_cross_entropy',
           {'Logits': [logits], 'Label': [label]}, {'soft_label': soft},
           slots=('Softmax', 'Loss'))


def test_one_hot_and_label_smooth():
    ids = R.randint(0, 7, (5, 1)).astype('int64')
    ids[0, 0] = -1     # out of range: an all-zero row in both
    _check('one_hot', {'X': [ids]}, {'depth': 7})
    _check('label_smooth', {'X': [np.eye(7, dtype='float32')[:5]]},
           {'epsilon': 0.1})


@pytest.mark.parametrize('attrs', [
    {'dim': [0], 'keep_dim': False, 'reduce_all': True},
    {'dim': [1], 'keep_dim': True, 'reduce_all': False},
    {'dim': [0, 2], 'keep_dim': False, 'reduce_all': False}])
def test_reduce_sum(attrs):
    _check('reduce_sum', {'X': [_f32(3, 4, 5)]}, attrs)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('bias_shape', ['BT', 'B11T', None])
def test_flash_attention_rule(causal, bias_shape):
    B, H, T, D = 2, 2, 9, 8
    ins = {'Q': [_f32(B, H, T, D)], 'K': [_f32(B, H, T, D)],
           'V': [_f32(B, H, T, D)]}
    if bias_shape:
        kb = np.where(R.rand(B, T) < 0.3, -1e9, 0.0).astype('float32')
        kb[:, 0] = 0.0
        ins['KeyBias'] = [kb if bias_shape == 'BT' else kb[:, None, None]]
    _check('flash_attention', ins, {'causal': causal, 'scale': -1.0})


@pytest.mark.parametrize('op_type,attrs,mean,std', [
    ('gaussian_random', {'mean': 0.5, 'std': 2.0}, 0.5, 2.0),
    ('uniform_random', {'min': -1.0, 'max': 3.0}, 1.0, 4 / 12 ** 0.5)])
def test_random_initializers_hold_their_distribution(op_type, attrs, mean,
                                                     std):
    attrs = dict(attrs, shape=[200, 100], dtype='float32', seed=0)
    jouts, touts = _run_both(op_type, {}, attrs)
    for out in (np.asarray(jouts['Out']), touts['Out'].numpy()):
        assert out.shape == (200, 100) and out.dtype == np.float32
        assert abs(out.mean() - mean) < 0.05 * std * 4
        assert abs(out.std() - std) < 0.05 * std


def test_every_port_rule_has_a_jax_counterpart():
    assert set(tlow._RULES) <= set(jlow._RULES)
