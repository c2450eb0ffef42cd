"""The op rules of the port's image and book models (conv2d, pool2d,
batch_norm, softmax, cross_entropy, top_k, accuracy, momentum) against the
JAX package's rule for the same op type, on the same numpy inputs, on the
CPU:

  * outputs within 1e-5 of each output's max |x| (conv2d 1e-4: products
    of depth up to 36 summed in other orders by two libraries); top_k's
    ids, accuracy's counts and the running stats' shapes exactly, top_k
    with tied values included;
  * the gradients of conv2d, pool2d and batch_norm (train mode) by
    torch.autograd against jax.grad of the JAX rule, for a random
    cotangent, within 1e-4 of each gradient's max |g|;
  * the rules on `meta` tensors (build-time shape inference) give the
    shapes the layers declare: batch_norm reads the conv's channels, and
    MNIST's fc sizes its weight from the second pool's shape.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid  # noqa: F401  (registers the JAX rules)
from paddle_tpu.fluid import lowering as jlow
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import lowering as tlow

TOL = 1e-5
CONV_TOL = 1e-4
GRAD_TOL = 1e-4
R = np.random.RandomState(11)


def _f32(*shape):
    return np.asarray(R.randn(*shape), 'float32')


def _jctx(is_test=False):
    return jlow.Ctx(jax.random.key(0), is_test=is_test, platform='cpu')


def _tctx(is_test=False):
    return tlow.Ctx(torch.device('cpu'), torch.Generator(), is_test=is_test)


def _run_both(op_type, ins, attrs, is_test=False):
    jouts = jlow.get_rule(op_type)(
        {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        attrs, _jctx(is_test))
    touts = tlow.get_rule(op_type)(
        {s: [torch.from_numpy(np.array(a)) for a in vs]
         for s, vs in ins.items()}, attrs, _tctx(is_test))
    return jouts, touts


def _close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _check(op_type, ins, attrs, slots=('Out',), tol=TOL, is_test=False):
    jouts, touts = _run_both(op_type, ins, attrs, is_test)
    for slot in slots:
        _close(touts[slot].detach().numpy(), np.asarray(jouts[slot]), tol,
               '%s.%s' % (op_type, slot))
    return jouts, touts


def _check_grads(op_type, ins, attrs, wrt, out_slot):
    """d(sum(out * cot))/d(ins[s]) for s in wrt: jax.grad of the JAX rule
    against torch.autograd through the port's rule."""
    out_shape = np.asarray(_run_both(op_type, ins, attrs)[0][out_slot]).shape
    cot = _f32(*out_shape)

    def jloss(*args):
        jins = {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()}
        for s, a in zip(wrt, args):
            jins[s] = [a]
        out = jlow.get_rule(op_type)(jins, attrs, _jctx())[out_slot]
        return jnp.sum(out * cot)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(ins[s][0]) for s in wrt])
    tins = {s: [torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    leaves = [tins[s][0].requires_grad_() for s in wrt]
    out = tlow.get_rule(op_type)(tins, attrs, _tctx())[out_slot]
    tgrads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for s, j, t in zip(wrt, jgrads, tgrads):
        _close(t.numpy(), np.asarray(j), GRAD_TOL, '%s d%s' % (op_type, s))


# -- conv2d --------------------------------------------------------------

CONV_CASES = {
    'plain': dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                  groups=1),
    'stride2_pad': dict(strides=[2, 2], paddings=[1, 2], dilations=[1, 1],
                        groups=1),
    'dilation2': dict(strides=[1, 1], paddings=[2, 2], dilations=[2, 2],
                      groups=1),
    'groups2': dict(strides=[1, 2], paddings=[1, 1], dilations=[1, 1],
                    groups=2),
}


def _conv_inputs(fmt, groups):
    x = _f32(2, 4, 9, 8)
    if fmt == 'NHWC':
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {'Input': [x], 'Filter': [_f32(6, 4 // groups, 3, 3)]}


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', sorted(CONV_CASES))
def test_conv2d(fmt, case):
    attrs = dict(CONV_CASES[case], data_format=fmt, use_cudnn=True)
    _check('conv2d', _conv_inputs(fmt, attrs['groups']), attrs,
           slots=('Output',), tol=CONV_TOL)


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', ['stride2_pad', 'groups2'])
def test_conv2d_gradients(fmt, case):
    attrs = dict(CONV_CASES[case], data_format=fmt)
    _check_grads('conv2d', _conv_inputs(fmt, attrs['groups']), attrs,
                 ('Input', 'Filter'), 'Output')


# -- pool2d --------------------------------------------------------------

POOL_CASES = {
    'max': dict(pooling_type='max', ksize=[2, 2], strides=[2, 2],
                paddings=[0, 0]),
    'max_pad': dict(pooling_type='max', ksize=[3, 3], strides=[2, 2],
                    paddings=[1, 1]),
    'avg': dict(pooling_type='avg', ksize=[3, 3], strides=[2, 2],
                paddings=[0, 0]),
    'avg_pad_exclusive': dict(pooling_type='avg', ksize=[3, 3],
                              strides=[2, 2], paddings=[1, 1],
                              exclusive=True),
    'avg_pad_inclusive': dict(pooling_type='avg', ksize=[3, 3],
                              strides=[2, 2], paddings=[1, 1],
                              exclusive=False),
    'avg_global': dict(pooling_type='avg', ksize=[7, 7], strides=[1, 1],
                       paddings=[0, 0], global_pooling=True),
    'max_global': dict(pooling_type='max', ksize=[1, 1], strides=[1, 1],
                       paddings=[0, 0], global_pooling=True),
    'max_ceil': dict(pooling_type='max', ksize=[3, 3], strides=[2, 2],
                     paddings=[0, 0], ceil_mode=True),
    'avg_ceil_exclusive': dict(pooling_type='avg', ksize=[3, 3],
                               strides=[2, 2], paddings=[1, 0],
                               ceil_mode=True, exclusive=True),
    'avg_ceil_inclusive': dict(pooling_type='avg', ksize=[2, 3],
                               strides=[3, 2], paddings=[0, 1],
                               ceil_mode=True, exclusive=False),
}


def _pool_x(fmt):
    x = _f32(2, 3, 10, 9)
    if fmt == 'NHWC':
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', sorted(POOL_CASES))
def test_pool2d(fmt, case):
    attrs = dict(POOL_CASES[case], data_format=fmt)
    _check('pool2d', {'X': [_pool_x(fmt)]}, attrs)


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', ['max_pad', 'avg_pad_exclusive',
                                  'avg_ceil_inclusive', 'avg_global',
                                  'max_ceil'])
def test_pool2d_gradients(fmt, case):
    attrs = dict(POOL_CASES[case], data_format=fmt)
    _check_grads('pool2d', {'X': [_pool_x(fmt)]}, attrs, ('X',), 'Out')


# -- batch_norm ----------------------------------------------------------

def _bn_inputs(fmt, ndim=4):
    shape = (4, 3, 5, 6)[:ndim]
    # an offset and a spread per channel, so the batch statistics matter
    x = _f32(*shape) * 1.5 + 0.7
    if fmt == 'NHWC' and ndim == 4:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {'X': [x], 'Scale': [_f32(3)], 'Bias': [_f32(3)],
            'Mean': [_f32(3) * 0.1],
            'Variance': [np.abs(_f32(3)) + 0.5]}


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('mode', ['train', 'test'])
def test_batch_norm(fmt, mode):
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': mode == 'test',
             'data_layout': fmt}
    jouts, touts = _check('batch_norm', _bn_inputs(fmt), attrs,
                          slots=('Y', 'MeanOut', 'VarianceOut',
                                 'SavedMean', 'SavedVariance'))
    assert touts['MeanOut'].shape == (3,)
    if mode == 'test':
        # the running stats go back out as the very tensors that came in
        ins = {s: [torch.from_numpy(np.array(a)) for a in vs]
               for s, vs in _bn_inputs(fmt).items()}
        outs = tlow.get_rule('batch_norm')(ins, attrs, _tctx())
        assert outs['MeanOut'] is ins['Mean'][0]
        assert outs['VarianceOut'] is ins['Variance'][0]


def test_batch_norm_after_an_fc():
    """A [N, C] input (batch norm after an fc): statistics over the batch
    only."""
    attrs = {'momentum': 0.5, 'epsilon': 1e-3, 'data_layout': 'NCHW'}
    _check('batch_norm', _bn_inputs('NCHW', ndim=2), attrs,
           slots=('Y', 'MeanOut', 'VarianceOut'))


def test_batch_norm_test_mode_from_the_ctx():
    """A program run for inference (ctx.is_test) normalizes with the
    running stats even where the op's own attr says train."""
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
             'data_layout': 'NCHW'}
    _check('batch_norm', _bn_inputs('NCHW'), attrs,
           slots=('Y', 'MeanOut', 'VarianceOut'), is_test=True)


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_batch_norm_gradients(fmt):
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'data_layout': fmt}
    _check_grads('batch_norm', _bn_inputs(fmt), attrs,
                 ('X', 'Scale', 'Bias'), 'Y')


# -- softmax, cross_entropy, top_k, accuracy -----------------------------

def test_softmax():
    _check('softmax', {'X': [_f32(5, 7) * 3]}, {})


def _probs(n, c):
    e = np.exp(_f32(n, c))
    return (e / e.sum(-1, keepdims=True)).astype('float32')


@pytest.mark.parametrize('soft', [False, True])
def test_cross_entropy(soft):
    x = _probs(6, 5)
    x[0, 2] = 0.0                       # log(0 + 1e-8): finite in both
    if soft:
        label = _probs(6, 5)
    else:
        label = R.randint(0, 5, (6, 1)).astype('int64')
        label[0, 0] = 2
    _check('cross_entropy', {'X': [x], 'Label': [label]},
           {'soft_label': soft}, slots=('Y',))


def _tied():
    """Rows with ties among the largest values, across the k-th place."""
    x = np.round(_f32(6, 10), 0).astype('float32')
    x[0] = 1.0                          # all tied
    x[1, [2, 5, 7]] = 9.0               # a three-way tie for first
    x[2, [0, 9]] = 4.0                  # tied across the cut at k 1
    # lax.top_k orders by the bits' total order: +0.0 above -0.0
    x[3] = [-0.0, 0.0, -0.0, 0.0, -1.0, -0.0, -2.0, 0.0, -3.0, -0.0]
    return x


@pytest.mark.parametrize('k', [1, 3, 5])
def test_top_k_keeps_the_lower_index_on_ties(k):
    jouts, touts = _check('top_k', {'X': [_tied()]}, {'k': k})
    np.testing.assert_array_equal(touts['Indices'].numpy(),
                                  np.asarray(jouts['Indices']))
    assert touts['Indices'].dtype == torch.int64
    if k == 3:
        assert touts['Indices'][0].tolist() == [0, 1, 2]
        assert touts['Indices'][1].tolist() == [2, 5, 7]
        assert touts['Indices'][3].tolist() == [1, 3, 7]


@pytest.mark.parametrize('k', [1, 5])
def test_accuracy(k):
    x = _tied()
    label = R.randint(0, 10, (6, 1)).astype('int64')
    label[1, 0] = 5
    jtop = jlow.get_rule('top_k')({'X': [jnp.asarray(x)]}, {'k': k},
                                  _jctx())
    ins = {'Out': [np.asarray(jtop['Out'])],
           'Indices': [np.asarray(jtop['Indices']).astype('int64')],
           'Label': [label]}
    jouts, touts = _check('accuracy', ins, {},
                          slots=('Accuracy', 'Correct', 'Total'))
    assert touts['Accuracy'].shape == (1,)
    for slot in ('Correct', 'Total'):
        assert touts[slot].dtype == torch.int32
        assert int(touts[slot]) == int(jouts[slot])
    assert int(touts['Total']) == 6


# -- momentum ------------------------------------------------------------

@pytest.mark.parametrize('nesterov', [False, True])
def test_momentum(nesterov):
    ins = {'Param': [_f32(4, 3)], 'Grad': [_f32(4, 3)],
           'Velocity': [_f32(4, 3)],
           'LearningRate': [np.array([0.05], 'float32')]}
    _check('momentum', ins, {'mu': 0.9, 'use_nesterov': nesterov},
           slots=('ParamOut', 'VelocityOut'))


def test_momentum_refuses_a_sparse_gradient():
    g = tlow.SparseRows(torch.tensor([1, 2]), torch.ones(2, 3), (4, 3))
    ins = {'Param': [torch.zeros(4, 3)], 'Grad': [g],
           'Velocity': [torch.zeros(4, 3)],
           'LearningRate': [torch.tensor([0.1])]}
    with pytest.raises(NotImplementedError, match='momentum'):
        tlow.get_rule('momentum')(ins, {'mu': 0.9}, _tctx())


# -- build-time shape inference -----------------------------------------

@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_layers_infer_their_shapes_on_meta_tensors(fmt):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        shape = [3, 32, 30] if fmt == 'NCHW' else [32, 30, 3]
        img = tfluid.layers.data(name='img', shape=shape)
        c = tfluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                 stride=2, padding=1, data_format=fmt)
        bn = tfluid.layers.batch_norm(c, act='relu', data_layout=fmt)
        p = tfluid.layers.pool2d(bn, pool_size=3, pool_stride=2,
                                 pool_type='avg', ceil_mode=True,
                                 data_format=fmt)
        g = tfluid.layers.pool2d(p, pool_type='max', global_pooling=True,
                                 data_format=fmt)
        prob = tfluid.layers.fc(g, size=5, act='softmax')
        vals, ids = tfluid.layers.topk(prob, 2)
    chw = lambda c_, h, w: (-1, c_, h, w) if fmt == 'NCHW' \
        else (-1, h, w, c_)                                  # noqa: E731
    assert c.shape == chw(8, 16, 15)
    assert bn.shape == chw(8, 16, 15)
    assert p.shape == chw(8, 8, 7)      # ceil_mode: (16 + 1 - 3) // 2 + 1
    assert g.shape == chw(8, 1, 1)
    assert prob.shape == (-1, 5)
    assert (vals.shape, ids.shape, ids.dtype) == ((-1, 2), (-1, 2), 'int64')
    params = {v.name: v.shape for v in main.all_parameters()}
    assert params['batch_norm_0.w_0'] == (8,)
    assert params['fc_0.w_0'] == (8, 5)


def test_mnist_sizes_its_fc_from_the_inferred_pool_shape():
    from paddle_tpu_torch.models import mnist
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name='pixel', shape=[1, 28, 28])
        predict = mnist.cnn_model(img)
    pools = [op.output('Out')[0] for op in main.global_block().ops
             if op.type == 'pool2d']
    assert main.global_block().var(pools[1]).shape == (-1, 50, 4, 4)
    assert predict.shape == (-1, 10)
    fc_w = [p for p in main.all_parameters() if p.name.startswith('fc')]
    assert fc_w[0].shape == (800, 10)
