"""The 14 vision rules the port's nn_ops.py gained with detection (conv3d,
conv2d_transpose, conv3d_transpose, pool3d; smooth_l1_loss, rank_loss,
dice_loss, huber_loss; lrn, prelu; bilinear_interp, nearest_interp;
roi_pool, mean_iou) and their layers, against the JAX package's on the
same numpy inputs, on the CPU:

  * each rule's outputs within 1e-5 of max(1, |x|), mean_iou's counts
    exactly, and the VJP of each differentiable one against jax.grad of
    the JAX rule within 1e-5 of max |g|; at the boundaries: smooth L1 at
    |d| = 1 / sigma^2, huber at |d| = delta and 0, prelu at x = 0, roi_pool
    with tied values in one bin (JAX's scatter-max splits the gradient);
    the transposed convs with groups and dilations; resize 2x up, 0.5x
    down, non-integer ratios (jax.image.resize antialiases a downscale)
    and output dims of 1, and the bilinear forward over every size in
    1..5;
  * the layers: one program of all 14 emits the JAX program op for op
    (but mean_iou's counts, int64 where the JAX program infers float32),
    and from the JAX startup scope its fetches and one SGD step's
    parameters match the JAX package's.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique

from test_torch_detection import _check, _check_vjp, _close
from test_torch_training import _normalized

R = np.random.RandomState(21)


def _f32(*shape):
    return np.asarray(R.randn(*shape), 'float32')


def _both(op_type, ins, attrs, slots, wrt, out_slot=None):
    _check(op_type, ins, attrs, slots)
    if wrt:
        _check_vjp(op_type, ins, attrs, wrt, out_slot or slots[0])


# -- convolutions -----------------------------------------------------------

CONV3D_CASES = {
    'plain': dict(strides=[1, 1, 1], paddings=[0, 0, 0],
                  dilations=[1, 1, 1], groups=1),
    'stride_pad': dict(strides=[2, 1, 2], paddings=[1, 2, 0],
                       dilations=[1, 1, 1], groups=1),
    'dilated_groups': dict(strides=[1, 1, 1], paddings=[2, 2, 2],
                           dilations=[2, 2, 2], groups=2),
}


@pytest.mark.parametrize('case', sorted(CONV3D_CASES))
def test_conv3d(case):
    attrs = CONV3D_CASES[case]
    ins = {'Input': [_f32(2, 4, 7, 6, 5)],
           'Filter': [_f32(6, 4 // attrs['groups'], 3, 3, 3)]}
    _both('conv3d', ins, attrs, ('Output',), ['Input', 'Filter'])


CONVT2D_CASES = {
    'plain': dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                  groups=1),
    'upsample_2x': dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1],
                        groups=1),
    'groups_dilation': dict(strides=[2, 1], paddings=[1, 2],
                            dilations=[2, 2], groups=2),
    'groups4_odd': dict(strides=[3, 2], paddings=[0, 1], dilations=[1, 3],
                        groups=4),
}


@pytest.mark.parametrize('case', sorted(CONVT2D_CASES))
def test_conv2d_transpose(case):
    attrs = CONVT2D_CASES[case]
    # filter [in_c, out_c / groups, kh, kw]: 2 outputs a group
    ins = {'Input': [_f32(2, 8, 5, 6)], 'Filter': [_f32(8, 2, 3, 4)]}
    _both('conv2d_transpose', ins, attrs, ('Output',), ['Input', 'Filter'])


@pytest.mark.parametrize('groups', [1, 2])
def test_conv3d_transpose(groups):
    """The JAX rule ignores groups: every input channel feeds each of the
    filter's outputs, in both packages."""
    attrs = dict(strides=[2, 1, 2], paddings=[1, 0, 1], dilations=[1, 2, 1],
                 groups=groups)
    ins = {'Input': [_f32(2, 4, 4, 5, 3)], 'Filter': [_f32(4, 3, 3, 2, 3)]}
    _both('conv3d_transpose', ins, attrs, ('Output',), ['Input', 'Filter'])


# -- pool3d ---------------------------------------------------------------

POOL3D_CASES = {
    'max': dict(pooling_type='max', ksize=[2, 2, 2], strides=[2, 2, 2],
                paddings=[0, 0, 0]),
    'max_pad_ceil': dict(pooling_type='max', ksize=[3, 3, 2],
                         strides=[2, 2, 2], paddings=[1, 1, 0],
                         ceil_mode=True),
    'avg_exclusive': dict(pooling_type='avg', ksize=[3, 3, 3],
                          strides=[2, 1, 2], paddings=[1, 1, 1]),
    'avg_inclusive_ceil': dict(pooling_type='avg', ksize=[2, 3, 3],
                               strides=[2, 2, 2], paddings=[0, 1, 1],
                               exclusive=False, ceil_mode=True),
    'global_avg': dict(pooling_type='avg', ksize=[1, 1, 1],
                       global_pooling=True),
}


@pytest.mark.parametrize('case', sorted(POOL3D_CASES))
def test_pool3d(case):
    x = _f32(2, 3, 7, 6, 5)
    x[0, 0, :2, :2, :2] = 1.5          # a tie inside a max window
    _both('pool3d', {'X': [x]}, POOL3D_CASES[case], ('Out',), ['X'])


# -- losses ---------------------------------------------------------------

@pytest.mark.parametrize('weights', [False, True])
@pytest.mark.parametrize('sigma', [1.0, 3.0])
def test_smooth_l1_loss_at_its_kink(sigma, weights):
    x, y = _f32(4, 3, 5), _f32(4, 3, 5)
    # |d| exactly 1 / sigma^2 on some elements, 0 on one
    x[0, 0, :2] = y[0, 0, :2] + np.float32(1.0 / sigma ** 2) * \
        np.float32([1, -1])
    x[1, 1, 1] = y[1, 1, 1]
    ins = {'X': [x], 'Y': [y]}
    if weights:
        ins['InsideWeight'] = [np.abs(_f32(4, 3, 5))]
        ins['OutsideWeight'] = [np.abs(_f32(4, 3, 5))]
    attrs = {'sigma': sigma}
    _check('smooth_l1_loss', ins, attrs, ('Out', 'Diff'))
    _check_vjp('smooth_l1_loss', ins, attrs, ['X', 'Y'], 'Out')


def test_rank_loss():
    label = (R.rand(6, 1) > 0.5).astype('float32')
    _both('rank_loss', {'Label': [label], 'Left': [_f32(6, 1)],
                        'Right': [_f32(6, 1)]}, {}, ('Out',),
          ['Left', 'Right'])


def test_dice_loss():
    x = np.abs(_f32(3, 4, 5))
    x /= x.sum(-1, keepdims=True)
    label = (R.rand(3, 4, 5) > 0.6).astype('int64')
    _both('dice_loss', {'X': [x], 'Label': [label]}, {'epsilon': 1e-5},
          ('Out',), ['X'])


@pytest.mark.parametrize('delta', [1.0, 0.5])
def test_huber_loss_at_delta_and_zero(delta):
    x, y = _f32(8, 1), _f32(8, 1)
    y[0] = x[0] + np.float32(delta)
    y[1] = x[1] - np.float32(delta)
    y[2] = x[2]
    _both('huber_loss', {'X': [x], 'Y': [y]}, {'delta': delta},
          ('Out', 'Residual'), ['X', 'Y'])


# -- lrn, prelu -------------------------------------------------------------

@pytest.mark.parametrize('n', [5, 3])
def test_lrn(n):
    attrs = {'n': n, 'k': 1.0, 'alpha': 1e-2, 'beta': 0.75}
    _both('lrn', {'X': [_f32(2, 7, 4, 3)]}, attrs, ('Out', 'MidOut'),
          ['X'])


@pytest.mark.parametrize('mode', ['all', 'channel', 'element'])
def test_prelu_at_zero(mode):
    x = _f32(2, 3, 4, 5)
    x[0, :, 0, :2] = 0.0
    alpha = {'all': _f32(1), 'channel': _f32(1, 3, 1, 1),
             'element': _f32(1, 3, 4, 5)}[mode]
    _both('prelu', {'X': [x], 'Alpha': [alpha]}, {'mode': mode}, ('Out',),
          ['X', 'Alpha'])


# -- resize ---------------------------------------------------------------

RESIZE_CASES = {'up_2x': (8, 6, 16, 12), 'down_half': (16, 12, 8, 6),
                'up_non_integer': (10, 7, 15, 9),
                'down_non_integer': (19, 19, 10, 7),
                'mixed': (5, 12, 11, 5), 'same_height': (6, 6, 6, 9),
                # an output dim of 1 (torch's own bilinear special-cases it)
                'to_width_1': (2, 1, 3, 1), 'to_height_1': (1, 2, 1, 3),
                'to_1x1': (5, 4, 1, 1), 'from_1x1': (1, 1, 4, 4)}


@pytest.mark.parametrize('op_type', ['bilinear_interp', 'nearest_interp'])
@pytest.mark.parametrize('case', sorted(RESIZE_CASES))
def test_resize(case, op_type):
    h, w, oh, ow = RESIZE_CASES[case]
    _both(op_type, {'X': [_f32(2, 3, h, w)]}, {'out_h': oh, 'out_w': ow},
          ('Out',), ['X'])


def test_bilinear_resize_sweeps_every_size_up_to_5():
    """Forward only: every h, w, out_h, out_w in 1..5 within 1e-5. The JAX
    rule runs jitted, one program an input size for all 25 output sizes
    (a compile a shape would take minutes)."""
    import itertools
    import jax
    from test_torch_detection import _jrule, _trule
    sizes = list(itertools.product(range(1, 6), repeat=2))

    @jax.jit
    def every_output(x):
        return [_jrule('bilinear_interp', {'X': [x]},
                       {'out_h': oh, 'out_w': ow})['Out']
                for oh, ow in sizes]

    for h, w in sizes:
        x = _f32(2, 3, h, w)
        for (oh, ow), want in zip(sizes, every_output(x)):
            got = _trule('bilinear_interp', {'X': [x]},
                         {'out_h': oh, 'out_w': ow})['Out']
            _close(got.numpy(), np.asarray(want),
                   'bilinear %dx%d -> %dx%d' % (h, w, oh, ow))


# -- roi_pool, mean_iou -----------------------------------------------------

@pytest.mark.parametrize('with_batch', [False, True])
def test_roi_pool_and_its_vjp_at_a_tied_bin(with_batch):
    x = _f32(2, 3, 12, 10)
    x[:, :, 2:4, 2:4] = 2.5            # four tied maxima in one bin
    rois = np.float32([[4, 4, 16, 14], [0, 0, 19, 23], [10, 6, 10, 6],
                       [8.2, 2.6, 15.4, 17.8], [2, 2, 3, 3]])
    if with_batch:
        rois = np.concatenate([np.float32([[0], [1], [1], [0], [1]]),
                               rois], 1)
    attrs = {'pooled_height': 3, 'pooled_width': 2, 'spatial_scale': 0.5}
    _both('roi_pool', {'X': [x], 'ROIs': [rois]}, attrs, ('Out',), ['X'])


def test_mean_iou():
    pred = R.randint(0, 5, (6, 7)).astype('int32')
    label = R.randint(0, 5, (6, 7)).astype('int32')
    label[label == 4] = 3              # class 4 only in the predictions
    _, touts = _check('mean_iou', {'Predictions': [pred],
                                   'Labels': [label]},
                      {'num_classes': 5},
                      ('OutMeanIou',))
    cm = np.zeros((5, 5), 'int64')
    np.add.at(cm, (label.reshape(-1), pred.reshape(-1)), 1)
    np.testing.assert_array_equal(touts['OutCorrect'].numpy(), np.diag(cm))
    np.testing.assert_array_equal(touts['OutWrong'].numpy(),
                                  cm.sum(1) - np.diag(cm))


# -- the layers -------------------------------------------------------------

def _vision_net(fluid):
    """Every vision layer once, into one loss."""
    layers = fluid.layers
    img = layers.data(name='img', shape=[4, 8, 8], dtype='float32')
    vol = layers.data(name='vol', shape=[2, 6, 6, 6], dtype='float32')
    rois = layers.data(name='rois', shape=[4], dtype='float32')
    y = layers.data(name='y', shape=[1], dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    pred = layers.data(name='pred', shape=[1], dtype='int64')
    c3 = layers.conv3d(vol, num_filters=3, filter_size=3, padding=1,
                       act='relu')
    p3 = layers.pool3d(c3, pool_size=2, pool_type='avg', pool_stride=2)
    t3 = layers.conv3d_transpose(p3, num_filters=2, filter_size=2,
                                 stride=2)
    t2 = layers.conv2d_transpose(img, num_filters=4, filter_size=3,
                                 stride=2, padding=1)
    t2b = layers.conv2d_transpose(img, num_filters=4, output_size=[10, 10])
    pr = layers.prelu(layers.lrn(t2, n=3), mode='channel')
    up = layers.resize_bilinear(pr, out_shape=[20, 18])
    down = layers.image_resize(up, scale=0.5, resample='NEAREST')
    short = layers.image_resize_short(img, out_short_len=5)
    pooled = layers.roi_pool(img, rois, pooled_height=2, pooled_width=2,
                             spatial_scale=0.5)
    feat = layers.reduce_mean(down, dim=[1, 2, 3], keep_dim=False)
    score = layers.fc(layers.concat(
        [layers.reshape(feat, [-1, 1]),
         layers.reshape(layers.reduce_mean(t3, dim=[1, 2, 3, 4]), [-1, 1]),
         layers.reshape(layers.reduce_mean(t2b, dim=[1, 2, 3]), [-1, 1]),
         layers.reshape(layers.reduce_mean(short, dim=[1, 2, 3]),
                        [-1, 1])], axis=1), size=1)
    prob = layers.sigmoid(score)
    loss = layers.mean(layers.smooth_l1(score, y)) \
        + layers.mean(layers.rank_loss(y, score, prob)) \
        + layers.dice_loss(prob, label) \
        + layers.mean(layers.reduce_mean(pooled, dim=[1, 2, 3]))
    miou, wrong, correct = layers.mean_iou(pred, label, num_classes=3)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss, score, up, down, short, pooled, t3, miou, wrong, correct]


def _build_vision(fluid, framework, unique_name):
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        fetch = _vision_net(fluid)
    return main, startup, fetch


def _counts_int64(d):
    """The JAX program declares mean_iou's counts float32, the dtype its
    rule gives them; the port's are int64 counts."""
    for v in d['blocks'][0]['vars']:
        if v['name'] in ('mean_iou_0.tmp_1', 'mean_iou_0.tmp_2'):
            assert v['dtype'] in ('float32', 'int64'), v
            v['dtype'] = 'int64'
    return d


def test_vision_layers_emit_the_jax_program():
    j = _build_vision(jfluid, jframework, junique)
    t = _build_vision(tfluid, tframework, tunique)
    for i in (0, 1):
        assert _normalized(t[i]) == _counts_int64(_normalized(j[i]))
    types = {op.type for op in t[0].global_block().ops}
    for op_type in ('conv3d', 'pool3d', 'conv3d_transpose',
                    'conv2d_transpose', 'lrn', 'prelu', 'bilinear_interp',
                    'nearest_interp', 'roi_pool', 'smooth_l1_loss',
                    'rank_loss', 'dice_loss', 'mean_iou'):
        assert op_type in types, op_type


def test_vision_layers_step_from_the_jax_scope():
    jmain, jstart, jfetch = _build_vision(jfluid, jframework, junique)
    tmain, _, tfetch = _build_vision(tfluid, tframework, tunique)
    rng = np.random.RandomState(22)
    feed = {'img': rng.randn(3, 4, 8, 8).astype('float32'),
            'vol': rng.randn(3, 2, 6, 6, 6).astype('float32'),
            'rois': np.float32([[0, 0, 12, 9], [4, 2, 15, 15],
                                [6, 6, 7, 7]]),
            'y': rng.randn(3, 1).astype('float32'),
            'label': np.int64([[0], [1], [1]]),
            'pred': np.int64([[0], [2], [1]])}
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
    want = [np.asarray(a) for a in jexe.run(
        jmain, feed=feed, fetch_list=jfetch, scope=jscope)]
    tscope = tfluid.Scope()
    tscope.load_numpy(init, tfluid.CPUPlace())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=tfetch, scope=tscope)
    for v, g, w in zip(tfetch, got, want):
        _close(np.asarray(g), np.asarray(w).astype(np.asarray(g).dtype),
               v.name)
    params = [p.name for p in tmain.all_parameters()]
    after = tscope.to_numpy(params)
    for n in params:
        _close(after[n], np.asarray(jscope.vars[n]), n)
        assert not np.array_equal(after[n], init[n]) or 'b_' in n, n
