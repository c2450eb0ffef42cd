"""The 25 long-tail rules of the port's extra_ops.py, generate_layer_fn over
the port's registry and the cumsum layer, against the JAX package's on the
same numpy inputs, on the CPU:

  * each rule's outputs within 1e-5 of max(1, |x|), integer outputs (Mask,
    NegIndices and its lengths, UpdatedMatchIndices) exactly, and the VJP
    of each differentiable one against jax.grad of the JAX rule within
    1e-5 of max |g|; the cases of tests/test_ops_extra.py as a floor, and
    the boundaries: |x| at 0, the hinge and margin losses at their kink,
    modified huber at z = -1, windows partly in the padding and tied
    maxima in max_pool2d_with_index, overlapping windows in unpool (JAX
    passes the gradient to one writer a position), tied losses in
    mine_hard_examples;
  * sampling_id by law: 20,000 draws a row in each package, each held to
    p by a chi-square test, a zero entry never drawn;
  * the registry: the port's rules are the JAX package's, all 213 (the
    last, moe_mlp, came with data and expert parallelism), every ops_impl
    module loaded in both;
  * generate_layer_fn and layers.cumsum: the programs they build are the
    JAX package's op for op, and run to the same fetches.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.layers import layer_function_generator as jlfg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import lowering as tlow
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.layers import layer_function_generator as tlfg

from test_torch_detection import (Seq, _check, _check_vjp, _close, _jrule,
                                  _np, _trule)
from test_torch_training import _normalized

R = np.random.RandomState(27)


def _f32(*shape):
    return np.asarray(R.randn(*shape), 'float32')


def _both(op_type, ins, attrs, slots, wrt=(), out_slot=None, exact=()):
    _check(op_type, ins, attrs, slots, exact=exact)
    for s in wrt:
        _check_vjp(op_type, ins, attrs, [s], out_slot or slots[0])


# -- arithmetic and reductions ------------------------------------------------

@pytest.mark.parametrize('axis,exclusive,reverse', [
    (1, False, False), (1, True, False), (1, False, True), (-1, True, True),
    (0, False, False)])
def test_cumsum(axis, exclusive, reverse):
    _both('cumsum', {'X': [_f32(3, 4, 5)]},
          {'axis': axis, 'exclusive': exclusive, 'reverse': reverse},
          ('Out',), ['X'])


def test_cumsum_floor_case():
    x = np.array([[-2., 0., 3.], [1., -1., 4.]], 'float32')
    for attrs in ({'axis': 1}, {'axis': 1, 'exclusive': True},
                  {'axis': 1, 'reverse': True}):
        _both('cumsum', {'X': [x]}, attrs, ('Out',), ['X'])


def test_norms_at_zero():
    """|x| at 0 takes jnp.abs's gradient, 1."""
    x = _f32(3, 4)
    x[0, :2] = 0.0
    _both('l1_norm', {'X': [x]}, {}, ('Out',), ['X'])
    _both('squared_l2_norm', {'X': [x]}, {}, ('Out',), ['X'])


@pytest.mark.parametrize('y_rows', [3, 1])
def test_squared_l2_distance(y_rows):
    ins = {'X': [_f32(3, 2, 4)], 'Y': [_f32(y_rows, 2, 4)]}
    _both('squared_l2_distance', ins, {}, ('Out', 'sub_result'), ['X', 'Y'])
    _check_vjp('squared_l2_distance', ins, {}, ['X', 'Y'], 'sub_result')


def test_minus_and_fill_zeros_like():
    ins = {'X': [_f32(2, 3)], 'Y': [_f32(2, 3)]}
    _both('minus', ins, {}, ('Out',), ['X', 'Y'])
    # no gradient reaches X: zero in JAX, none at all in torch
    _both('fill_zeros_like', {'X': [_f32(2, 3)]}, {}, ('Out',))


def test_minus_keeps_a_sequence():
    x = Seq(_f32(2, 4, 3), [4, 2])
    jouts, touts = _check('minus', {'X': [x], 'Y': [_f32(2, 4, 3)]}, {},
                          ('Out',))
    assert isinstance(touts['Out'], tlow.SeqValue)
    np.testing.assert_array_equal(touts['Out'].lengths.numpy(), [4, 2])


@pytest.mark.parametrize('dtype,value', [
    ('float32', [1, 2, 3, 4, 5, 6]), ('float32', [0.1, -2.7, 3e5, 1e-8,
                                                  5, 6]),
    ('int64', [1.7, -2.2, 3, 4, 5, 6]), ('int32', [0, 1, 2, 3, 4, 5])])
def test_fill(dtype, value):
    attrs = {'shape': [2, 3], 'value': value, 'dtype': dtype}
    want = np.asarray(_jrule('fill', {}, attrs)['Out'])
    got = _trule('fill', {}, attrs)['Out'].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('axis', [1, 2])
def test_norm(axis):
    _both('norm', {'X': [_f32(2, 3, 4)]}, {'axis': axis, 'epsilon': 1e-10},
          ('Out', 'Norm'), ['X'])


# -- losses -----------------------------------------------------------------------

def _labels(*shape):
    return (R.rand(*shape) > 0.5).astype('float32')


def test_log_loss():
    p = R.uniform(0.05, 0.95, (6, 1)).astype('float32')
    _both('log_loss', {'Predicted': [p], 'Labels': [_labels(6, 1)]},
          {'epsilon': 1e-4}, ('Loss',), ['Predicted'])


def test_hinge_loss_at_its_kink():
    """1 - (2y - 1) logit = 0 at logit = +1 (y 1) and -1 (y 0): jnp.maximum
    splits the gradient there."""
    logits = _f32(8, 1)
    y = _labels(8, 1)
    y[:4] = [[1], [0], [1], [0]]
    logits[:4] = [[1.0], [-1.0], [0.0], [0.0]]
    _both('hinge_loss', {'Logits': [logits], 'Labels': [y]}, {}, ('Loss',),
          ['Logits'])


def test_margin_rank_loss_at_its_kink():
    x1, x2 = _f32(6, 1), _f32(6, 1)
    lbl = np.where(R.rand(6, 1) > 0.5, 1.0, -1.0).astype('float32')
    x2[:2] = x1[:2] + np.float32(0.25) * lbl[:2]    # act == margin - 0.25
    x2[2] = x1[2]                                   # act == margin
    ins = {'Label': [lbl], 'X1': [x1], 'X2': [x2]}
    for margin in (0.1, 0.25):
        _both('margin_rank_loss', ins, {'margin': margin},
              ('Out', 'Activated'), ['X1', 'X2'])


def test_modified_huber_loss_at_its_branch():
    x = _f32(8, 1)
    y = _labels(8, 1)
    y[:3] = [[1], [0], [1]]
    x[:3] = [[-1.0], [1.0], [1.0]]                  # z = -1, -1, 1
    _both('modified_huber_loss', {'X': [x], 'Y': [y]}, {},
          ('Out', 'IntermediateVal'), ['X'])


# -- sampling_id --------------------------------------------------------------------

def _chi_square_ok(counts, p):
    """counts of n draws against the law p: no draw where p is 0, and the
    chi-square over the other entries below its 1e-6 upper quantile."""
    from scipy.stats import chi2
    n = counts.sum()
    assert (counts[p == 0] == 0).all(), (counts, p)
    live = p > 0
    e = n * p[live]
    stat = float(((counts[live] - e) ** 2 / e).sum())
    assert stat < chi2.ppf(1 - 1e-6, live.sum() - 1), (stat, counts, p)


def test_sampling_id_draws_by_the_law_in_both_packages():
    rows = np.float32([[0.1, 0.2, 0.3, 0.4, 0.0],
                       [0.97, 0.01, 0.01, 0.01, 0.0],
                       [0.0, 0.5, 0.0, 0.25, 0.25],
                       [0.2, 0.2, 0.2, 0.2, 0.2]])
    draws = 20000
    x = np.repeat(rows, draws, axis=0)
    jids = np.asarray(_jrule('sampling_id', {'X': [x]}, {})['Out'])
    tids = _trule('sampling_id', {'X': [x]}, {})['Out']
    assert tids.dtype == torch.int64 and tuple(tids.shape) == (len(x),)
    tids = tids.numpy()
    for i, p in enumerate(rows):
        for ids in (jids, tids):
            got = ids[i * draws:(i + 1) * draws]
            _chi_square_ok(np.bincount(got, minlength=5), p)


def test_sampling_id_floor_case():
    p = np.tile(np.array([[0.01, 0.01, 0.97, 0.01]], 'float32'), (64, 1))
    out = _trule('sampling_id', {'X': [p]}, {})['Out'].numpy()
    assert out.shape == (64,) and (out == 2).mean() > 0.8


def test_sampling_id_draws_from_the_generator():
    x = np.full((256, 8), 0.125, 'float32')
    ctx = tlow.Ctx(torch.device('cpu'), torch.Generator().manual_seed(3))
    rule = tlow.get_rule('sampling_id')
    a = rule({'X': [torch.from_numpy(x)]}, {}, ctx)['Out']
    b = rule({'X': [torch.from_numpy(x)]}, {}, ctx)['Out']
    ctx2 = tlow.Ctx(torch.device('cpu'), torch.Generator().manual_seed(3))
    c = rule({'X': [torch.from_numpy(x)]}, {}, ctx2)['Out']
    assert not torch.equal(a, b) and torch.equal(a, c)


# -- products -----------------------------------------------------------------------

@pytest.mark.parametrize('n,m', [(6, 3), (5, 5), (7, 1)])
def test_conv_shift(n, m):
    _both('conv_shift', {'X': [_f32(2, n)], 'Y': [_f32(2, m)]}, {},
          ('Out',), ['X', 'Y'])


def test_conv_shift_refuses_an_even_filter():
    ins = {'X': [_f32(2, 6)], 'Y': [_f32(2, 4)]}
    for rule in (_jrule, _trule):
        with pytest.raises(ValueError, match='odd'):
            rule('conv_shift', ins, {})


@pytest.mark.parametrize('bias', [False, True])
def test_bilinear_tensor_product(bias):
    ins = {'X': [_f32(3, 4)], 'Y': [_f32(3, 5)], 'Weight': [_f32(2, 4, 5)]}
    wrt = ['X', 'Y', 'Weight']
    if bias:
        ins['Bias'] = [_f32(1, 2)]
        wrt.append('Bias')
    _both('bilinear_tensor_product', ins, {}, ('Out',), wrt)


# -- proximal updates ---------------------------------------------------------------

def test_proximal_gd():
    p = np.array([[1.0, -2.0, 0.011, 0.0]], 'float32')
    g = np.array([[0.5, 0.5, 0.0, 0.0]], 'float32')
    ins = {'Param': [p], 'Grad': [g], 'LearningRate': [np.float32([0.1])]}
    for l1, l2 in ((0.1, 0.2), (0.0, 0.0), (0.5, 0.0)):
        _both('proximal_gd', ins, {'l1': l1, 'l2': l2}, ('ParamOut',),
              ['Param', 'Grad'])


def test_proximal_adagrad():
    p, g = _f32(3, 4), _f32(3, 4)
    m = np.abs(_f32(3, 4)) + np.float32(0.1)
    ins = {'Param': [p], 'Grad': [g], 'Moment': [m],
           'LearningRate': [np.float32([0.1])]}
    _both('proximal_adagrad', ins, {'l1': 0.1, 'l2': 0.2},
          ('ParamOut', 'MomentOut'), ['Param', 'Grad'])
    floor = {'Param': [np.array([[1.0, -2.0]], 'float32')],
             'Grad': [np.array([[0.5, 0.5]], 'float32')],
             'Moment': [np.array([[0.4, 0.4]], 'float32')],
             'LearningRate': [np.float32([0.1])]}
    _both('proximal_adagrad', floor, {'l1': 0.1, 'l2': 0.2},
          ('ParamOut', 'MomentOut'))


# -- pooling ------------------------------------------------------------------------

POOL_CASES = {
    'plain': dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0]),
    'padded': dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    'overlap': dict(ksize=[3, 2], strides=[1, 2], paddings=[0, 1]),
    'global': dict(ksize=[2, 2], global_pooling=True),
}


@pytest.mark.parametrize('case', sorted(POOL_CASES))
def test_max_pool2d_with_index(case):
    x = _f32(2, 3, 5, 6)
    _both('max_pool2d_with_index', {'X': [x]}, POOL_CASES[case],
          ('Out', 'Mask'), ['X'], exact=('Mask',))


def test_max_pool2d_with_index_takes_the_first_of_tied_maxima():
    x = _f32(1, 2, 4, 4)
    x[0, 0, :2, :2] = 3.0                 # a whole window tied
    x[0, 1, 0, 1] = x[0, 1, 1, 0] = 5.0   # two of four tied
    x[0, 1, 2:, 2:] = -7.0                # a window tied at its minimum
    _both('max_pool2d_with_index', {'X': [x]}, POOL_CASES['plain'],
          ('Out', 'Mask'), ['X'], exact=('Mask',))
    mask = _trule('max_pool2d_with_index', {'X': [x]},
                  POOL_CASES['plain'])['Mask'].numpy()
    assert mask.dtype == np.int32
    assert mask[0, 0, 0, 0] == 0 and mask[0, 1, 0, 0] == 1


def test_max_pool2d_with_index_floor_case():
    x = np.random.RandomState(5).randn(1, 1, 4, 4).astype('float32')
    _both('max_pool2d_with_index', {'X': [x]}, POOL_CASES['plain'],
          ('Out', 'Mask'), ['X'], exact=('Mask',))


@pytest.mark.parametrize('case', ['plain', 'overlap', 'padded'])
def test_unpool_of_the_pooled(case):
    """unpool of max_pool2d_with_index's own outputs; with overlapping
    windows one position is written by several, always with its value,
    and the JAX VJP passes the gradient to one of them."""
    attrs = POOL_CASES[case]
    x = _f32(2, 3, 5, 6)
    pooled = _jrule('max_pool2d_with_index', {'X': [x]}, attrs)
    out, mask = np.asarray(pooled['Out']), np.asarray(pooled['Mask'])
    if case == 'overlap':
        flat = mask.reshape(2, 3, -1)
        assert any(len(set(r)) < len(r) for r in flat.reshape(6, -1))
    ins = {'X': [out], 'Indices': [mask]}
    uattrs = dict(unpooling_type='max', ksize=attrs['ksize'],
                  strides=attrs['strides'], paddings=attrs['paddings'])
    if case != 'plain':
        uattrs['output_size'] = [5, 6]
    _both('unpool', ins, uattrs, ('Out',), ['X'])


def test_unpool_drops_positions_past_the_canvas():
    x = _f32(1, 1, 2, 2)
    idx = np.int32([[[[0, 3], [15, 16]]]])     # 16 lies past a 4x4 canvas
    _both('unpool', {'X': [x], 'Indices': [idx]},
          dict(unpooling_type='max', ksize=[2, 2], strides=[2, 2],
               paddings=[0, 0]), ('Out',), ['X'])


@pytest.mark.parametrize('hw,levels,ptype', [
    ((8, 8), 3, 'max'), ((7, 7), 2, 'max'), ((5, 9), 3, 'max'),
    ((8, 8), 2, 'avg'), ((7, 6), 3, 'avg')])
def test_spp(hw, levels, ptype):
    _both('spp', {'X': [_f32(2, 3, hw[0], hw[1])]},
          {'pyramid_height': levels, 'pooling_type': ptype}, ('Out',), ['X'])


def test_spp_splits_the_gradient_of_tied_maxima():
    x = _f32(1, 2, 4, 4)
    x[0, 0, :2, :2] = 9.0
    _both('spp', {'X': [x]}, {'pyramid_height': 2, 'pooling_type': 'max'},
          ('Out',), ['X'])


# -- counters -----------------------------------------------------------------------

PNP_SLOTS = ('PositivePair', 'NegativePair', 'NeutralPair')


def test_positive_negative_pair_floor_case():
    score = np.array([[3.], [1.], [1.], [2.], [5.], [5.]], 'float32')
    label = np.array([[1.], [0.], [1.], [0.], [1.], [0.]], 'float32')
    query = np.array([[1], [1], [2], [2], [3], [3]], 'int64')
    ins = {'Score': [score], 'Label': [label], 'QueryID': [query]}
    _both('positive_negative_pair', ins, {'column': -1}, PNP_SLOTS)
    acc = dict(ins, AccumulatePositivePair=[np.float32([10.])],
               AccumulateNegativePair=[np.float32([20.])],
               AccumulateNeutralPair=[np.float32([30.])])
    _both('positive_negative_pair', acc, {'column': -1}, PNP_SLOTS)
    # one accumulator wired alone adds nothing, in both
    _both('positive_negative_pair',
          dict(ins, AccumulatePositivePair=[np.float32([10.])]),
          {'column': -1}, PNP_SLOTS)


def test_positive_negative_pair_with_weights():
    n = 24
    score = np.round(_f32(n, 3), 1)          # ties within queries
    label = R.randint(0, 3, (n, 1)).astype('float32')
    query = R.randint(0, 4, (n, 1)).astype('int64')
    weight = np.abs(_f32(n, 1))
    ins = {'Score': [score], 'Label': [label], 'QueryID': [query],
           'Weight': [weight]}
    _both('positive_negative_pair', ins, {'column': 1}, PNP_SLOTS,
          ['Weight'])
    outs = _trule('positive_negative_pair', ins, {'column': 1})
    assert all(outs[s].dtype == torch.float32 for s in PNP_SLOTS)


PR_SLOTS = ('BatchMetrics', 'AccumMetrics', 'AccumStatesInfo')


def test_precision_recall_floor_cases():
    idx = np.array([[0], [0], [1], [1]], 'int32')
    lbl = np.array([[0], [1], [1], [1]], 'int32')
    ins = {'Indices': [idx], 'Labels': [lbl]}
    for c in (2, 3):
        _both('precision_recall', ins, {'class_number': c}, PR_SLOTS)
    states = np.asarray(_jrule('precision_recall', ins,
                               {'class_number': 2})['AccumStatesInfo'])
    _both('precision_recall', dict(ins, StatesInfo=[states]),
          {'class_number': 2}, PR_SLOTS)


def test_precision_recall_weighted_with_states_and_fixed_dtypes():
    n, c = 40, 5
    idx = R.randint(0, c, (n, 1)).astype('int64')
    lbl = R.randint(0, c - 1, (n, 1)).astype('int32')   # class 4 unlabelled
    w = np.abs(_f32(n, 1))
    states = np.abs(_f32(c, 4)) * 3
    ins = {'Indices': [idx], 'Labels': [lbl], 'Weights': [w],
           'StatesInfo': [states]}
    _both('precision_recall', ins, {'class_number': c}, PR_SLOTS)
    for slot in PR_SLOTS:
        _check_vjp('precision_recall', ins, {'class_number': c},
                   ['Weights', 'StatesInfo'], slot)
    for ins in (ins, {'Indices': [idx.astype('int32')], 'Labels': [lbl]}):
        outs = _trule('precision_recall', ins, {'class_number': c})
        assert all(outs[s].dtype == torch.float32 for s in PR_SLOTS)


# -- quantization -------------------------------------------------------------------

@pytest.mark.parametrize('bits', [8, 4])
def test_fake_quantize(bits):
    x = _f32(4, 6)
    ins = {'X': [x]}
    attrs = {'bit_length': bits, 'quantize_type': 'abs_max'}
    _both('fake_quantize', ins, attrs, ('Out', 'OutMovingScale'), ['X'])
    _check_vjp('fake_quantize', ins, attrs, ['X'], 'OutMovingScale')


def test_fake_quantize_rounds_half_away_from_zero():
    """q = x / max|x| * 127 lands on +-0.5, +-1.5 and +-2.5 exactly."""
    x = np.float32([[0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 127.0]])
    jouts, touts = _check('fake_quantize', {'X': [x]}, {'bit_length': 8},
                          ('Out',), exact=('Out',))
    np.testing.assert_array_equal(touts['Out'].numpy(),
                                  [[1, -1, 2, -2, 3, -3, 127]])


def test_fake_quantize_passes_its_state_through():
    ins = {'X': [_f32(3, 3)], 'InScales': [np.float32([0.5, 0.25])],
           'InCurrentIter': [np.int64([7])]}
    _both('fake_quantize', ins, {}, ('Out', 'OutScales', 'OutCurrentIter'),
          exact=('OutCurrentIter',))
    with pytest.raises(ValueError, match='abs_max'):
        _trule('fake_quantize', ins, {'quantize_type': 'range_abs_max'})


def test_fake_dequantize_max_abs():
    x = np.round(_f32(4, 6) * 40)
    ins = {'X': [x], 'Scale': [np.float32([2.7])]}
    for attrs in ({'num_bits': 8}, {'bit_length': 4}, {}):
        _both('fake_dequantize_max_abs', ins, attrs, ('Out',),
              ['X', 'Scale'])


# -- mining -------------------------------------------------------------------------

MINE_SLOTS = ('NegIndices', 'UpdatedMatchIndices')


def _mine(cls, match, dist, attrs):
    ins = {'ClsLoss': [cls], 'MatchIndices': [match], 'MatchDist': [dist]}
    jouts, touts = _check('mine_hard_examples', ins, attrs, MINE_SLOTS,
                          exact=MINE_SLOTS)
    np.testing.assert_array_equal(touts['NegIndices'].lengths.numpy(),
                                  np.asarray(jouts['NegIndices'].lengths))
    assert touts['NegIndices'].data.dtype == torch.int64
    assert touts['NegIndices'].lengths.dtype == torch.int64
    return touts


def test_mine_hard_examples_floor_case():
    touts = _mine(np.float32([[0.1, 0.9, 0.5, 0.8, 0.2]]),
                  np.int32([[3, -1, -1, -1, -1]]),
                  np.float32([[0.9, 0.1, 0.2, 0.1, 0.6]]),
                  {'neg_pos_ratio': 2.0, 'neg_dist_threshold': 0.5})
    assert touts['NegIndices'].lengths.tolist() == [2]
    assert _np(touts['NegIndices'])[0, :2, 0].tolist() == [1, 3]


def test_mine_hard_examples_ranks_tied_losses_stably():
    n, p = 4, 12
    cls = np.round(np.abs(_f32(n, p)), 0).astype('float32')  # many ties
    match = np.where(R.rand(n, p) < 0.3, R.randint(0, 3, (n, p)),
                     -1).astype('int32')
    match[3] = -1                                 # an image with no match
    dist = R.rand(n, p).astype('float32')
    for ratio, thresh in ((3.0, 0.5), (1.5, 0.9), (0.5, 1.0)):
        _mine(cls, match, dist, {'neg_pos_ratio': ratio,
                                 'neg_dist_threshold': thresh})


# -- the registry, generate_layer_fn and the cumsum layer ---------------------------

def _load_every_ops_impl(pkg):
    d = os.path.join(os.path.dirname(importlib.import_module(
        pkg + '.fluid.ops_impl').__file__))
    for f in sorted(os.listdir(d)):
        if f.endswith('.py') and f != '__init__.py':
            importlib.import_module('%s.fluid.ops_impl.%s' % (pkg, f[:-3]))


def test_the_port_has_every_jax_rule_but_moe_mlp():
    """moe_mlp, the last rule missing here, came with data and expert
    parallelism: the port's rules are now exactly the JAX package's."""
    _load_every_ops_impl('paddle_tpu')
    _load_every_ops_impl('paddle_tpu_torch')
    missing = sorted(set(jlow._RULES) - set(tlow._RULES))
    assert missing == [], missing
    assert not set(tlow._RULES) - set(jlow._RULES)
    assert 'moe_mlp' in tlow._RULES and len(tlow._RULES) == 213


def _generated_net(fluid, lfg):
    layers = fluid.layers
    x = layers.data(name='x', shape=[3, 4], dtype='float32')
    y = layers.data(name='y', shape=[3, 4], dtype='float32')
    out = [lfg.generate_layer_fn(op)(x) for op in (
        'sign', 'l1_norm', 'squared_l2_norm', 'fill_zeros_like')]
    out.append(lfg.generate_layer_fn('minus')(x, y))
    out.append(lfg.generate_layer_fn('cumsum')(x=x, axis=2, reverse=True))
    out.append(lfg.generate_layer_fn('norm')(x, axis=1, epsilon=1e-6))
    out.append(lfg.generate_layer_fn('spp')(
        layers.reshape(x, [-1, 1, 3, 4]), pyramid_height=2,
        pooling_type='max'))
    out.append(layers.cumsum(y, axis=1, exclusive=True))
    out.append(layers.cumsum(x))
    return out


def _build(fluid, framework, unique_name, lfg):
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        fetch = _generated_net(fluid, lfg)
    return main, startup, fetch


def test_generate_layer_fn_and_cumsum_emit_and_run_the_jax_program():
    jmain, jstart, jfetch = _build(jfluid, jframework, junique, jlfg)
    tmain, tstart, tfetch = _build(tfluid, tframework, tunique, tlfg)
    assert _normalized(tmain) == _normalized(jmain)
    feed = {'x': _f32(2, 3, 4), 'y': _f32(2, 3, 4)}
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart)
    want = jexe.run(jmain, feed=feed, fetch_list=jfetch)
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstart)
    got = texe.run(tmain, feed=feed, fetch_list=tfetch)
    for v, g, w in zip(tfetch, got, want):
        _close(np.asarray(g), np.asarray(w), v.name)


def test_generate_layer_fn_refuses_an_unknown_op_and_the_doc_helpers():
    for lfg in (jlfg, tlfg):
        with pytest.raises(ValueError, match='No lowering rule'):
            lfg.generate_layer_fn('no_such_op')
    assert tfluid.layers.generate_layer_fn is tlfg.generate_layer_fn
    for name in ('deprecated', 'autodoc', 'templatedoc'):
        assert getattr(tfluid.layers, name) is getattr(tlfg, name)

    def f(x):
        """${comment} x: ${x_comment} of ${x_type}."""
        return x

    jdoc = jlfg.templatedoc('relu')(lambda x: x)
    tdoc = tlfg.templatedoc('relu')(lambda x: x)
    assert jdoc.__doc__ == tdoc.__doc__
    f2 = tlfg.templatedoc('relu')(f)
    assert f2.__doc__ == 'The relu operator. x: x of Variable.'

    def g():
        return 3

    def h():
        return 3

    assert tlfg.autodoc()(g).__doc__ == \
        "Layer g: lowered to the registered 'g' rule."
    assert jlfg.autodoc()(h).__doc__.startswith('Layer h: lowered to')
    assert tlfg.autodoc('note')(lambda: 0).__doc__ == 'note'
    with pytest.warns(DeprecationWarning, match='g is deprecated'):
        assert tlfg.deprecated(g)() == 3
