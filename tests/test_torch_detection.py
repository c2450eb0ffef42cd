"""The detection rules and layers of the port (ops_impl/detection_ops.py,
layers/detection.py) against the JAX package's, on the same numpy inputs,
on the CPU:

  * each of the 10 rules against the JAX rule of its op type: values within
    1e-5 of max(1, |x|), integer outputs and NMS rows exactly, and the
    VJPs of the differentiable ones (iou_similarity, box_coder, ssd_loss,
    rpn_target_assign) against jax.grad within 1e-5 of max |g|; cases with
    ties (identical priors and boxes, equal scores, padded gt rows),
    zero-area boxes, an image with no gt box and one with many, and the
    port's pads larger than JAX's, filled with junk the lengths mask;
  * the NMS loop without the JAX body's `later` mask against a literal
    walk, the adaptive threshold included;
  * the layers: the tiny SSD of tests/test_ssd_integration.py emits the
    JAX program op for op (but detection_output's scores_layout), trains
    8 Adam steps from the JAX startup scope to the JAX losses, and its
    detection_output rows equal the JAX multiclass_nms op appended with
    scores_layout='BMC'; a LoD feed with an empty image through the
    Executor; the JAX layer's layout fault and the port's departure.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import lowering as tlow
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.ops_impl import detection_ops

from test_torch_training import _normalized

TOL = 1e-5
GRAD_TOL = 1e-5


class Seq(object):
    """A lod input: data padded to its own width, with lengths."""

    def __init__(self, data, lengths):
        self.data = np.asarray(data)
        self.lengths = np.asarray(lengths)


def _jval(a):
    if isinstance(a, Seq):
        return jlow.SeqValue(jnp.asarray(a.data),
                             jnp.asarray(a.lengths, jnp.int32))
    return jnp.asarray(a)


def _tval(a):
    if isinstance(a, Seq):
        return tlow.SeqValue(torch.from_numpy(np.array(a.data)),
                             torch.from_numpy(np.array(a.lengths,
                                                       'int64')))
    return torch.from_numpy(np.array(a))


def _jrule(op_type, ins, attrs):
    ctx = jlow.Ctx(jax.random.key(0), platform='cpu')
    return jlow.get_rule(op_type)(
        {s: [_jval(a) for a in vs] for s, vs in ins.items()}, attrs, ctx)


def _trule(op_type, ins, attrs):
    ctx = tlow.Ctx(torch.device('cpu'), torch.Generator())
    return tlow.get_rule(op_type)(
        {s: [_tval(a) for a in vs] for s, vs in ins.items()}, attrs, ctx)


def _np(v):
    v = v.data if isinstance(v, (jlow.SeqValue, tlow.SeqValue)) else v
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(1.0, float(np.nanmax(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what, equal_nan=True)


def _check(op_type, jins, attrs, slots, tins=None, exact=()):
    """Both rules on the inputs (the port's own where it pads wider);
    every slot within TOL, the `exact` slots bitwise."""
    jouts = _jrule(op_type, jins, attrs)
    touts = _trule(op_type, tins if tins is not None else jins, attrs)
    for slot in slots:
        got, want = _np(touts[slot]), _np(jouts[slot])
        if slot in exact:
            assert got.shape == want.shape, (slot, got.shape, want.shape)
            assert np.array_equal(got, want, equal_nan=True), \
                (op_type, slot, np.argwhere(got != want)[:5])
        else:
            _close(got, want, '%s.%s' % (op_type, slot))
    return jouts, touts


def _check_vjp(op_type, jins, attrs, wrt, out_slot, tins=None, seed=0):
    """d(sum(out * cot))/d(ins[s]) for s in wrt: jax.grad of the JAX rule
    against torch.autograd through the port's rule."""
    tins = tins if tins is not None else jins
    out = _np(_jrule(op_type, jins, attrs)[out_slot])
    cot = np.asarray(np.random.RandomState(seed).randn(*out.shape),
                     'float32')

    def jloss(*args):
        ins = dict(jins)
        for s, a in zip(wrt, args):
            ins[s] = [a]
        res = _jrule(op_type, ins, attrs)[out_slot]
        res = res.data if isinstance(res, jlow.SeqValue) else res
        return jnp.sum(res * cot)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(jins[s][0]) for s in wrt])
    ctx = tlow.Ctx(torch.device('cpu'), torch.Generator())
    ins = {s: [_tval(a) for a in vs] for s, vs in tins.items()}
    leaves = [ins[s][0].requires_grad_() for s in wrt]
    res = tlow.get_rule(op_type)(ins, attrs, ctx)[out_slot]
    res = res.data if isinstance(res, tlow.SeqValue) else res
    tgrads = torch.autograd.grad((res * torch.from_numpy(cot)).sum(),
                                 leaves, allow_unused=True)
    for s, j, t in zip(wrt, jgrads, tgrads):
        j = np.asarray(j)
        t = np.zeros_like(j) if t is None else t.numpy()
        scale = max(float(np.abs(j).max()), 1e-12)
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg='%s d%s' % (op_type, s))


def _boxes(rng, *shape, zero_area=0):
    """Corner boxes in [0, 1] of shape [*shape, 4]; the first `zero_area`
    along the last axis have width 0."""
    xy = rng.uniform(0.0, 0.7, shape + (2,))
    wh = rng.uniform(0.05, 0.3, shape + (2,))
    if zero_area:
        wh[..., :zero_area, 0] = 0.0
    return np.concatenate([xy, xy + wh], -1).astype('float32')


# -- prior_box, anchor_generator, box_coder, iou_similarity ---------------

PRIOR_CASES = {
    'ssd_first': dict(min_sizes=[30.0], max_sizes=[60.0],
                      aspect_ratios=[2.0], flip=True),
    'ssd_other': dict(min_sizes=[88.0], max_sizes=[105.0],
                      aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    'no_max_steps': dict(min_sizes=[16.0, 32.0], aspect_ratios=[1.0, 0.5],
                         step_w=8.0, step_h=4.0, offset=0.25,
                         variances=[0.1, 0.2, 0.3, 0.4]),
}


@pytest.mark.parametrize('case', sorted(PRIOR_CASES))
def test_prior_box(case):
    feat = np.zeros((2, 3, 5, 7), 'float32')
    img = np.zeros((2, 3, 60, 75), 'float32')
    _check('prior_box', {'Input': [feat], 'Image': [img]},
           PRIOR_CASES[case], ('Boxes', 'Variances'))


@pytest.mark.parametrize('attrs', [
    dict(anchor_sizes=[64.0, 128.0, 256.0], aspect_ratios=[0.5, 1.0, 2.0],
         stride=[16.0, 16.0]),
    dict(anchor_sizes=[32.0], aspect_ratios=[1.0, 3.0], stride=[8.0, 12.0],
         offset=0.0, variances=[1.0, 1.0, 2.0, 2.0])])
def test_anchor_generator(attrs):
    feat = np.zeros((1, 4, 6, 5), 'float32')
    _check('anchor_generator', {'Input': [feat]}, attrs,
           ('Anchors', 'Variances'))


@pytest.mark.parametrize('var', [True, False])
@pytest.mark.parametrize('code', ['decode_center_size', 'encode_center_size'])
def test_box_coder(code, var):
    rng = np.random.RandomState(1)
    prior = _boxes(rng, 9)
    ins = {'PriorBox': [prior]}
    if var:
        ins['PriorBoxVar'] = [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                      (9, 1))]
    if code.startswith('decode'):
        ins['TargetBox'] = [rng.randn(3, 9, 4).astype('float32')]
    else:
        ins['TargetBox'] = [_boxes(rng, 5, zero_area=1)]
    attrs = {'code_type': code}
    _check('box_coder', ins, attrs, ('OutputBox',))
    _check_vjp('box_coder', ins, attrs, ['TargetBox'], 'OutputBox')


def test_iou_similarity_and_its_vjp_at_touching_and_zero_area_boxes():
    rng = np.random.RandomState(2)
    x = _boxes(rng, 6, zero_area=2)
    y = np.concatenate([_boxes(rng, 4), x[3:5],
                        # touching x[5] on its right edge: a zero-width
                        # intersection, where maximum's gradient splits
                        np.float32([[x[5, 2], x[5, 1], x[5, 2] + 0.1,
                                     x[5, 3]]])])
    ins = {'X': [x], 'Y': [y]}
    jouts, _ = _check('iou_similarity', ins, {}, ('Out',))
    assert (np.asarray(jouts['Out'])[3:5, 4:6].diagonal() == 1.0).all()
    _check_vjp('iou_similarity', ins, {}, ['X', 'Y'], 'Out')
    # a batch of gt rows against shared priors, as ssd_loss calls it
    seq = Seq(_boxes(rng, 2, 3), [3, 1])
    _check('iou_similarity', {'X': [seq], 'Y': [y]}, {}, ('Out',))


# -- bipartite_match, target_assign -----------------------------------------

def _dist_with_ties(rng, b, n, m):
    d = rng.uniform(0.0, 1.0, (b, n, m)).astype('float32')
    d[:, :, 1] = d[:, :, 0]                  # identical priors
    d[:, 1] = d[:, 0]                        # identical gt rows
    d[:, -1] = 0.0                           # a gt overlapping nothing
    d[0, 2, 3] = d[0, 2, 4] = 1.0            # a tie at the maximum
    return d


@pytest.mark.parametrize('batched', [True, False])
@pytest.mark.parametrize('match_type', ['bipartite', 'per_prediction'])
def test_bipartite_match(match_type, batched):
    rng = np.random.RandomState(3)
    d = _dist_with_ties(rng, 3, 5, 11)
    d = d if batched else d[0]
    attrs = {'match_type': match_type, 'dist_threshold': 0.4}
    _, touts = _check('bipartite_match', {'DistMat': [d]}, attrs,
                      ('ColToRowMatchIndices', 'ColToRowMatchDist'))
    assert touts['ColToRowMatchIndices'].dtype == torch.int64


@pytest.mark.parametrize('labels', [False, True])
def test_target_assign(labels):
    rng = np.random.RandomState(4)
    match = rng.randint(-1, 4, (2, 9)).astype('int32')
    if labels:
        x = rng.randint(1, 20, (2, 4, 1)).astype('int64')
        attrs = {'mismatch_value': 0}
    else:
        x = rng.randn(2, 4, 3).astype('float32')
        attrs = {'mismatch_value': -2.5}
    _check('target_assign', {'X': [x], 'MatchIndices': [match]}, attrs,
           ('Out', 'OutWeight'))


# -- multiclass_nms -------------------------------------------------------

def _nms_inputs(rng, b=2, m=40, c=4):
    boxes = _boxes(rng, b, m)
    boxes[:, 5] = boxes[:, 4]                     # identical boxes
    boxes[:, 7] = boxes[:, 6] + np.float32([0.001, 0, 0.001, 0])
    scores = rng.uniform(0, 1, (b, c, m)).astype('float32')
    scores[:, :, 5] = scores[:, :, 4]             # equal scores
    scores[:, 1, 10:14] = scores[:, 1, 9:10]
    scores[:, 2, :8] = 0.005                      # below score_threshold
    return boxes, scores


NMS_CASES = {
    'default': dict(nms_threshold=0.3),
    'ssd': dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200),
    'top_k_cut': dict(nms_threshold=0.5, nms_top_k=12, keep_top_k=20),
    'adaptive': dict(nms_threshold=0.7, nms_eta=0.8, keep_top_k=30),
    'background_2': dict(background_label=2, nms_threshold=0.4,
                         keep_top_k=50),
    'no_background': dict(background_label=-1, nms_threshold=0.4,
                          score_threshold=0.2),
}


@pytest.mark.parametrize('layout', ['BCM', 'BMC'])
@pytest.mark.parametrize('case', sorted(NMS_CASES))
def test_multiclass_nms_rows_are_the_jax_rows(case, layout):
    boxes, scores = _nms_inputs(np.random.RandomState(5))
    if layout == 'BMC':
        scores = np.ascontiguousarray(scores.transpose(0, 2, 1))
    attrs = dict(NMS_CASES[case], scores_layout=layout)
    jouts, _ = _check('multiclass_nms', {'BBoxes': [boxes],
                                         'Scores': [scores]}, attrs,
                      ('Out',), exact=('Out',))
    out = np.asarray(jouts['Out'])
    assert (out[..., 0] >= 0).sum() > 4    # the case keeps boxes


def test_multiclass_nms_sorts_nan_and_signed_zero_scores_as_jax():
    """NaN scores sort last and -0.0 ties +0.0 (stable) in both
    packages' argsorts; with a negative score_threshold the zeros are
    candidates."""
    boxes, scores = _nms_inputs(np.random.RandomState(16))
    scores[:, 0, 20:24] = np.nan
    scores[:, 3, 24:32] = np.float32([-0.0, 0.0] * 4)
    scores[:, 1, :6] = -0.0
    attrs = dict(nms_threshold=0.4, score_threshold=-1.0, keep_top_k=120,
                 background_label=2)
    _check('multiclass_nms', {'BBoxes': [boxes], 'Scores': [scores]},
           attrs, ('Out',), exact=('Out',))


def test_nms_loop_without_the_later_mask_is_the_jax_walk():
    """_nms_keep drops the JAX body's `later` mask; on a dense, tied IoU
    it keeps what the literal walk keeps."""
    rng = np.random.RandomState(6)
    iou = rng.uniform(0, 1, (3, 25, 25)).astype('float32')
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    iou[:, 4, 9] = iou[:, 9, 4] = 0.45
    valid = rng.uniform(0, 1, (3, 25)) > 0.2
    for eta in (1.0, 0.9):
        got = detection_ops._nms_keep(torch.from_numpy(iou),
                                      torch.from_numpy(valid), 0.45, eta)
        for b in range(3):
            keep, sup, thr = np.zeros(25, bool), np.zeros(25, bool), \
                np.float32(0.45)
            for i in range(25):
                cur = valid[b, i] and not sup[i]
                keep[i] = cur
                if cur:
                    sup |= (np.arange(25) > i) & (iou[b, i] > thr)
                    if eta < 1 and thr > 0.5:
                        thr = np.float32(thr * eta)
            np.testing.assert_array_equal(got[b].numpy(), keep)


# -- ssd_loss, rpn_target_assign --------------------------------------------

def _gt(rng, counts, width, junk_pad=False):
    """Per-image gt boxes and labels padded to `width` rows: zeros, or
    random junk that the lengths must mask."""
    b = len(counts)
    boxes = _boxes(rng, b, width)
    labels = rng.randint(1, 6, (b, width, 1)).astype('int64')
    for i, n in enumerate(counts):
        if not junk_pad:
            boxes[i, n:] = 0.0
            labels[i, n:] = 0
    return boxes, labels


def _ssd_inputs(rng, counts, priors):
    b, p, c = len(counts), priors.shape[0], 6
    loc = (0.5 * rng.randn(b, p, 4)).astype('float32')
    conf = rng.randn(b, p, c).astype('float32')
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (p, 1))
    g = max(max(counts), 1)
    boxes, labels = _gt(np.random.RandomState(11), counts, g)
    # the port's feed pads to a wider bucket, its pad rows junk
    pboxes, plabels = _gt(np.random.RandomState(12), counts, 16,
                          junk_pad=True)
    pboxes[:, :g], plabels[:, :g] = boxes, labels
    common = {'Loc': [loc], 'Conf': [conf], 'PriorBox': [priors],
              'PriorBoxVar': [pvar]}
    jins = dict(common, GtBox=[Seq(boxes, counts)],
                GtLabel=[Seq(labels, counts)])
    tins = dict(common, GtBox=[Seq(pboxes, counts)],
                GtLabel=[Seq(plabels, counts)])
    return jins, tins


def _priors(rng, n):
    p = _boxes(rng, n)
    p[1] = p[0]                                   # identical priors
    return p


SSD_COUNTS = {'one_each': [1, 1], 'empty_and_many': [0, 9, 3],
              'many': [7, 5]}


@pytest.mark.parametrize('match_type', ['per_prediction', 'bipartite'])
@pytest.mark.parametrize('counts', sorted(SSD_COUNTS))
def test_ssd_loss_and_its_vjp(counts, match_type):
    rng = np.random.RandomState(7)
    priors = _priors(rng, 60)
    jins, tins = _ssd_inputs(rng, SSD_COUNTS[counts], priors)
    # gt rows equal to priors: IoU 1 ties between the identical priors
    for ins in (jins, tins):
        ins['GtBox'][0].data[-1, 0] = priors[0]
    attrs = {'match_type': match_type, 'overlap_threshold': 0.3,
             'neg_overlap': 0.4}
    _check('ssd_loss', jins, attrs, ('Loss',), tins=tins)
    _check_vjp('ssd_loss', jins, attrs, ['Loc', 'Conf'], 'Loss', tins=tins)


def test_ssd_loss_smooth_l1_at_the_kink():
    """|d| = 1 exactly, where the inline smooth L1 changes branch."""
    rng = np.random.RandomState(8)
    priors = _priors(rng, 30)
    jins, tins = _ssd_inputs(rng, [2, 3], priors)
    attrs = {'overlap_threshold': 0.3}
    target = np.asarray(detection_ops._encode_boxes(
        torch.from_numpy(np.array(jins['GtBox'][0].data[:, :1])),
        torch.from_numpy(priors), torch.from_numpy(
            jins['PriorBoxVar'][0])))
    loc = jins['Loc'][0]
    loc[:, :, 0] = target[:, :, 0] + 1.0
    for ins in (jins, tins):
        ins['Loc'] = [loc]
    _check('ssd_loss', jins, attrs, ('Loss',), tins=tins)
    _check_vjp('ssd_loss', jins, attrs, ['Loc'], 'Loss', tins=tins)


RPN_COUNTS = {'one_each': [1, 1], 'empty_and_many': [0, 11, 4]}


@pytest.mark.parametrize('counts', sorted(RPN_COUNTS))
def test_rpn_target_assign_and_its_vjp(counts):
    rng = np.random.RandomState(9)
    counts = RPN_COUNTS[counts]
    anchors = (_boxes(rng, 300) * 64).astype('float32')
    anchors[1] = anchors[0]
    b = len(counts)
    loc = rng.randn(b, 300, 4).astype('float32')
    score = rng.randn(b, 300, 1).astype('float32')
    g = max(counts)
    gt = (_gt(np.random.RandomState(10), counts, g)[0] * 64)
    gt[-1, 0] = anchors[0]                     # IoU 1 with two anchors
    pgt = (_gt(np.random.RandomState(13), counts, 16, junk_pad=True)[0]
           * 64).astype('float32')
    pgt[:, :g] = gt
    common = {'Loc': [loc], 'Score': [score],
              'AnchorBox': [anchors.reshape(10, 30, 1, 4)]}
    jins = dict(common, GtBox=[Seq(gt, counts)])
    tins = dict(common, GtBox=[Seq(pgt, counts)])
    attrs = {'rpn_batch_size_per_im': 64, 'fg_fraction': 0.25,
             'rpn_positive_overlap': 0.5, 'rpn_negative_overlap': 0.2}
    _, touts = _check('rpn_target_assign', jins, attrs,
                      ('PredScore', 'PredLoc', 'TargetLabel', 'TargetBox'),
                      tins=tins, exact=('PredScore', 'PredLoc',
                                        'TargetLabel'))
    assert touts['TargetLabel'].dtype == torch.int64
    assert (touts['TargetLabel'] == 1).any()
    _check_vjp('rpn_target_assign', jins, attrs, ['Loc', 'Score'],
               'PredLoc', tins=tins)
    _check_vjp('rpn_target_assign', jins, attrs, ['Score'], 'PredScore',
               tins=tins)


# -- detection_map ----------------------------------------------------------

def _map_inputs(rng, counts, k=12, classes=4):
    b = len(counts)
    det = np.zeros((b, k, 6), 'float32')
    det[..., 0] = rng.randint(-1, classes, (b, k))
    det[..., 1] = np.round(rng.uniform(0, 1, (b, k)), 1)   # tied scores
    det[..., 2:] = _boxes(rng, b, k)
    det[det[..., 0] < 0, 1] = 0.0
    g = max(counts)
    lab = np.zeros((b, g, 5), 'float32')
    lab[..., 0] = rng.randint(1, classes, (b, g))
    lab[..., 1:] = _boxes(rng, b, g)
    # some detections sit on a gt box of their class, twice over
    for i, n in enumerate(counts):
        for j in range(min(n, 3)):
            det[i, j, 0] = det[i, j + 3, 0] = lab[i, j, 0]
            det[i, j, 2:] = det[i, j + 3, 2:] = lab[i, j, 1:]
            det[i, j, 1] = 0.5
    plab = np.concatenate([lab, rng.uniform(0, 1, (b, 16 - g, 5))
                           .astype('float32')], 1)
    return det, lab, plab


@pytest.mark.parametrize('background', [0, 3])
@pytest.mark.parametrize('counts', [[2, 3], [0, 5, 1]])
def test_detection_map(counts, background):
    rng = np.random.RandomState(14)
    det, lab, plab = _map_inputs(rng, counts)
    attrs = {'class_num': 4, 'background_label': background,
             'overlap_threshold': 0.5}
    jouts, _ = _check('detection_map',
                      {'DetectRes': [det], 'Label': [Seq(lab, counts)]},
                      attrs, ('MAP',),
                      tins={'DetectRes': [det],
                            'Label': [Seq(plab, counts)]})
    assert 0.0 < float(jouts['MAP']) <= 1.0


# -- the layers -------------------------------------------------------------

def _tiny_ssd(fluid, num_classes=4):
    """tests/test_ssd_integration.py's net and its Adam step, with its
    detection_output."""
    layers = fluid.layers
    img = layers.data(name='img', shape=[3, 32, 32], dtype='float32')
    gt_box = layers.data(name='gt_box', shape=[4], dtype='float32',
                         lod_level=1)
    gt_label = layers.data(name='gt_label', shape=[1], dtype='int64',
                           lod_level=1)
    c1 = layers.conv2d(img, num_filters=8, filter_size=3, stride=2,
                       padding=1, act='relu')
    c2 = layers.conv2d(c1, num_filters=8, filter_size=3, stride=2,
                       padding=1, act='relu')
    locs, confs, prior, var = layers.multi_box_head(
        inputs=[c1, c2], image=img, base_size=32,
        num_classes=num_classes, aspect_ratios=[[1.], [1., 2.]],
        min_ratio=20, max_ratio=90)
    loss = layers.reduce_sum(layers.ssd_loss(locs, confs, gt_box, gt_label,
                                             prior, var))
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    nmsed = layers.detection_output(locs, confs, prior, var,
                                    nms_threshold=0.45)
    return loss, nmsed


def _build(fluid, framework, unique_name):
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        loss, nmsed = _tiny_ssd(fluid)
    return main, startup, loss, nmsed


def _without_layout(d):
    for op in d['blocks'][0]['ops']:
        if op['type'] == 'multiclass_nms':
            assert op['attrs'].pop('scores_layout', 'BMC') == 'BMC'
    return d


def test_tiny_ssd_program_is_the_jax_program():
    j = _build(jfluid, jframework, junique)
    t = _build(tfluid, tframework, tunique)
    for i in (0, 1):
        assert _without_layout(_normalized(t[i])) \
            == _without_layout(_normalized(j[i]))
    nms = [op for op in t[0].global_block().ops
           if op.type == 'multiclass_nms'][0]
    assert nms.attrs['scores_layout'] == 'BMC'
    # build-time inference read the prior count: 16*16*... at base 32
    assert t[2].shape == j[2].shape and t[3].shape == (-1, 200, 6)


def _ssd_feed(fluid, place):
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, 3, 32, 32).astype('float32')
    boxes = fluid.create_lod_tensor(
        np.array([[0.1, 0.1, 0.5, 0.5], [0.3, 0.3, 0.8, 0.8],
                  [0.6, 0.1, 0.9, 0.4]], 'float32'), [[1, 2]], place)
    lbls = fluid.create_lod_tensor(np.array([[1], [2], [3]], 'int64'),
                                   [[1, 2]], place)
    return {'img': imgs, 'gt_box': boxes, 'gt_label': lbls}


def test_tiny_ssd_trains_as_jax_and_serves_the_bmc_rows():
    jmain, jstart, jloss, _ = _build(jfluid, jframework, junique)
    tmain, _, tloss, tnms = _build(tfluid, tframework, tunique)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
    # the JAX program's own answer with the layout said: the multiclass_nms
    # op appended again on the same decoded boxes and softmax scores
    op = [o for o in jmain.global_block().ops
          if o.type == 'multiclass_nms'][0]
    block = jmain.global_block()
    fixed = block.create_var(name='nms_bmc', dtype='float32')
    block.append_op(type='multiclass_nms',
                    inputs={'Scores': op.inputs['Scores'],
                            'BBoxes': op.inputs['BBoxes']},
                    outputs={'Out': [fixed]},
                    attrs=dict(op.attrs, scores_layout='BMC'),
                    infer_shape=False)
    tscope = tfluid.Scope()
    tscope.load_numpy(state, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfeed = _ssd_feed(jfluid, jfluid.CPUPlace())
    tfeed = _ssd_feed(tfluid, tfluid.CPUPlace())
    jl, tl = [], []
    for _ in range(8):
        jl.append(float(np.asarray(jexe.run(jmain, feed=jfeed,
                                            fetch_list=[jloss],
                                            scope=jscope)[0])))
        tl.append(float(np.asarray(texe.run(tmain, feed=tfeed,
                                            fetch_list=[tloss],
                                            scope=tscope)[0])))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    want = np.asarray(jexe.run(jmain, feed=jfeed, fetch_list=[fixed],
                               scope=jscope)[0])
    got = np.asarray(texe.run(tmain, feed=tfeed, fetch_list=[tnms],
                              scope=tscope)[0])
    assert got.shape == want.shape == (2, 200, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=TOL)


def _layout_program(fluid, framework, unique_name, m=6, c=3):
    """detection_output alone on fed [B, M, 4] locs, [B, M, C]
    confidences and [M, 4] priors."""
    main, startup = framework.Program(), framework.Program()
    layers = fluid.layers
    with unique_name.guard(), framework.program_guard(main, startup):
        loc = layers.data(name='loc', shape=[m, 4], dtype='float32')
        conf = layers.data(name='conf', shape=[m, c], dtype='float32')
        prior = layers.data(name='prior', shape=[m, 4], dtype='float32',
                            append_batch_size=False)
        var = layers.data(name='var', shape=[m, 4], dtype='float32',
                          append_batch_size=False)
        out = layers.detection_output(loc, conf, prior, var,
                                      score_threshold=0.0)
    return main, out


def test_jax_detection_output_misreads_bmc_scores_and_the_port_does_not():
    """B 2, M 6 priors, C 3 classes: the JAX layer's multiclass_nms reads
    the [B, M, C] softmax as [B, C, M] and labels boxes with prior indices
    (up to M - 1 >= C); the port's labels stay in [-1, C)."""
    rng = np.random.RandomState(0)
    m, c = 6, 3
    feed = {'loc': (0.1 * rng.randn(2, m, 4)).astype('float32'),
            'conf': rng.randn(2, m, c).astype('float32'),
            'prior': _boxes(rng, m),
            'var': np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (m, 1))}
    jmain, jout = _layout_program(jfluid, jframework, junique, m, c)
    tmain, tout = _layout_program(tfluid, tframework, tunique, m, c)
    jl = np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jout], scope=JScope())[0])[..., 0]
    tl = np.asarray(tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout], scope=tfluid.Scope())[0])[..., 0]
    assert jl.max() >= c
    assert tl.min() >= -1 and tl.max() < c and (tl >= 1).any()


def test_ssd_loss_through_the_executor_with_an_empty_image_and_wide_pad():
    """A LoD feed with an image of no gt box; the feeder pads to its
    power-of-two bucket (8), JAX to the longest (3): one loss."""
    def run(fluid, framework, unique_name, place, exe_scope):
        main, startup = framework.Program(), framework.Program()
        layers = fluid.layers
        with unique_name.guard(), framework.program_guard(main, startup):
            loc = layers.data(name='loc', shape=[20, 4], dtype='float32')
            conf = layers.data(name='conf', shape=[20, 5], dtype='float32')
            prior = layers.data(name='prior', shape=[20, 4],
                                dtype='float32', append_batch_size=False)
            gt_box = layers.data(name='gt_box', shape=[4], dtype='float32',
                                 lod_level=1)
            gt_label = layers.data(name='gt_label', shape=[1],
                                   dtype='int64', lod_level=1)
            loss = layers.ssd_loss(loc, conf, gt_box, gt_label, prior,
                                   overlap_threshold=0.3)
        rng = np.random.RandomState(15)
        feed = {'loc': rng.randn(3, 20, 4).astype('float32'),
                'conf': rng.randn(3, 20, 5).astype('float32'),
                'prior': _boxes(rng, 20),
                'gt_box': fluid.create_lod_tensor(
                    _boxes(rng, 4), [[1, 0, 3]], place),
                'gt_label': fluid.create_lod_tensor(
                    np.array([[1], [2], [3], [4]], 'int64'), [[1, 0, 3]],
                    place)}
        return np.asarray(fluid.Executor(place).run(
            main, feed=feed, fetch_list=[loss], scope=exe_scope)[0])

    want = run(jfluid, jframework, junique, jfluid.CPUPlace(), JScope())
    got = run(tfluid, tframework, tunique, tfluid.CPUPlace(),
              tfluid.Scope())
    assert got.shape == want.shape == (3, 1)
    _close(got, want, 'ssd_loss through the Executor')


def test_every_detection_layer_is_exported():
    for name in ('prior_box', 'multi_box_head', 'bipartite_match',
                 'target_assign', 'detection_output', 'ssd_loss',
                 'detection_map', 'rpn_target_assign', 'anchor_generator',
                 'box_coder', 'iou_similarity'):
        assert callable(getattr(tfluid.layers, name)), name
        assert name in tfluid.layers.__all__, name
