"""The sampled losses of the port (ops_impl/sampled_ops.py `nce`,
`hierarchical_sigmoid`; layers.nce, layers.hsigmoid) against the JAX
package's on the same numpy inputs, on the CPU:

  * nce through its cost function: the port draws its negatives, and the
    JAX rule is handed the same ones (jax.random.randint patched for the
    test), so Cost, SampleLogits, SampleLabels and the VJP agree within
    1e-5; the draw itself by law (a chi-square against uniform) and fresh
    on every call of one generator;
  * hierarchical_sigmoid forward and VJP within 1e-5, labels 0 and C - 1, C
    a power of two or not, with and without Bias, pre-activations past the
    clip at +-40; the class probabilities sum to 1, as the JAX
    test_hsigmoid_probs_sum_to_one holds;
  * the slice: a small word2vec N-gram net (dict 50, embed 8, hidden 16)
    with each head emits the JAX program op for op; from the JAX startup
    weights (Scope.load_numpy) the hsigmoid net's losses and parameters
    over 3 SGD steps, and the NCE net's over one step with the port's
    draw, are the JAX package's within 1e-5; each net's JAX
    __params__.npz loads into the port and back bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.ops_impl import sampled_ops

from test_torch_detection import _check, _check_vjp, _close, _trule
from test_torch_training import _normalized

R = np.random.RandomState(28)


def _f32(*shape):
    return np.asarray(R.randn(*shape), 'float32')


def _patch_jax_draw(monkeypatch, neg):
    """jax.random.randint, as the JAX nce rule calls it, hands out `neg`."""
    neg = np.asarray(neg)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        assert tuple(shape) == neg.shape, (shape, neg.shape)
        assert 0 <= neg.min() and neg.max() < maxval and minval == 0
        return jnp.asarray(neg, jnp.int32)

    monkeypatch.setattr(jax.random, 'randint', randint)


# -- nce -----------------------------------------------------------------------

NCE_CASES = {
    'one_true': dict(B=6, D=5, N=20, T=1, k=4, bias=True, weight=False),
    'two_true_weighted': dict(B=4, D=3, N=11, T=2, k=7, bias=True,
                              weight=True),
    'no_bias_label_1d': dict(B=5, D=4, N=9, T=0, k=3, bias=False,
                             weight=False),
}


@pytest.mark.parametrize('case', sorted(NCE_CASES))
def test_nce_against_the_jax_rule_on_the_ports_draw(case, monkeypatch):
    c = NCE_CASES[case]
    if c['T']:
        label = R.randint(0, c['N'], (c['B'], c['T'])).astype('int64')
    else:
        label = R.randint(0, c['N'], (c['B'],)).astype('int64')
    ins = {'Input': [_f32(c['B'], c['D'])], 'Label': [label],
           'Weight': [_f32(c['N'], c['D'])]}
    wrt = ['Input', 'Weight']
    if c['bias']:
        ins['Bias'] = [_f32(c['N'], 1)]
        wrt.append('Bias')
    if c['weight']:
        ins['SampleWeight'] = [np.abs(_f32(c['B'], 1))]
    attrs = {'num_total_classes': c['N'], 'num_neg_samples': c['k']}
    # a fresh torch.Generator() draws the same negatives on every call
    labels = _trule('nce', ins, attrs)['SampleLabels'].numpy()
    t = max(c['T'], 1)
    neg = labels[0, t:]
    assert labels.dtype == np.int64 and labels.shape == (c['B'], t + c['k'])
    assert (labels[:, t:] == neg).all()
    _patch_jax_draw(monkeypatch, neg)
    _check('nce', ins, attrs, ('Cost', 'SampleLogits', 'SampleLabels'),
           exact=('SampleLabels',))
    _check_vjp('nce', ins, attrs, wrt, 'Cost')
    _check_vjp('nce', ins, attrs, wrt, 'SampleLogits')


def test_nce_cost_is_the_rule_on_its_negatives():
    x, w, b = _f32(4, 3), _f32(10, 3), _f32(10, 1)
    label = R.randint(0, 10, (4, 1))
    g = torch.Generator().manual_seed(5)
    ctx = tfluid.lowering.Ctx(torch.device('cpu'), g)
    ins = {'Input': [torch.from_numpy(x)], 'Label': [torch.from_numpy(label)],
           'Weight': [torch.from_numpy(w)], 'Bias': [torch.from_numpy(b)]}
    out = tfluid.lowering.get_rule('nce')(
        ins, {'num_total_classes': 10, 'num_neg_samples': 6}, ctx)
    neg = out['SampleLabels'][0, 1:]
    cost, logits, labels = sampled_ops.nce_cost(
        torch.from_numpy(x), torch.from_numpy(label), torch.from_numpy(w),
        torch.from_numpy(b), neg, 10)
    assert torch.equal(cost, out['Cost'])
    assert torch.equal(logits, out['SampleLogits'])
    assert torch.equal(labels, out['SampleLabels'])


def test_nce_draws_uniformly_and_afresh():
    from scipy.stats import chi2
    n, k, calls = 13, 10, 2600
    g = torch.Generator().manual_seed(0)
    draws = [sampled_ops.nce_negatives(n, k, torch.device('cpu'), g)
             for _ in range(calls)]
    assert all(d.dtype == torch.int64 and d.shape == (k,) for d in draws)
    assert not torch.equal(draws[0], draws[1])
    counts = np.bincount(torch.cat(draws).numpy(), minlength=n)
    assert counts.size == n
    e = k * calls / n
    stat = float(((counts - e) ** 2 / e).sum())
    assert stat < chi2.ppf(1 - 1e-6, n - 1), (stat, counts)


# -- hierarchical_sigmoid ------------------------------------------------------

@pytest.mark.parametrize('c,bias', [(7, True), (8, False), (10, True),
                                    (13, True), (2, True), (50, False)])
def test_hsigmoid(c, bias):
    b = 9
    label = R.randint(0, c, (b, 1)).astype('int64')
    label[0, 0], label[1, 0] = 0, c - 1
    ins = {'X': [_f32(b, 6)], 'W': [_f32(c - 1, 6)], 'Label': [label]}
    wrt = ['X', 'W']
    if bias:
        ins['Bias'] = [_f32(1, c - 1)]
        wrt.append('Bias')
    attrs = {'num_classes': c}
    _check('hierarchical_sigmoid', ins, attrs, ('Out', 'PreOut'))
    _check_vjp('hierarchical_sigmoid', ins, attrs, wrt, 'Out')
    _check_vjp('hierarchical_sigmoid', ins, attrs, wrt, 'PreOut')


def test_hsigmoid_past_its_clip():
    """Pre-activations beyond +-40 are clipped; no gradient passes there,
    in either package."""
    c = 10
    ins = {'X': [_f32(5, 4) * 30], 'W': [_f32(c - 1, 4) * 3],
           'Label': [np.int64([[0], [3], [9], [5], [6]])],
           'Bias': [_f32(1, c - 1)]}
    pre = _trule('hierarchical_sigmoid', ins,
                 {'num_classes': c})['PreOut'].numpy()
    assert (np.abs(pre) == 40).any()
    _check('hierarchical_sigmoid', ins, {'num_classes': c},
           ('Out', 'PreOut'))
    _check_vjp('hierarchical_sigmoid', ins, {'num_classes': c},
               ['X', 'W', 'Bias'], 'Out')


def test_hsigmoid_label_1d():
    c = 6
    ins = {'X': [_f32(4, 3)], 'W': [_f32(c - 1, 3)],
           'Label': [np.int64([0, 5, 2, 3])]}
    _check('hierarchical_sigmoid', ins, {'num_classes': c},
           ('Out', 'PreOut'))


@pytest.mark.parametrize('c', [7, 8, 2073])
def test_hsigmoid_probs_sum_to_one(c):
    d = 6
    x = np.repeat(_f32(1, d), c, axis=0)
    w = _f32(c - 1, d) * 0.5
    ins = {'X': [x], 'W': [w],
           'Label': [np.arange(c, dtype='int64')[:, None]]}
    nll = _trule('hierarchical_sigmoid', ins, {'num_classes': c})['Out']
    assert abs(float(torch.exp(-nll.double()).sum()) - 1.0) < 1e-4
    if c < 100:
        _check('hierarchical_sigmoid', ins, {'num_classes': c}, ('Out',))


# -- the slice: word2vec's N-gram net with each head ---------------------------

DICT, EMBED, HIDDEN, NGRAM, BATCH = 50, 8, 16, 5, 6


def _word2vec(fluid, head):
    """The word2vec N-gram net (models/word2vec.py: four context words
    read one shared table, concatenated, a sigmoid fc) with its softmax
    head swapped for nce or hsigmoid over the vocabulary; SGD."""
    layers = fluid.layers
    words = [layers.data(name='word_%d' % i, shape=[1], dtype='int64')
             for i in range(NGRAM)]
    embeds = [layers.embedding(input=w, size=[DICT, EMBED],
                               param_attr=fluid.ParamAttr(name='shared_w'))
              for w in words[:-1]]
    hidden = layers.fc(input=layers.concat(input=embeds, axis=1),
                       size=HIDDEN, act='sigmoid')
    if head == 'nce':
        cost = layers.nce(input=hidden, label=words[-1],
                          num_total_classes=DICT, num_neg_samples=5)
    else:
        cost = layers.hsigmoid(input=hidden, label=words[-1],
                               num_classes=DICT)
    avg_cost = layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=0.5).minimize(avg_cost)
    return avg_cost


def _build(pkg, head):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost = _word2vec(fluid, head)
    return main, startup, avg_cost


JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)


def _feeds(n):
    rng = np.random.RandomState(29)
    return [{'word_%d' % i: rng.randint(0, DICT, (BATCH, 1)).astype('int64')
             for i in range(NGRAM)} for _ in range(n)]


def _from_jax(head):
    jmain, jstart, jcost = _build(JAX, head)
    tmain, tstart, tcost = _build(PORT, head)
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope = tfluid.Scope()
    tscope.load_numpy({n: np.array(v) for n, v in jscope.vars.items()},
                      tfluid.CPUPlace())
    return (jmain, jexe, jscope, jcost), (tmain, tscope, tcost)


def _same_params(tmain, tscope, jscope):
    params = [p.name for p in tmain.all_parameters()]
    got = tscope.to_numpy(params)
    for n in params:
        _close(got[n], np.asarray(jscope.vars[n]), n)
    return params


def test_word2vec_hsigmoid_trains_as_the_jax_net():
    (jmain, jexe, jscope, jcost), (tmain, tscope, tcost) = \
        _from_jax('hsigmoid')
    texe = tfluid.Executor(tfluid.CPUPlace())
    for feed in _feeds(3):
        want = jexe.run(jmain, feed=feed, fetch_list=[jcost], scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=[tcost], scope=tscope)
        _close(np.asarray(got[0]), np.asarray(want[0]), 'loss')
    params = _same_params(tmain, tscope, jscope)
    assert sorted(params) == ['fc_0.b_0', 'fc_0.w_0',
                              'hierarchical_sigmoid_0.b_0',
                              'hierarchical_sigmoid_0.w_0', 'shared_w']


def _nce_labels_name(program):
    op, = [o for o in program.global_block().ops if o.type == 'nce']
    return op.output('SampleLabels')[0]


def test_word2vec_nce_steps_as_the_jax_net_on_the_ports_draw(monkeypatch):
    (jmain, jexe, jscope, jcost), (tmain, tscope, tcost) = _from_jax('nce')
    feed = _feeds(1)[0]
    texe = tfluid.Executor(tfluid.CPUPlace())
    loss, labels = texe.run(tmain, feed=feed,
                            fetch_list=[tcost, _nce_labels_name(tmain)],
                            scope=tscope)
    neg = np.asarray(labels)[0, 1:]
    assert neg.shape == (5,)
    _patch_jax_draw(monkeypatch, neg)
    want, jlabels = jexe.run(jmain, feed=feed,
                             fetch_list=[jcost, _nce_labels_name(jmain)],
                             scope=jscope)
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(jlabels))
    _close(np.asarray(loss), np.asarray(want), 'loss')
    _same_params(tmain, tscope, jscope)


@pytest.mark.parametrize('head', ['nce', 'hsigmoid'])
def test_word2vec_params_npz_cross_both_ways(head, tmp_path):
    (jmain, jexe, jscope, _), (tmain, tscope, _) = _from_jax(head)
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(jexe, jdir, jmain)
    texe = tfluid.Executor(tfluid.CPUPlace())
    loaded = tfluid.Scope()
    tfluid.io.load_persistables(texe, jdir, tmain, scope=loaded)
    names = [v.name for v in tmain.list_vars() if v.persistable]
    for n in names:
        assert np.array_equal(loaded.to_numpy([n])[n],
                              np.asarray(jscope.vars[n])), n
    w = loaded.to_numpy(['shared_w'])['shared_w']
    assert w.shape == (DICT, EMBED)
    shapes = {p.name: tuple(p.shape) for p in tmain.all_parameters()}
    if head == 'nce':
        assert sorted(shapes.values()) == sorted([
            (DICT, EMBED), ((NGRAM - 1) * EMBED, HIDDEN), (HIDDEN,),
            (DICT, HIDDEN), (DICT, 1)])
    else:
        assert sorted(shapes.values()) == sorted([
            (DICT, EMBED), ((NGRAM - 1) * EMBED, HIDDEN), (HIDDEN,),
            (DICT - 1, HIDDEN), (1, DICT - 1)])
    tfluid.io.save_persistables(texe, tdir, tmain, scope=loaded)
    back = JScope()
    jfluid.io.load_persistables(jexe, tdir, jmain, scope=back)
    for n in names:
        assert np.array_equal(np.asarray(back.vars[n]),
                              np.asarray(jscope.vars[n])), n
