"""The port's sequence models (models/stacked_dynamic_lstm.py,
understand_sentiment.py, machine_translation.py) against the JAX
package's, on the CPU:

  * get_model emits the JAX program op for op, startup program too, at
    full width and at the narrow widths the training tests run;
  * the imdb and wmt14 readers yield the JAX readers' samples;
  * narrow models (emb and hidden 8-32, MT's vocabulary 50, sequences
    cropped to 12 ids: one time bucket of 16), from the JAX startup scope
    carried into the port through Executor.load_state_dict: the step-1
    gradients, then the losses and every persistable over 3 steps, within
    TOL = 1e-5 of max(|x|, 1) (DeepFM's tolerance: fp32 sums in other
    orders);
  * the two classifiers' for_test clones, trained 3 steps, saved by one
    package and served by the port's Predictor with LoDTensor feeds,
    against the JAX Predictor;
  * an is_sparse=True embedding on a sequence feed (its rows, pads
    included, go to the sparse Adam) against the JAX package over 3 steps.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.dataset import imdb as jimdb
from paddle_tpu.dataset import wmt14 as jwmt14
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.models import understand_sentiment as jsent

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.dataset import imdb as timdb
from paddle_tpu_torch.dataset import wmt14 as twmt14
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import stacked_dynamic_lstm as tlstm
from paddle_tpu_torch.models import understand_sentiment as tsent

from test_torch_training import _assert_same_program

JAX = (jfluid, jframework, junique, dict(lstm=jlstm, sentiment=jsent,
                                         mt=jmt))
PORT = (tfluid, tframework, tunique, dict(lstm=tlstm, sentiment=tsent,
                                          mt=tmt))
TOL = 1e-5
CROP = 12
BATCH = 4
STEPS = 3
NARROW = {'lstm': dict(lstm_size=16, emb_dim=8, batch_size=BATCH),
          'sentiment': dict(batch_size=BATCH),
          'mt': dict(embedding_dim=8, encoder_size=8, decoder_size=16,
                     dict_size=50, batch_size=BATCH)}
FEEDS = {'lstm': ['words', 'label'], 'sentiment': ['words', 'label'],
         'mt': ['source_sequence', 'target_sequence', 'label_sequence']}


def _build(pkg, model, **kw):
    fluid, framework, unique_name, models = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        out = models[model].get_model(**kw)
    return main, startup, out


@pytest.mark.parametrize('which', ['main', 'startup'])
@pytest.mark.parametrize('width', ['full', 'narrow'])
@pytest.mark.parametrize('model', ['lstm', 'sentiment', 'mt'])
def test_get_model_emits_the_jax_program(model, width, which):
    kw = NARROW[model] if width == 'narrow' else {}
    i = 0 if which == 'main' else 1
    j, t = _build(JAX, model, **kw)[i], _build(PORT, model, **kw)[i]
    _assert_same_program(j, t)
    types = [op.type for op in t.global_block().ops]
    if which == 'main':
        want = {'lstm': ['lstm', 'sequence_pool', 'adam'],
                'sentiment': ['sequence_conv', 'sequence_pool', 'adagrad'],
                'mt': ['lstm', 'concat', 'attention_lstm_decoder',
                       'sequence_pool', 'elementwise_div', 'adam']}[model]
        for op_type in want + ['lookup_table', 'autodiff']:
            assert op_type in types, op_type
        if model == 'mt':
            assert types.count('lstm') == 2
            lstms = [op for op in t.global_block().ops if op.type == 'lstm']
            assert [op.attrs['is_reverse'] for op in lstms] == [False, True]


def test_mt_generation_raises_naming_the_beam_slice():
    """Generation is ported: seq_to_seq_net(is_generating=True) emits the
    JAX program op for op, and from the JAX startup weights gives the JAX
    sentences (ids equal, scores within TOL)."""
    progs = {}
    for name, (fluid, framework, unique_name, models) in (('jax', JAX),
                                                          ('port', PORT)):
        main, startup = framework.Program(), framework.Program()
        with unique_name.guard(), framework.program_guard(main, startup):
            out = models['mt'].seq_to_seq_net(8, 8, 8, 50, 50,
                                              is_generating=True)
        progs[name] = (main, startup, out)
    (jmain, jstart, jout), (tmain, tstart, tout) = progs['jax'], \
        progs['port']
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        rows = np.random.RandomState(4).randint(2, 50, (9, 1)).astype(
            'int64')
        lt = [[4, 2, 3]]
        want = jexe.run(jmain, feed={'source_sequence':
                                     jfluid.LoDTensor(rows, lt)},
                        fetch_list=list(jout))
    tscope = tfluid.Scope()
    tscope.load_numpy({n: np.array(v) for n, v in jscope.vars.items()},
                      tfluid.CPUPlace())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={'source_sequence': tfluid.LoDTensor(rows, lt)},
        fetch_list=list(tout), scope=tscope)
    assert got[0].shape == (3, 3, 50) and got[1].shape == (3, 3)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL,
                               atol=TOL)


def test_readers_are_the_jax_readers():
    assert list(timdb.train()()) == list(jimdb.train()())
    assert list(timdb.test()()) == list(jimdb.test()())
    assert timdb.word_dict() == jimdb.word_dict()
    assert list(twmt14.train(50)()) == list(jwmt14.train(50)())
    assert list(twmt14.test()()) == list(jwmt14.test()())
    assert twmt14.get_dict(10) == jwmt14.get_dict(10)


def _batches(model, n):
    """n batches of BATCH samples from the model's reader, each sequence
    cropped to CROP ids (the feeder pads them to 16)."""
    reader = {'lstm': jimdb.train(), 'sentiment': jimdb.train(),
              'mt': jwmt14.train(50)}[model]
    out, cur = [], []
    for sample in reader():
        cur.append(tuple(s[:CROP] if isinstance(s, list) else [s]
                         for s in sample))
        if len(cur) == BATCH:
            out.append(cur)
            cur = []
        if len(out) == n:
            return out


def _loss_of(out):
    return out[0]


def _grad_names(program):
    ad = [op for op in program.global_block().ops if op.type == 'autodiff']
    return list(ad[0].attrs['grad_names'])


def _jax_train(model, batches):
    main, startup, out = _build(JAX, model, **NARROW[model])
    loss = _loss_of(out)
    gnames = _grad_names(main)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        feeder = jfluid.DataFeeder(FEEDS[model], jfluid.CPUPlace(),
                                   program=main)
        steps = []
        for b in batches:
            res = exe.run(main, feed=feeder.feed(b),
                          fetch_list=[loss] + gnames)
            steps.append((float(np.asarray(res[0]).reshape(())),
                          dict(zip(gnames, [np.array(g) for g in res[1:]]))))
        after = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
    return init, steps, after


def _port_train(model, init, batches):
    main, startup, out = _build(PORT, model, **NARROW[model])
    loss = _loss_of(out)
    gnames = _grad_names(main)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    restored = exe.load_state_dict(init, program=main, scope=scope)
    assert sorted(restored) == sorted(init)
    feeder = tfluid.DataFeeder(FEEDS[model], tfluid.CPUPlace(), program=main)
    steps = []
    for b in batches:
        res = exe.run(main, feed=feeder.feed(b), fetch_list=[loss] + gnames,
                      scope=scope)
        steps.append((float(np.asarray(res[0]).reshape(())),
                      dict(zip(gnames, res[1:]))))
    return main, scope, out, steps


def _close(got, want, what):
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


_TRAINED = {}


def _trained(model):
    """Both packages' 3 steps of `model` (once a process)."""
    if model not in _TRAINED:
        batches = _batches(model, STEPS)
        init, jsteps, jafter = _jax_train(model, batches)
        main, scope, out, tsteps = _port_train(model, init, batches)
        _TRAINED[model] = (model, batches, init, jsteps, jafter, main,
                           scope, out, tsteps)
    return _TRAINED[model]


@pytest.fixture(scope='module', params=['lstm', 'sentiment', 'mt'])
def trained(request):
    return _trained(request.param)


@pytest.fixture(scope='module', params=['lstm', 'sentiment'])
def trained_classifier(request):
    return _trained(request.param)


def test_step_one_gradients_match_the_jax_package(trained):
    model, _, _, jsteps, _, _, _, _, tsteps = trained
    jg, tg = jsteps[0][1], tsteps[0][1]
    assert sorted(jg) == sorted(tg) and len(tg) >= 6
    for name, want in jg.items():
        assert tg[name].shape == want.shape, name
        _close(tg[name], want, name)
    # every parameter the loss reaches has a gradient
    assert all(np.abs(g).max() > 0 for g in tg.values()), model


def test_losses_and_persistables_match_over_three_steps(trained):
    model, _, _, jsteps, jafter, _, scope, _, tsteps = trained
    np.testing.assert_allclose([s[0] for s in tsteps],
                               [s[0] for s in jsteps], rtol=0, atol=TOL)
    assert abs(jsteps[-1][0] - jsteps[0][0]) > 1e-4, model
    got = scope.to_numpy(sorted(jafter))
    assert len(jafter) > 6
    for n, want in jafter.items():
        _close(got[n], want.astype(got[n].dtype), n)


def _classifier_test_program(model, main, out):
    """The for_test clone and its class probabilities: the returned clone
    (stacked LSTM) or a clone of the trained program (the sentiment net,
    whose get_model returns none), whose last softmax gives them."""
    if model == 'lstm':
        test = out[1]
    else:
        test = main.clone(for_test=True)
    probs = [op for op in test.global_block().ops if op.type == 'softmax']
    return test, probs[-1].outputs['Out'][0].name


@pytest.mark.parametrize('saved_by', ['jax', 'port'])
def test_classifiers_serve_through_predictor_with_lod_feeds(
        trained_classifier, saved_by, tmp_path):
    model, batches, _, _, jafter, main, scope, out, _ = trained_classifier
    test, prob = _classifier_test_program(model, main, out)
    d = str(tmp_path)
    if saved_by == 'port':
        tfluid.io.save_inference_model(
            d, ['words'], [test.global_block().var(prob)],
            tfluid.Executor(tfluid.CPUPlace()), main_program=test,
            scope=scope)
    else:
        jmain, _, jout = _build(JAX, model, **NARROW[model])
        jtest, jprob = _classifier_test_program(model, jmain, jout)
        assert jprob == prob
        jscope = JScope()
        with jfluid.scope_guard(jscope):
            for n, a in jafter.items():
                jscope.vars[n] = a
            jfluid.io.save_inference_model(
                d, ['words'], [jtest.global_block().var(prob)],
                jfluid.Executor(jfluid.CPUPlace()), main_program=jtest)
    words = [s[0] for b in batches for s in b][:6]
    lens = [[len(w) for w in words]]
    flat = np.concatenate(words).reshape(-1, 1).astype('int64')
    got = tinference.Predictor(d, place=tfluid.CPUPlace()).run(
        {'words': tfluid.LoDTensor(flat, lens)})[0]
    want = np.asarray(jinference.Predictor(d).run(
        {'words': jfluid.LoDTensor(flat, lens)})[0])
    assert got.shape == (6, 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.sum(1), np.ones(6), rtol=1e-5)


def _sparse_program(pkg):
    fluid, framework, unique_name, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        emb = fluid.layers.embedding(words, size=[60, 6], is_sparse=True)
        pooled = fluid.layers.sequence_pool(emb, 'average')
        prob = fluid.layers.fc(pooled, size=2, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def test_sparse_embedding_on_a_sequence_feed_matches_the_jax_package():
    rng = np.random.RandomState(3)
    batches = [[(rng.randint(0, 60, rng.randint(1, 10)).tolist(),
                 [int(rng.randint(0, 2))]) for _ in range(5)]
               for _ in range(STEPS)]
    jmain, jstart, jloss = _sparse_program(JAX)
    _assert_same_program(jmain, _sparse_program(PORT)[0])
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
        jfeed = jfluid.DataFeeder(['words', 'label'], jfluid.CPUPlace(),
                                  program=jmain)
        jl = [float(np.asarray(jexe.run(jmain, feed=jfeed.feed(b),
                                        fetch_list=[jloss])[0]).reshape(()))
              for b in batches]
        want = {n: np.array(v) for n, v in jscope.vars.items()}
    assert any(a.sparse_plan for a in jexe._cache.values())
    tmain, _, tloss = _sparse_program(PORT)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.load_state_dict(init, program=tmain, scope=tscope)
    tfeed = tfluid.DataFeeder(['words', 'label'], tfluid.CPUPlace(),
                              program=tmain)
    tl = [float(texe.run(tmain, feed=tfeed.feed(b), fetch_list=[tloss],
                         scope=tscope)[0].reshape(())) for b in batches]
    plans = [a.sparse_plan for a in texe._cache.values() if a.sparse_plan]
    assert plans and list(plans[0]) == ['embedding_0.w_0']
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    got = tscope.to_numpy(sorted(want))
    for n in want:
        _close(got[n], want[n], n)
