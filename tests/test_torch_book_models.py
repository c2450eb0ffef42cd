"""The port's last three book models (models/word2vec.py,
recommender_system.py, label_semantic_roles.py), their datasets, compat
and install_as_paddle, against the JAX package's, on the CPU:

  * get_model emits the JAX program op for op, startup program too:
    word2vec, and word2vec's layers with is_sparse=True on shared_w (the
    reference book's setting; neither get_model takes is_sparse),
    recommender_system at its own widths, and SRL at word_dim 16, hidden
    32, depth 2 (tests/test_book_label_semantic_roles.py's size) with
    SGD under the book's staircase exponential_decay;
  * each model from the JAX startup scope carried into the port through
    Executor.load_state_dict (SRL's pretrained `emb` loaded on both sides
    by load_pretrained_embedding, the port's through
    scope.find_var(...).get_tensor().set(...)): the losses and every
    persistable over 3 steps within TOL = 1e-5 of max(|x|, 1);
  * SRL's frozen `emb` bitwise unchanged after the steps (no gradient, no
    update), `crfw` moved by its own learning rate (1e-3 x the global);
    the shared word2vec table's four sparse taps merged into one update
    (the sparse plan names shared_w once);
  * SRL's crf_decoding from the same weights equal to the JAX path;
  * each for_test program saved by either package with
    save_inference_model and served by the port's Predictor(CPUPlace())
    against the JAX Predictor;
  * the readers and dictionaries equal to the JAX ones on the first 64
    samples of each split, movielens' helpers and info objects, and the
    bytes of conll05.get_embedding()'s file;
  * every compat function against the JAX one, and install_as_paddle in a
    subprocess.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu import compat as jcompat
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.dataset import conll05 as jconll05
from paddle_tpu.dataset import imikolov as jimikolov
from paddle_tpu.dataset import movielens as jmovielens
from paddle_tpu.models import label_semantic_roles as jsrl
from paddle_tpu.models import recommender_system as jrec
from paddle_tpu.models import word2vec as jw2v

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import compat as tcompat
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.dataset import conll05 as tconll05
from paddle_tpu_torch.dataset import imikolov as timikolov
from paddle_tpu_torch.dataset import movielens as tmovielens
from paddle_tpu_torch.models import label_semantic_roles as tsrl
from paddle_tpu_torch.models import recommender_system as trec
from paddle_tpu_torch.models import word2vec as tw2v

from test_torch_training import _assert_same_program

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = (jfluid, jframework, junique,
       dict(w2v=jw2v, rec=jrec, srl=jsrl))
PORT = (tfluid, tframework, tunique,
        dict(w2v=tw2v, rec=trec, srl=tsrl))
TOL = 1e-5
STEPS = 3
BATCH = {'w2v': 16, 'w2v_sparse': 16, 'rec': 16, 'srl': 4}
SRL_NARROW = dict(word_dim=16, mark_dim=4, hidden_dim=32, depth=2)
SRL_LR = 0.1
CRF_LR = 1e-3                # get_model's mix_hidden_lr


def _w2v_sparse(pkg):
    """word2vec with is_sparse=True on shared_w, from the layers (neither
    package's get_model takes is_sparse)."""
    fluid = pkg[0]
    words = [fluid.layers.data(name='word_%d' % i, shape=[1], dtype='int64')
             for i in range(5)]
    embeds = [fluid.layers.embedding(
        input=w, size=[2073, 32], is_sparse=True,
        param_attr=fluid.ParamAttr(name='shared_w')) for w in words[:-1]]
    concat = fluid.layers.concat(input=embeds, axis=1)
    hidden = fluid.layers.fc(input=concat, size=256, act='sigmoid')
    predict = fluid.layers.softmax(fluid.layers.fc(input=hidden, size=2073))
    avg_cost = fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=predict, label=words[-1]))
    test = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.SGD(learning_rate=0.001).minimize(avg_cost)
    return avg_cost, test, None, None, ['word_%d' % i for i in range(5)]


def _model(pkg, which):
    """(avg_cost, the for_test program or None, feed names, the fetch the
    for_test program serves) of `which` in the default programs."""
    fluid, models = pkg[0], pkg[3]
    if which == 'w2v':
        cost, test, _, _, feeds = models['w2v'].get_model(batch_size=16)
    elif which == 'w2v_sparse':
        cost, test, _, _, feeds = _w2v_sparse(pkg)
    elif which == 'rec':
        cost, infer, test, _, _, feeds = models['rec'].get_model(
            batch_size=16)
        return cost, test, feeds, infer.name
    else:
        cost, decode, _, feeds = models['srl'].get_model(**SRL_NARROW)
        lr = fluid.layers.exponential_decay(
            learning_rate=SRL_LR, decay_steps=100000, decay_rate=0.5,
            staircase=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
        return cost, None, feeds, decode.name
    probs = [op for op in test.global_block().ops if op.type == 'softmax']
    return cost, test, feeds, probs[-1].outputs['Out'][0].name


def _build(pkg, which):
    fluid, framework, unique_name, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        out = _model(pkg, which)
    return main, startup, out


MODELS = ['w2v', 'w2v_sparse', 'rec', 'srl']


@pytest.mark.parametrize('which', ['main', 'startup'])
@pytest.mark.parametrize('model', MODELS)
def test_get_model_emits_the_jax_program(model, which):
    i = 0 if which == 'main' else 1
    j, t = _build(JAX, model)[i], _build(PORT, model)[i]
    _assert_same_program(j, t)
    if which == 'main':
        types = [op.type for op in t.global_block().ops]
        want = {'w2v': ['lookup_table', 'concat', 'softmax', 'sgd'],
                'w2v_sparse': ['lookup_table', 'sgd'],
                'rec': ['sequence_conv', 'sequence_pool', 'cos_sim', 'sgd'],
                'srl': ['lstm', 'sum', 'linear_chain_crf', 'crf_decoding',
                        'sgd']}[model]
        for op_type in want + ['autodiff']:
            assert op_type in types, op_type
        lookups = [op for op in t.global_block().ops
                   if op.type == 'lookup_table']
        if model.startswith('w2v'):
            assert [op.inputs['W'][0].name for op in lookups] == \
                ['shared_w'] * 4
            assert all(op.attrs['is_sparse'] == (model == 'w2v_sparse')
                       for op in lookups)
        if model == 'srl':
            assert sum(op.inputs['W'][0].name == 'emb'
                       for op in lookups) == 6
            assert types.count('lstm') == 2


def test_full_width_srl_program_is_the_jax_program():
    """db_lstm at its own defaults (hidden 512, depth 8), as the card
    trains it."""
    progs = []
    for fluid, framework, unique_name, models in (JAX, PORT):
        main, startup = framework.Program(), framework.Program()
        with unique_name.guard(), framework.program_guard(main, startup):
            cost, _, _, _ = models['srl'].get_model(hidden_dim=512, depth=8)
            fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
        progs.append(main)
    _assert_same_program(*progs)
    types = [op.type for op in progs[1].global_block().ops]
    assert types.count('lstm') == 8


def test_recommender_dist_axis_raises():
    main, startup = tframework.Program(), tframework.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        with pytest.raises(NotImplementedError, match='not ported'):
            trec.model(dist_axis='dp')


# -- the datasets -------------------------------------------------------------

def _first(reader, n=64):
    out = []
    for s in reader():
        out.append(s)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize('split', ['train', 'test'])
def test_imikolov_readers_are_the_jax_readers(split):
    d = timikolov.build_dict()
    assert d == jimikolov.build_dict()
    got = _first(getattr(timikolov, split)(d, 5))
    assert got == _first(getattr(jimikolov, split)(d, 5)) and len(got) == 64


@pytest.mark.parametrize('split', ['train', 'test'])
def test_movielens_readers_are_the_jax_readers(split):
    got = _first(getattr(tmovielens, split)())
    assert got == _first(getattr(jmovielens, split)()) and len(got) == 64


def test_movielens_helpers_and_info_objects():
    for name in ('max_user_id', 'max_movie_id', 'max_job_id',
                 'movie_categories', 'get_movie_title_dict'):
        assert getattr(tmovielens, name)() == getattr(jmovielens, name)()
    assert tmovielens.age_table == jmovielens.age_table
    for fn in ('movie_info', 'user_info'):
        t, j = getattr(tmovielens, fn)(), getattr(jmovielens, fn)()
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].value() == j[k].value() and repr(t[k]) == repr(j[k])
    u = tmovielens.UserInfo(3, 'F', 25, 7)
    assert u.value() == jmovielens.UserInfo(3, 'F', 25, 7).value()


@pytest.mark.parametrize('split', ['train', 'test'])
def test_conll05_readers_are_the_jax_readers(split):
    assert tconll05.get_dict() == jconll05.get_dict()
    got = _first(getattr(tconll05, split)())
    assert got == _first(getattr(jconll05, split)()) and len(got) == 64
    assert all(len(s) == 9 and len({len(c) for c in s}) == 1 for s in got)


def test_conll05_embedding_file_is_the_jax_file():
    tpath, jpath = tconll05.get_embedding(), jconll05.get_embedding()
    assert tpath != jpath
    assert os.path.dirname(tpath) == tconll05.common.DATA_HOME
    with open(tpath, 'rb') as a, open(jpath, 'rb') as b:
        assert a.read() == b.read()
    assert not [f for f in os.listdir(os.path.dirname(tpath))
                if f.endswith('.tmp')]


# -- three training steps -----------------------------------------------------

def _batches(model, n):
    reader, size = {
        'w2v': (timikolov.train(), BATCH['w2v']),
        'w2v_sparse': (timikolov.train(), BATCH['w2v']),
        'rec': (tmovielens.train(), BATCH['rec']),
        'srl': (tconll05.train(), BATCH['srl'])}[model]
    samples = _first(reader, n * size)
    return [samples[i * size:(i + 1) * size] for i in range(n)]


def _grad_names(program, sparse=False):
    """The autodiff op's gradients; with sparse, less the tables' (a
    fetched table gradient asks for the dense path)."""
    ad = [op for op in program.global_block().ops if op.type == 'autodiff']
    names = list(ad[0].attrs['grad_names'])
    return [n for n in names if n != 'shared_w@GRAD'] if sparse else names


def _jax_train(model, batches):
    main, startup, out = _build(JAX, model)
    loss, _, feeds, _ = out
    gnames = _grad_names(main, sparse=model == 'w2v_sparse')
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        if model == 'srl':
            jsrl.load_pretrained_embedding(scope=scope)
        feeder = jfluid.DataFeeder(feeds, jfluid.CPUPlace(), program=main)
        steps = []
        for b in batches:
            res = exe.run(main, feed=feeder.feed(b),
                          fetch_list=[loss] + gnames)
            steps.append((float(np.asarray(res[0]).reshape(())),
                          dict(zip(gnames, [np.array(g) for g in res[1:]]))))
        after = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
    return init, steps, after


def _port_train(model, init, batches):
    main, startup, out = _build(PORT, model)
    loss, _, feeds, _ = out
    gnames = _grad_names(main, sparse=model == 'w2v_sparse')
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    restored = exe.load_state_dict(init, program=main, scope=scope)
    assert sorted(restored) == sorted(init)
    if model == 'srl':
        assert tsrl.load_pretrained_embedding(scope=scope) == (44068, 16)
    before = scope.to_numpy()
    feeder = tfluid.DataFeeder(feeds, tfluid.CPUPlace(), program=main)
    steps = []
    for b in batches:
        res = exe.run(main, feed=feeder.feed(b), fetch_list=[loss] + gnames,
                      scope=scope)
        steps.append((float(np.asarray(res[0]).reshape(())),
                      dict(zip(gnames, res[1:]))))
    return main, scope, exe, before, steps


def _close(got, want, what):
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


_TRAINED = {}


def _trained(model):
    if model not in _TRAINED:
        batches = _batches(model, STEPS)
        init, jsteps, jafter = _jax_train(model, batches)
        main, scope, exe, before, tsteps = _port_train(model, init, batches)
        _TRAINED[model] = dict(model=model, batches=batches, init=init,
                               jsteps=jsteps, jafter=jafter, main=main,
                               scope=scope, exe=exe, before=before,
                               tsteps=tsteps)
    return _TRAINED[model]


@pytest.fixture(scope='module', params=MODELS)
def trained(request):
    return _trained(request.param)


def test_losses_and_persistables_match_over_three_steps(trained):
    t = trained
    np.testing.assert_allclose([s[0] for s in t['tsteps']],
                               [s[0] for s in t['jsteps']], rtol=0,
                               atol=TOL)
    assert np.isfinite([s[0] for s in t['tsteps']]).all()
    got = t['scope'].to_numpy(sorted(t['jafter']))
    assert len(t['jafter']) >= 6
    for n, want in t['jafter'].items():
        _close(got[n], want.astype(got[n].dtype), n)


def test_step_one_gradients_match_the_jax_package(trained):
    jg, tg = trained['jsteps'][0][1], trained['tsteps'][0][1]
    assert sorted(jg) == sorted(tg)
    for name, want in jg.items():
        _close(tg[name], want, name)


def test_srl_frozen_table_and_crf_learning_rate():
    t = _trained('srl')
    scope, before = t['scope'], t['before']
    assert 'emb@GRAD' not in _grad_names(t['main'])
    assert np.array_equal(scope.to_numpy(['emb'])['emb'], before['emb'])
    with open(tconll05.get_embedding(), 'rb') as f:
        f.read(16)
        pre = np.fromfile(f, dtype=np.float32).reshape(-1, 32)
    np.testing.assert_array_equal(before['emb'], pre[:, :16])
    # SGD: crfw moves by lr x 1e-3 x its gradient, summed over the steps
    moved = sum(s[1]['crfw@GRAD'] for s in t['tsteps'])
    # (each update rounds crfw to fp32: STEPS roundings of its ulp)
    ulps = STEPS * np.finfo(np.float32).eps * np.abs(before['crfw']).max()
    np.testing.assert_allclose(
        scope.to_numpy(['crfw'])['crfw'] - before['crfw'],
        -SRL_LR * CRF_LR * moved, rtol=1e-4, atol=ulps)
    assert SRL_LR * CRF_LR * np.abs(moved).max() > 100 * ulps
    fc = [n for n in before if n.startswith('fc_') and n.endswith('.w_0')][0]
    g = sum(s[1][fc + '@GRAD'] for s in t['tsteps'])
    ulps = STEPS * np.finfo(np.float32).eps * np.abs(before[fc]).max()
    np.testing.assert_allclose(scope.to_numpy([fc])[fc] - before[fc],
                               -SRL_LR * g, rtol=1e-4, atol=ulps)


def test_word2vec_sparse_taps_merge_into_one_update():
    t = _trained('w2v_sparse')
    plans = [a.sparse_plan for a in t['exe']._cache.values()
             if a.sparse_plan]
    assert plans and list(plans[0]) == ['shared_w']
    dense = _trained('w2v')
    # the same three batches, dense and sparse: the same losses and table
    np.testing.assert_allclose([s[0] for s in t['tsteps']],
                               [s[0] for s in dense['tsteps']], rtol=0,
                               atol=TOL)
    _close(t['scope'].to_numpy(['shared_w'])['shared_w'],
           dense['scope'].to_numpy(['shared_w'])['shared_w'], 'shared_w')


def _lod_feed(pkg, batch, names):
    """{name: LoDTensor} of a batch's sequence slots (`names`)."""
    fluid = pkg[0]
    out = {}
    for i, n in enumerate(names):
        rows = [list(s[i]) for s in batch]
        flat = np.concatenate(rows).reshape(-1, 1).astype('int64')
        out[n] = fluid.LoDTensor(flat, [[len(r) for r in rows]])
    return out


def test_srl_decode_equals_the_jax_decode():
    """crf_decoding of the for_test clone from the JAX weights after three
    steps: the port's path equals the JAX path token for token."""
    t = _trained('srl')
    batch = _batches('srl', STEPS + 1)[-1]
    names = tsrl.FEED_ORDER[:-1]
    outs = []
    for pkg in (JAX, PORT):
        main, _, (_, _, _, decode) = _build(pkg, 'srl')
        test = main.clone(for_test=True)
        test = test.prune([test.global_block().var(decode)])
        fluid = pkg[0]
        feed = _lod_feed(pkg, batch, names)
        if pkg is JAX:
            scope = JScope()
            for n, a in t['jafter'].items():
                scope.vars[n] = a
            with jfluid.scope_guard(scope):
                got, = fluid.Executor(fluid.CPUPlace()).run(
                    test, feed=feed, fetch_list=[decode])
        else:
            scope = tfluid.Scope()
            scope.load_numpy(t['jafter'], tfluid.CPUPlace())
            got, = fluid.Executor(fluid.CPUPlace()).run(
                test, feed=feed, fetch_list=[decode], scope=scope)
        outs.append(np.asarray(got))
    assert outs[1].shape == (sum(len(s[0]) for s in batch), 1)
    np.testing.assert_array_equal(outs[1], outs[0])
    assert ((outs[1] >= 0) & (outs[1] < 59)).all()


def _serve_feed(pkg, model, batch):
    if model == 'srl':
        return _lod_feed(pkg, batch, tsrl.FEED_ORDER[:-1])
    if model.startswith('w2v'):
        return {'word_%d' % i: np.array([[s[i]] for s in batch], 'int64')
                for i in range(4)}
    fluid = pkg[0]
    feed = {n: np.array([[s[i]] for s in batch], 'int64')
            for i, n in enumerate(trec.FEED_ORDER[:5])}
    for i, n in ((5, 'category_id'), (6, 'movie_title')):
        rows = [list(s[i]) for s in batch]
        feed[n] = fluid.LoDTensor(
            np.concatenate(rows).reshape(-1, 1).astype('int64'),
            [[len(r) for r in rows]])
    return feed


def _serving_program(pkg, model, main):
    test = _build(pkg, model)[2][1]
    return test if test is not None else main.clone(for_test=True)


@pytest.mark.parametrize('saved_by', ['jax', 'port'])
def test_for_test_programs_serve_through_predictor(trained, saved_by,
                                                   tmp_path):
    t = trained
    model = t['model']
    jmain, _, jout = _build(JAX, model)
    tmain, _, tout = _build(PORT, model)
    feeds = [n for n in tout[2] if n not in ('score', 'target')]
    if model.startswith('w2v'):
        feeds = feeds[:4]
    target = tout[3]
    d = str(tmp_path)
    if saved_by == 'port':
        test = _serving_program(PORT, model, tmain)
        tfluid.io.save_inference_model(
            d, feeds, [test.global_block().var(target)],
            tfluid.Executor(tfluid.CPUPlace()), main_program=test,
            scope=t['scope'])
    else:
        test = _serving_program(JAX, model, jmain)
        jscope = JScope()
        with jfluid.scope_guard(jscope):
            for n, a in t['jafter'].items():
                jscope.vars[n] = a
            jfluid.io.save_inference_model(
                d, feeds, [test.global_block().var(target)],
                jfluid.Executor(jfluid.CPUPlace()), main_program=test)
    batch = _batches(model, STEPS + 1)[-1]
    got = tinference.Predictor(d, place=tfluid.CPUPlace()).run(
        _serve_feed(PORT, model, batch))[0]
    want = np.asarray(jinference.Predictor(d).run(
        _serve_feed(JAX, model, batch))[0])
    assert got.shape == want.shape
    if model == 'srl':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- compat and install_as_paddle ---------------------------------------------

COMPAT_CASES = [
    ('to_text', (b'abc',), {}), ('to_text', (['a', b'b', None],), {}),
    ('to_text', ([1, b'a'],), {}), ('to_bytes', ([2, 'a'],), {}),
    ('to_text', ({b'x', 'y'},), {'inplace': True}),
    ('to_bytes', ('abc',), {}), ('to_bytes', (['a', b'b'],),
                                 {'inplace': True}),
    ('to_text', (None,), {}), ('to_bytes', ({'p', b'q'},), {}),
    ('round', (0.5,), {}), ('round', (-0.5,), {}), ('round', (2.675, 2), {}),
    ('round', (0.0,), {}), ('round', (-2.5,), {}),
    ('floor_division', (7, 2), {}), ('floor_division', (-7, 2), {}),
    ('get_exception_message', (ValueError('boom'),), {}),
]


@pytest.mark.parametrize('case', range(len(COMPAT_CASES)))
def test_compat_matches_the_jax_compat(case):
    import copy
    name, args, kw = COMPAT_CASES[case]
    targs, jargs = copy.deepcopy(args), copy.deepcopy(args)
    got = getattr(tcompat, name)(*targs, **kw)
    want = getattr(jcompat, name)(*jargs, **kw)
    assert got == want and type(got) is type(want)
    if kw.get('inplace'):
        assert got is targs[0] and targs == jargs
    if name == 'round' and want == 0.0:
        assert np.copysign(1.0, got) == np.copysign(1.0, want)


def test_compat_module_surface():
    assert tcompat.__all__ == jcompat.__all__
    assert tcompat.long_type is int and tcompat.int_type is int
    import paddle_tpu_torch
    assert paddle_tpu_torch.compat is tcompat
    assert 'install_as_paddle' in paddle_tpu_torch.__all__


def _run(code):
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    return subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_install_as_paddle_aliases_the_port():
    r = _run(
        'import sys\n'
        'import paddle_tpu_torch\n'
        'paddle_tpu_torch.install_as_paddle()\n'
        'import paddle\n'
        'import paddle.fluid as fluid\n'
        'from paddle.fluid.executor import Executor\n'
        'import paddle.models.label_semantic_roles as srl\n'
        'import paddle_tpu_torch.fluid.executor as e\n'
        'assert paddle is paddle_tpu_torch\n'
        'assert fluid is paddle_tpu_torch.fluid\n'
        'assert Executor is e.Executor\n'
        'assert srl is sys.modules["paddle_tpu_torch.models.'
        'label_semantic_roles"]\n'
        'assert "jax" not in sys.modules and "paddle_tpu" not in '
        'sys.modules\n'
        'paddle_tpu_torch.install_as_paddle()\n'
        'print("ok")\n')
    assert r.returncode == 0 and r.stdout.strip() == 'ok', r.stderr


def test_install_as_paddle_refuses_another_paddle():
    r = _run(
        'import sys, types\n'
        'sys.modules["paddle"] = types.ModuleType("paddle")\n'
        'import paddle_tpu_torch\n'
        'try:\n'
        '    paddle_tpu_torch.install_as_paddle()\n'
        'except RuntimeError as e:\n'
        '    print("refused:", e)\n')
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith('refused:') and 'already imported' in r.stdout


BOOK_SCRIPT = '''
import numpy as np
import paddle_tpu_torch
paddle_tpu_torch.install_as_paddle()

import paddle
import paddle.fluid as fluid

word_dict = paddle.dataset.imikolov.build_dict()
dict_size = len(word_dict)
N = 5
words = [fluid.layers.data(name='word_%d' % i, shape=[1], dtype='int64')
         for i in range(N)]
embeds = [fluid.layers.embedding(input=w, size=[dict_size, 32],
                                 is_sparse=True,
                                 param_attr=fluid.ParamAttr(name='shared_w'))
          for w in words[:-1]]
concat = fluid.layers.concat(input=embeds, axis=1)
hidden = fluid.layers.fc(input=concat, size=64, act='sigmoid')
predict = fluid.layers.fc(input=hidden, size=dict_size, act='softmax')
cost = fluid.layers.cross_entropy(input=predict, label=words[-1])
avg_cost = fluid.layers.mean(cost)
fluid.optimizer.SGD(learning_rate=0.5).minimize(avg_cost)
place = fluid.CPUPlace()
exe = fluid.Executor(place)
exe.run(fluid.default_startup_program())
feeder = fluid.DataFeeder(feed_list=words, place=place)
reader = paddle.batch(paddle.dataset.imikolov.train(word_dict, N), 32)
batch = next(reader())
losses = [float(np.asarray(exe.run(feed=feeder.feed(batch),
                                   fetch_list=[avg_cost])[0]).reshape(()))
          for _ in range(3)]
assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
print('losses', losses)
'''


def test_book_script_written_for_paddle_trains_word2vec():
    r = _run(BOOK_SCRIPT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith('losses')


# -- the scope's handles ---------------------------------------------------

def test_scope_find_var_and_tensor_handles_match_the_jax_scope():
    """find_var through a parent, var() creating an empty entry, the
    handle read as an ndarray and its shape, set() on an existing tensor
    (its dtype and device kept) and on a new name (on `place`), in both
    packages from the same arrays."""
    import torch
    w = np.arange(6, dtype='float32').reshape(2, 3)
    new = np.ones((2, 3), 'float64') * 0.5
    got = {}
    for name, Scope, place in (('jax', JScope, jfluid.CPUPlace()),
                               ('port', tfluid.Scope, tfluid.CPUPlace())):
        parent = Scope()
        parent.vars['w'] = w.copy() if name == 'jax' else torch.tensor(w)
        kid = parent.new_scope()
        assert kid.find_var('missing') is None
        h = kid.find_var('w').get_tensor()
        assert h.shape() == [2, 3]
        np.testing.assert_array_equal(np.array(h), w)
        h.set(new, place)
        holder = kid.var('fresh')
        assert 'fresh' in kid.vars and kid.vars['fresh'] is None
        holder.set(np.full((4,), 7, 'int64'), place)
        got[name] = (np.asarray(parent.vars['w']),
                     np.asarray(kid.vars['fresh']))
        assert 'w' not in kid.vars
    np.testing.assert_array_equal(got['port'][0], got['jax'][0])
    np.testing.assert_array_equal(got['port'][1], got['jax'][1])
    # the port keeps the persistable's dtype (the JAX handle takes the
    # array's, float64 narrowed by x64 off)
    assert got['port'][0].dtype == np.float32
    s = tfluid.Scope()
    s.vars['w'] = torch.zeros(2)
    with pytest.raises(ValueError, match='copy=False'):
        s.find_var('w').get_tensor().__array__(copy=False)


def test_load_pretrained_embedding_needs_the_startup_program():
    with pytest.raises(ValueError, match='startup program'):
        tsrl.load_pretrained_embedding(scope=tfluid.Scope())
