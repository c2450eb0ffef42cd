"""The port's optimizer surface against the JAX package's, on the CPU:

  * the five update rules (adamax, decayed_adagrad, rmsprop with and
    without momentum, adadelta, ftrl with lr_power -0.5 and another, l1
    and l2 > 0) iterated 3 steps on their own outputs with fresh
    gradients, every output at rtol 1e-5, atol 1e-7;
  * the six LR schedulers, each run over steps 0 .. 2 * decay_steps
    (staircase and not, polynomial's cycle and not), their lr at rtol
    1e-6 (exp and log on a float32 step);
  * on a small classifier, Adamax, DecayedAdagrad, Adadelta, RMSProp
    (momentum 0.9), Ftrl and Momentum(LARS_weight_decay) each with a
    scheduler and GradientClipByNorm: the same program op for op (startup
    too), and from the JAX package's startup weights the losses, the LARS
    rates of append_LARS and every persistable over 3 steps at 1e-5 of
    each tensor's max(|x|, 1);
  * a WeightNormParamAttr fc (dim None, 0 and 1): the program, g = ||v_init||
    after startup, and the losses, v and g over 3 SGD steps;
  * ModelAverage: apply() gives the JAX package's averages over 3 steps,
    restore() the trained weights bitwise, and a step after restore() is
    bitwise the step without the averaging; LARS_weight_decay kept and
    not applied, as in the JAX package; ErrorClipByValue's clip; the
    aliases.
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

from test_torch_training import _assert_same_program

JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)
RULE_RTOL, RULE_ATOL = 1e-5, 1e-7
SCHED_RTOL = 1e-6
TRAIN_TOL = 1e-5


# -- the update rules ------------------------------------------------------------

RULES = [
    ('adamax', ('Moment', 'InfNorm'), {'beta1': 0.9, 'beta2': 0.99,
                                       'epsilon': 1e-8},
     {'MomentOut': 'Moment', 'InfNormOut': 'InfNorm'}),
    ('decayed_adagrad', ('Moment',), {'decay': 0.9, 'epsilon': 1e-6},
     {'MomentOut': 'Moment'}),
    ('rmsprop', ('Moment', 'MeanSquare'),
     {'decay': 0.9, 'epsilon': 1e-6, 'momentum': 0.0},
     {'MomentOut': 'Moment', 'MeanSquareOut': 'MeanSquare'}),
    ('rmsprop', ('Moment', 'MeanSquare'),
     {'decay': 0.95, 'epsilon': 1e-6, 'momentum': 0.9},
     {'MomentOut': 'Moment', 'MeanSquareOut': 'MeanSquare'}),
    ('adadelta', ('AvgSquaredGrad', 'AvgSquaredUpdate'),
     {'rho': 0.9, 'epsilon': 1e-6},
     {'AvgSquaredGradOut': 'AvgSquaredGrad',
      'AvgSquaredUpdateOut': 'AvgSquaredUpdate'}),
    ('ftrl', ('SquaredAccumulator', 'LinearAccumulator'),
     {'l1': 0.01, 'l2': 0.1, 'lr_power': -0.5},
     {'SquaredAccumOut': 'SquaredAccumulator',
      'LinearAccumOut': 'LinearAccumulator'}),
    ('ftrl', ('SquaredAccumulator', 'LinearAccumulator'),
     {'l1': 0.0, 'l2': 0.0, 'lr_power': -0.3},
     {'SquaredAccumOut': 'SquaredAccumulator',
      'LinearAccumOut': 'LinearAccumulator'}),
]


@pytest.mark.parametrize('op_type,states,attrs,back', RULES,
                         ids=['%s-%d' % (r[0], i)
                              for i, r in enumerate(RULES)])
def test_update_rule_over_three_steps(op_type, states, attrs, back):
    r = np.random.RandomState(1)
    state = {'Param': r.randn(5, 4).astype('float32')}
    for s in states:
        # squared accumulators start positive, so ftrl's lr_power -0.3
        # sees no 0 ** 0.3 in its first step
        state[s] = np.abs(r.randn(5, 4)).astype('float32') * 0.1
    state['LearningRate'] = np.array([0.05], 'float32')
    if op_type == 'adamax':
        state['Beta1Pow'] = np.array([0.9], 'float32')
    jstate, tstate = dict(state), dict(state)
    for step in range(3):
        g = r.randn(5, 4).astype('float32')
        jouts = jlow.get_rule(op_type)(
            {k: [jnp.asarray(v)] for k, v in dict(jstate, Grad=g).items()},
            attrs, jlow.Ctx(jax.random.key(0), platform='cpu'))
        with torch.no_grad():
            touts = tlow.get_rule(op_type)(
                {k: [torch.from_numpy(np.array(v))]
                 for k, v in dict(tstate, Grad=g).items()},
                attrs, tlow.Ctx(torch.device('cpu')))
        for slot in ['ParamOut'] + sorted(back):
            np.testing.assert_allclose(
                touts[slot].numpy(), np.asarray(jouts[slot]),
                rtol=RULE_RTOL, atol=RULE_ATOL,
                err_msg='%s step %d %s' % (op_type, step, slot))
        for slot, name in dict(back, ParamOut='Param').items():
            jstate[name] = np.asarray(jouts[slot])
            tstate[name] = touts[slot].numpy()
        if op_type == 'adamax':
            jstate['Beta1Pow'] = jstate['Beta1Pow'] * attrs['beta1']
            tstate['Beta1Pow'] = jstate['Beta1Pow']


def test_dense_only_rules_refuse_a_sparse_gradient():
    g = tlow.SparseRows(torch.tensor([0, 2]), torch.ones(2, 4), (5, 4))
    ins = {'Param': [torch.zeros(5, 4)], 'Grad': [g],
           'Moment': [torch.zeros(5, 4)],
           'LearningRate': [torch.tensor([0.1])]}
    with pytest.raises(NotImplementedError, match='decayed_adagrad'):
        tlow.get_rule('decayed_adagrad')(ins, {}, tlow.Ctx(
            torch.device('cpu')))


# -- the schedulers ---------------------------------------------------------------

SCHEDULES = [
    ('exponential_decay', dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=False)),
    ('exponential_decay', dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=True)),
    ('natural_exp_decay', dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=False)),
    ('natural_exp_decay', dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=True)),
    ('inverse_time_decay', dict(learning_rate=0.1, decay_steps=3,
                                decay_rate=0.5, staircase=False)),
    ('inverse_time_decay', dict(learning_rate=0.1, decay_steps=3,
                                decay_rate=0.5, staircase=True)),
    ('polynomial_decay', dict(learning_rate=0.1, decay_steps=3,
                              end_learning_rate=0.01, power=2.0,
                              cycle=False)),
    ('polynomial_decay', dict(learning_rate=0.1, decay_steps=3,
                              end_learning_rate=0.01, power=2.0,
                              cycle=True)),
    ('piecewise_decay', dict(boundaries=[2, 4], values=[0.1, 0.05, 0.01])),
    ('noam_decay', dict(d_model=64, warmup_steps=3)),
]


def _schedule_program(pkg, name, kw):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        lr = getattr(fluid.layers, name)(**kw)
    return main, startup, lr.name


@pytest.mark.parametrize('name,kw', SCHEDULES,
                         ids=['%s-%d' % (s[0], i)
                              for i, s in enumerate(SCHEDULES)])
def test_scheduler_over_two_decay_periods(name, kw):
    jmain, jstart, jlr = _schedule_program(JAX, name, kw)
    tmain, tstart, tlr = _schedule_program(PORT, name, kw)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    steps = 2 * kw.get('decay_steps', kw.get('warmup_steps', 3)) + 1
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        want = [float(np.asarray(jexe.run(jmain, fetch_list=[jlr])[0])
                      .reshape(-1)[0]) for _ in range(steps)]
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstart, scope=tscope)
    got = [float(np.asarray(texe.run(tmain, fetch_list=[tlr],
                                     scope=tscope)[0]).reshape(-1)[0])
           for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)
    assert len(set(np.round(want, 7))) > 1, want


# -- the optimizers on a small classifier --------------------------------------

OPTIMIZERS = [
    ('Adamax', dict(learning_rate=0.01), 'exponential_decay'),
    ('DecayedAdagrad', dict(learning_rate=0.05), 'natural_exp_decay'),
    ('Adadelta', dict(learning_rate=0.5, rho=0.9), 'inverse_time_decay'),
    ('RMSProp', dict(learning_rate=0.01, momentum=0.9), 'polynomial_decay'),
    ('Ftrl', dict(learning_rate=0.05, l1=0.001, l2=0.01), 'piecewise_decay'),
    ('Momentum', dict(learning_rate=0.05, momentum=0.9,
                      LARS_weight_decay=0.0005), 'exponential_decay'),
]
OP_TYPES = dict(Adamax='adamax', DecayedAdagrad='decayed_adagrad',
                Adadelta='adadelta', RMSProp='rmsprop', Ftrl='ftrl',
                Momentum='momentum')


def scheduled_lr(layers, which, lr):
    """One schedule of each kind at `lr`, decay_steps 2."""
    if which == 'piecewise_decay':
        return layers.piecewise_decay([1, 2], [lr, lr / 2, lr / 4])
    if which == 'polynomial_decay':
        return layers.polynomial_decay(lr, 2, end_learning_rate=lr / 10,
                                       cycle=True)
    return getattr(layers, which)(lr, 2, 0.5, staircase=True)


def _classifier(pkg, opt, kw, schedule):
    """fc(16, relu) -> fc(4, softmax) on 13 features, cross_entropy, mean;
    GradientClipByNorm(0.5) on the first layer's weight; the optimizer
    with its lr scheduled; the LARS rates of its params and grads appended
    after the update (append_LARS)."""
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[13])
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        h = fluid.layers.fc(input=x, size=16, act='relu',
                            param_attr=fluid.ParamAttr(name='w0'))
        prob = fluid.layers.fc(input=h, size=4, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.clip.set_gradient_clip(fluid.clip.GradientClipByNorm(0.5),
                                     param_list=['w0'])
        kw = dict(kw, learning_rate=scheduled_lr(
            fluid.layers, schedule, kw['learning_rate']))
        _, pg = getattr(fluid.optimizer, opt)(**kw).minimize(loss)
        lars = fluid.layers.append_LARS(pg, 0.05, 0.0005)
    return main, startup, [loss.name] + [v.name for v in lars]


def _classifier_feeds(n):
    r = np.random.RandomState(2)
    return [{'x': r.randn(8, 13).astype('float32'),
             'label': r.randint(0, 4, (8, 1)).astype('int64')}
            for _ in range(n)]


def _jax_steps(main, startup, feeds, fetch):
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        outs = [[np.asarray(a) for a in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
        final = {n: np.array(v) for n, v in scope.vars.items()}
    return init, outs, final


def _assert_state(got, want, tol):
    for n, w in want.items():
        g = np.asarray(got[n], dtype=np.asarray(w).dtype)
        assert g.shape == np.shape(w), n
        scale = max(float(np.abs(w).max()) if np.size(w) else 0.0, 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=n)


@pytest.mark.parametrize('opt,kw,schedule', OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_trains_as_the_jax_package(opt, kw, schedule):
    jmain, jstart, jfetch = _classifier(JAX, opt, kw, schedule)
    tmain, tstart, tfetch = _classifier(PORT, opt, kw, schedule)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count('clip_by_norm') == 1
    assert types.count(OP_TYPES[opt]) == 4       # two fc layers
    feeds = _classifier_feeds(3)
    init, jouts, final = _jax_steps(jmain, jstart, feeds, jfetch)
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    for step, feed in enumerate(feeds):
        touts = exe.run(tmain, feed=feed, fetch_list=tfetch, scope=scope)
        for k, (t, j) in enumerate(zip(touts, jouts[step])):
            np.testing.assert_allclose(
                np.asarray(t), j, rtol=TRAIN_TOL, atol=TRAIN_TOL,
                err_msg='%s step %d fetch %d' % (opt, step, k))
    _assert_state(scope.to_numpy(sorted(final)), final, TRAIN_TOL)
    moved = [n for n in ('w0', 'fc_1.w_0')
             if not np.array_equal(final[n], init[n])]
    assert moved == ['w0', 'fc_1.w_0']


def test_lars_weight_decay_is_kept_and_not_applied():
    """As in the JAX package, the optimizer stores LARS_weight_decay and
    minimize appends no LARS op: the program equals the one without it."""
    progs = []
    for wd in (0.0, 0.0005):
        kw = dict(learning_rate=0.05, momentum=0.9, LARS_weight_decay=wd)
        main, _, _ = _classifier(PORT, 'Momentum', kw, 'exponential_decay')
        progs.append(main)
    _assert_same_program(progs[0], progs[1])
    opt = tfluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    LARS_weight_decay=0.5)
    assert opt._LARS_weight_decay == 0.5


def test_optimizer_aliases():
    o = tfluid.optimizer
    for alias, cls in (('Adamax', 'AdamaxOptimizer'),
                       ('DecayedAdagrad', 'DecayedAdagradOptimizer'),
                       ('Adadelta', 'AdadeltaOptimizer'),
                       ('RMSProp', 'RMSPropOptimizer'),
                       ('Ftrl', 'FtrlOptimizer')):
        assert getattr(o, alias) is getattr(o, cls)
        assert getattr(o, alias) .__name__ == \
            getattr(jfluid.optimizer, alias).__name__


# -- weight norm ---------------------------------------------------------------

def _weight_norm_net(pkg, dim):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[13])
        y = fluid.layers.data(name='y', shape=[3])
        pred = fluid.layers.fc(input=x, size=3, param_attr=(
            fluid.WeightNormParamAttr(dim=dim, name='wn')))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss.name


@pytest.mark.parametrize('dim', [None, 0, 1])
def test_weight_norm_param_attr_trains_as_the_jax_package(dim):
    jmain, jstart, jloss = _weight_norm_net(JAX, dim)
    tmain, tstart, tloss = _weight_norm_net(PORT, dim)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    r = np.random.RandomState(3)
    feeds = [{'x': r.randn(6, 13).astype('float32'),
              'y': r.randn(6, 3).astype('float32')} for _ in range(3)]
    init, jouts, final = _jax_steps(jmain, jstart, feeds, [jloss])
    # the port's own startup: g = ||v_init|| over every dim but `dim`
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    s = scope.to_numpy(['wn_v', 'wn_g'])
    axes = tuple(i for i in range(2) if dim is None or i != dim)
    np.testing.assert_allclose(
        s['wn_g'], np.sqrt((s['wn_v'] ** 2).sum(axis=axes, keepdims=True)),
        rtol=1e-6)
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    got = [float(np.asarray(exe.run(tmain, feed=f, fetch_list=[tloss],
                                    scope=scope)[0]).reshape(-1)[0])
           for f in feeds]
    np.testing.assert_allclose(
        got, [float(o[0].reshape(-1)[0]) for o in jouts], rtol=TRAIN_TOL)
    _assert_state(scope.to_numpy(['wn_v', 'wn_g']),
                  {n: final[n] for n in ('wn_v', 'wn_g')}, TRAIN_TOL)


# -- ModelAverage --------------------------------------------------------------

def _averaged(pkg, feeds):
    """The classifier under Adam with a ModelAverage; returns (main,
    startup, loss name, the ModelAverage)."""
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[13])
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        h = fluid.layers.fc(input=x, size=16, act='relu')
        prob = fluid.layers.fc(input=h, size=4, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        avg = fluid.optimizer.ModelAverage(0.15, min_average_window=2,
                                           max_average_window=10)
    return main, startup, loss.name, avg


def test_model_average_apply_and_restore():
    feeds = _classifier_feeds(4)
    jmain, jstart, jloss, javg = _averaged(JAX, feeds)
    tmain, tstart, tloss, tavg = _averaged(PORT, feeds)
    names = sorted(p.name for p, _ in tavg.params_grads)
    assert names == sorted(p.name for p, _ in javg.params_grads)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
        for f in feeds[:3]:
            jexe.run(jmain, feed=f, fetch_list=[jloss])
            javg.accumulate(jexe)
        with javg.apply(jexe):
            javg_w = {n: np.array(jscope.vars[n]) for n in names}
        jtrained = {n: np.array(jscope.vars[n]) for n in names}

    scope, twin = tfluid.Scope(), tfluid.Scope()
    for s in (scope, twin):
        s.load_numpy(init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        for f in feeds[:3]:
            exe.run(tmain, feed=f, fetch_list=[tloss])
            tavg.accumulate(exe)
            exe.run(tmain, feed=f, fetch_list=[tloss], scope=twin)
        held = {n: scope.vars[n] for n in names}
        trained = scope.to_numpy(names)
        with tavg.apply(exe):
            _assert_state(scope.to_numpy(names), javg_w, 1e-5)
            # in place: the scope keeps its tensors
            assert all(scope.vars[n] is held[n] for n in names)
        after = scope.to_numpy(names)
        for n in names:
            np.testing.assert_array_equal(after[n], trained[n])
        _assert_state(trained, jtrained, 1e-5)
        loss, = exe.run(tmain, feed=feeds[3], fetch_list=[tloss])
    want, = exe.run(tmain, feed=feeds[3], fetch_list=[tloss], scope=twin)
    np.testing.assert_array_equal(np.asarray(loss), np.asarray(want))
    got, ref = scope.to_numpy(names), twin.to_numpy(names)
    for n in names:
        np.testing.assert_array_equal(got[n], ref[n])


def test_error_clip_by_value_appends_a_clip_in_place():
    main = tframework.Program()
    with tframework.program_guard(main, tframework.Program()):
        x = tfluid.layers.data(name='x', shape=[4])
    clip = tfluid.clip.ErrorClipByValue(max=0.5)
    assert (clip.min, clip.max) == (-0.5, 0.5)
    clip._append_clip_op(main.global_block(), x.name)
    op = main.global_block().ops[-1]
    assert op.type == 'clip' and op.input('X') == op.output('Out') == ['x']
    assert (op.attrs['min'], op.attrs['max']) == (-0.5, 0.5)
