"""The PyTorch port's training step against the JAX package's, on the CPU, at
a small Transformer (1+1 layers, d_model 32, 4 heads, d_inner 64, vocab 60,
max_length 16), with dropout 0 so the two runs see the same arithmetic:

  * get_model and the dropout-free training program are the same Program in
    both packages, op for op (autodiff, adam, adam_beta_pow_update,
    increment, elementwise_pow, elementwise_min included), startup
    accumulators too;
  * the same numpy weights and feeds through both Executors give the same
    step-1 @GRAD tensors (within 1e-4 of each tensor's max |g|: fp32 sums
    in other orders, and the port's attention backward is the kernel's
    hand-derived arithmetic, the JAX one jax.grad of XLA attention), the
    same loss over 3 Adam steps (1e-4), and the same params after 3 SGD
    steps (1e-5 of each tensor's max |w|);
  * a run resumes across packages: the JAX scope after 2 steps, carried
    whole into the port (params, Adam moments, beta pows,
    @LR_DECAY_COUNTER@), gives JAX's step 3;
  * the trained program's for_test clone serves through the port's
    Predictor, and a CPU step launches no kernel;
  * on a small regression net, every clip and regularizer class the port
    has, with SGD, gives the JAX package's program, losses and params
    (1e-5); append_backward's callbacks are accepted and not called, as
    in the JAX package.
"""
import json

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.dataset import wmt16 as jwmt16
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.dataset import wmt16 as twmt16
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import transformer as ttransformer

V, T = 60, 16
CFG = dict(n_layer=1, d_model=32, n_head=4, d_inner=64)
# noam_decay lr 2 * 32^-0.5 * step * 100^-1.5: 3.5e-4 .. 1.1e-3 over the
# first 3 steps, enough for Adam to move the loss well past the tolerance
WARMUP = 100
SGD_LR = 0.5

JAX = (jfluid, jframework, junique, jtransformer, JScope)
PORT = (tfluid, tframework, tunique, ttransformer, tfluid.Scope)


def _build_train(pkg, opt):
    fluid, framework, unique_name, transformer, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, _ = transformer.transformer(
            V, V, T, CFG['n_layer'], CFG['d_model'], CFG['n_head'],
            CFG['d_inner'], dropout_rate=0.0)
        if opt == 'adam':
            lr = fluid.layers.learning_rate_scheduler.noam_decay(
                CFG['d_model'], WARMUP)
            lr = fluid.layers.scale(lr, scale=2.0)
            fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9).minimize(avg_cost)
        else:
            fluid.optimizer.SGD(learning_rate=SGD_LR).minimize(avg_cost)
    return main, startup, avg_cost.name


def _grad_names(program):
    ad = [op for op in program.global_block().ops if op.type == 'autodiff']
    return list(ad[0].attrs['grad_names'])


def _feeds(n_steps, batch_size=4, seed_skip=0):
    """Padded wmt16 batches from the port's reader. The corpus starts every
    target with id 0, which is also the pad id, so the decoder's first
    query row would see no live key: such rows are ill-conditioned in
    every implementation (the lse-based backward of the Pallas kernel and
    of the port recomputes P from an lse rounded at -1e9), so that
    position gets a live id here."""
    samples = list(twmt16.train(V, V)())
    out = []
    for s in range(n_steps):
        b = samples[(s + seed_skip) * batch_size:
                    (s + seed_skip + 1) * batch_size]
        padded = ttransformer.pad_batch(b, T)
        feed = {n: np.stack([p[i] for p in padded])
                for i, n in enumerate(['src_word', 'trg_word', 'lbl_word'])}
        feed['trg_word'][:, 0] = 2
        out.append(feed)
    return out


def _normalized(program):
    d = json.loads(json.dumps(program._to_dict()))
    for blk in d['blocks']:
        for v in blk['vars']:
            if v['dtype'] == 'int32':
                v['dtype'] = 'int64'
        for op in blk['ops']:
            op.pop('callsite', None)
            if op['attrs'].get('in_dtype') == 'int32':
                op['attrs']['in_dtype'] = 'int64'
    return d


def _assert_same_program(j, t):
    dj, dt = _normalized(j), _normalized(t)
    bj, bt = dj['blocks'][0], dt['blocks'][0]
    assert [v['name'] for v in bt['vars']] == [v['name'] for v in bj['vars']]
    for vj, vt in zip(bj['vars'], bt['vars']):
        assert vt == vj
    assert [o['type'] for o in bt['ops']] == [o['type'] for o in bj['ops']]
    for oj, ot in zip(bj['ops'], bt['ops']):
        assert ot == oj
    assert dt == dj


def _get_model(pkg):
    fluid, framework, unique_name, transformer, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        transformer.get_model(batch_size=4, max_length=T, dict_size=V,
                              warmup_steps=WARMUP, **CFG)
    return main, startup


@pytest.mark.parametrize('which', ['main', 'startup'])
def test_get_model_emits_the_jax_program(which):
    i = 0 if which == 'main' else 1
    j, t = _get_model(JAX)[i], _get_model(PORT)[i]
    _assert_same_program(j, t)
    types = [op.type for op in t.global_block().ops]
    if which == 'main':
        for op_type in ('autodiff', 'adam', 'adam_beta_pow_update',
                        'increment', 'elementwise_pow', 'elementwise_min',
                        'flash_attention', 'dropout'):
            assert op_type in types, op_type
        assert types.count('autodiff') == 1
    else:
        names = set(t.global_block().vars)
        assert '@LR_DECAY_COUNTER@' in names
        assert any(n.startswith('moment1_') for n in names)
        assert any(n.startswith('moment2_') for n in names)
        assert any(n.startswith('beta1_pow_acc') for n in names)


@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_dropout_free_training_program_is_the_jax_program(opt):
    for i in (0, 1):
        _assert_same_program(_build_train(JAX, opt)[i],
                             _build_train(PORT, opt)[i])


def test_wmt16_reader_is_the_jax_reader():
    got = list(twmt16.train(V, V)())
    want = list(jwmt16.train(V, V)())
    assert got == want and len(got) == 2048
    assert list(twmt16.test(V, V)()) == list(jwmt16.test(V, V)())


def _jax_run(opt, n_steps, feeds):
    """JAX training from its own startup. Returns the startup scope (as
    numpy), per-step (loss, {grad name: grad}), and the scope after every
    step."""
    main, startup, loss = _build_train(JAX, opt)
    gnames = _grad_names(main)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        steps, scopes = [], []
        for feed in feeds[:n_steps]:
            out = exe.run(main, feed=feed, fetch_list=[loss] + gnames)
            steps.append((float(np.asarray(out[0]).reshape(())),
                          {g: np.array(a) for g, a in zip(gnames, out[1:])}))
            scopes.append({n: np.array(v, copy=True)
                           for n, v in scope.vars.items()})
    return init, steps, scopes


def _port_run(opt, init, feeds):
    main, _, loss = _build_train(PORT, opt)
    gnames = _grad_names(main)
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    steps = []
    for feed in feeds:
        out = exe.run(main, feed=feed, fetch_list=[loss] + gnames,
                      scope=scope)
        steps.append((float(out[0].reshape(())),
                      dict(zip(gnames, out[1:]))))
    return steps, scope


@pytest.fixture(scope='module')
def adam_runs():
    feeds = _feeds(3)
    init, jsteps, jscopes = _jax_run('adam', 3, feeds)
    return feeds, init, jsteps, jscopes


def test_step_one_gradients_match_the_jax_package(adam_runs):
    feeds, init, jsteps, _ = adam_runs
    tsteps, _ = _port_run('adam', init, feeds[:1])
    jgrads, tgrads = jsteps[0][1], tsteps[0][1]
    assert sorted(jgrads) == sorted(tgrads) and len(tgrads) > 20
    for name, want in jgrads.items():
        got = tgrads[name]
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    # every attention projection gets a gradient (through the Function)
    assert all(np.abs(tgrads[n]).max() > 0 for n in tgrads)


def test_losses_match_over_three_adam_steps(adam_runs):
    feeds, init, jsteps, _ = adam_runs
    tsteps, scope = _port_run('adam', init, feeds)
    jl = [s[0] for s in jsteps]
    tl = [s[0] for s in tsteps]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert abs(jl[2] - jl[0]) > 1e-3      # the steps did move the loss
    state = scope.to_numpy(['@LR_DECAY_COUNTER@'])
    assert float(state['@LR_DECAY_COUNTER@'][0]) == 3.0


def test_run_resumes_across_packages(adam_runs):
    """The JAX scope after 2 steps, carried whole into the port, gives
    JAX's step 3: loss, grads, and every persistable after it."""
    feeds, _, jsteps, jscopes = adam_runs
    after2, after3 = jscopes[1], jscopes[2]
    assert '@LR_DECAY_COUNTER@' in after2
    assert any(n.startswith('moment') for n in after2)
    assert any('pow_acc' in n for n in after2)
    tsteps, scope = _port_run('adam', after2, feeds[2:3])
    assert abs(tsteps[0][0] - jsteps[2][0]) < 1e-4
    back = scope.to_numpy(sorted(after3))
    for n, want in after3.items():
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(back[n], want, rtol=0, atol=1e-5 * scale,
                                   err_msg=n)


def test_params_match_after_three_sgd_steps():
    feeds = _feeds(3, seed_skip=5)
    init, _, jscopes = _jax_run('sgd', 3, feeds)
    _, scope = _port_run('sgd', init, feeds)
    want = jscopes[-1]
    main = _build_train(PORT, 'sgd')[0]
    params = [p.name for p in main.all_parameters()]
    got = scope.to_numpy(params)
    moved = 0
    for n in params:
        scale = max(float(np.abs(want[n]).max()), 1e-12)
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=1e-5 * scale, err_msg=n)
        moved += not np.array_equal(want[n], init[n])
    assert moved == len(params)


def test_trained_program_serves_and_cpu_steps_launch_no_kernel(tmp_path):
    main, startup, loss = _build_train(PORT, 'adam')
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = {n: k.launches for n, k in tops.KERNELS.items()}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(()))
              for f in _feeds(2)]
    assert all(np.isfinite(losses))
    assert {n: k.launches for n, k in tops.KERNELS.items()} == before
    assert not any(v.requires_grad or v.grad_fn is not None
                   for v in scope.vars.values())
    blk = main.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    logits = [op.input('X')[0] for op in blk.ops
              if op.type == 'reshape' and op.output('Out')[0] == lg][0]
    test_prog = main.clone(for_test=True)
    assert not any(op.type in ('autodiff', 'adam', 'increment')
                   for op in test_prog.global_block().ops)
    tfluid.io.save_inference_model(str(tmp_path), ['src_word', 'trg_word'],
                                   [test_prog.global_block().var(logits)],
                                   exe, main_program=test_prog, scope=scope)
    pred = tinference.Predictor(str(tmp_path), place=tfluid.CPUPlace())
    feed = _feeds(1)[0]
    got = pred.run({n: feed[n] for n in ('src_word', 'trg_word')})[0]
    want = exe.run(test_prog, feed=feed, fetch_list=[logits], scope=scope)[0]
    assert got.shape == (4, T, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_a_second_autodiff_op_is_refused():
    main, startup, loss = _build_train(PORT, 'sgd')
    with tframework.program_guard(main, startup):
        tfluid.backward.append_backward(main.global_block().var(loss))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match='at most one append_backward'):
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)


def _build_mlp(pkg):
    """A small regression net with every clip and regularizer class of the
    port: a ParamAttr regularizer on one layer, the optimizer's on the
    rest, one layer clipped by value, one not clipped, the last two by
    global norm."""
    fluid, framework, unique_name, _, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[8])
        label = fluid.layers.data(name='y', shape=[1])
        h = fluid.layers.fc(input=x, size=16, act='relu',
                            param_attr=fluid.ParamAttr(
                                name='w0',
                                regularizer=fluid.regularizer.L1Decay(1e-3)))
        h = fluid.layers.fc(input=h, size=16, act='relu',
                            param_attr=fluid.ParamAttr(name='w1'))
        y = fluid.layers.fc(input=h, size=1,
                            param_attr=fluid.ParamAttr(name='w2'))
        d = fluid.layers.elementwise_sub(y, label)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(d, d))
        clip = fluid.clip
        clip.set_gradient_clip(clip.GradientClipByValue(0.05),
                               param_list=['w0'])
        clip.set_gradient_clip(clip.GradientClipByGlobalNorm(1.0),
                               param_list=['w2', 'fc_0.b_0'])
        fluid.optimizer.SGD(
            learning_rate=0.05,
            regularization=fluid.regularizer.L2Decay(1e-2)).minimize(loss)
    return main, startup, loss.name


def test_clips_regularizers_and_optimizers_match_the_jax_package():
    jmain, jstart, jloss = _build_mlp(JAX)
    tmain, tstart, tloss = _build_mlp(PORT)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    types = {op.type for op in tmain.global_block().ops}
    assert {'clip', 'square', 'sum', 'sqrt', 'elementwise_max', 'sign',
            'sgd'} <= types
    r = np.random.RandomState(3)
    feeds = [{'x': r.randn(6, 8).astype('float32'),
              'y': r.randn(6, 1).astype('float32')} for _ in range(3)]
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
        jl = [float(np.asarray(jexe.run(jmain, feed=f,
                                        fetch_list=[jloss])[0]))
              for f in feeds]
        want = {n: np.array(v) for n, v in jscope.vars.items()}
    tscope = tfluid.Scope()
    tscope.load_numpy(init, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=tscope)[0]) for f in feeds]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    got = tscope.to_numpy(sorted(want))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_error_clip_callbacks_raise_on_use():
    """append_backward's callbacks (the reference's error clipping) are
    accepted and, as in the JAX package, not called: the program is the
    one built without them, in both packages (the name is from when the
    port refused them)."""
    progs = []
    for fluid, framework, unique_name, _, _ in (JAX, PORT, PORT):
        main, startup = framework.Program(), framework.Program()
        with unique_name.guard(), framework.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[4])
            loss = fluid.layers.reduce_sum(fluid.layers.fc(input=x, size=1))
            callbacks = None if len(progs) == 2 else [object()]
            pg = fluid.backward.append_backward(loss, callbacks=callbacks)
        assert [p.name for p, _ in pg] == ['fc_0.w_0', 'fc_0.b_0']
        progs.append(main)
    _assert_same_program(progs[0], progs[1])
    _assert_same_program(progs[1], progs[2])