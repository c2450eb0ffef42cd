"""fluid.contrib.Float16Transpiler of the PyTorch port against the JAX
package's (tests/test_contrib.py:221-280), on the CPU:

  * the same small fc net from the same weights, transpiled by each
    package: the same names converted, the scope's weights bf16, the
    program's var dtypes patched, float32 fetches, answers within 1e-5 of
    max |p| of each other (both take the exact product of the bf16-rounded
    operands in fp32) and within 0.02 of the fp32 answers (the JAX test's
    bound);
  * AMP and the fetch contract survive clone(for_test=True), and a
    non-Program raises TypeError;
  * a small Transformer's inference artifact, transpiled inside the
    Predictor that loaded it, served through ServingEngine: fp32 logits
    equal to Predictor.run's, and within four bf16 ulps of max |logit| of
    the JAX package's transpiled program from the same weights (each
    package rounds the bf16 activations of 2+2 layers once per op, from
    fp32 values summed in other orders);
  * save_inference_model of a transpiled program keeps its bf16 weights
    through the round trip (widened to float32 in the .npz, exactly).
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import transformer as ttransformer

JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)


def _fc_net(pkg):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        h = fluid.layers.fc(input=x, size=32, act='relu')
        pred = fluid.layers.fc(input=h, size=4, act='softmax')
    return main, startup, pred.name


@pytest.fixture(scope='module')
def jax_transpiled():
    """The JAX test's run: fp32 answers, the transpiled answers, the
    converted names and the startup weights."""
    main, startup, pred = _fc_net(JAX)
    infer = main.clone(for_test=True)
    scope = JScope()
    X = np.random.RandomState(0).randn(16, 8).astype('float32')
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        ref, = exe.run(infer, feed={'x': X}, fetch_list=[pred])
        converted = jfluid.contrib.Float16Transpiler().transpile(
            infer, jfluid.CPUPlace(), scope=scope)
        half, = exe.run(infer, feed={'x': X}, fetch_list=[pred])
    return init, X, np.asarray(ref), np.asarray(half), converted


def test_float16_transpiler_matches_the_jax_one(jax_transpiled):
    init, X, jref, jhalf, jconverted = jax_transpiled
    main, _, pred = _fc_net(PORT)
    infer = main.clone(for_test=True)
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    ref, = exe.run(infer, feed={'x': X}, fetch_list=[pred], scope=scope)
    converted = tfluid.contrib.Float16Transpiler().transpile(
        infer, tfluid.CPUPlace(), scope=scope)
    half, = exe.run(infer, feed={'x': X}, fetch_list=[pred], scope=scope)
    assert set(converted) == set(jconverted) == {
        'fc_0.w_0', 'fc_0.b_0', 'fc_1.w_0', 'fc_1.b_0'}
    # users keep fetching float32
    assert half.dtype == np.float32 and jhalf.dtype == np.float32
    np.testing.assert_allclose(ref, jref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(half, jhalf, rtol=0,
                               atol=1e-5 * float(np.abs(jhalf).max()))
    np.testing.assert_allclose(ref, half, atol=0.02)
    assert not np.array_equal(ref, half)
    for n in converted:
        assert scope.vars[n].dtype == torch.bfloat16
        assert infer.global_block().vars[n].dtype == 'bfloat16'
    assert tfluid.amp.is_amp(infer) and infer._fetch_f32
    assert exe.cache_stats['misses'] == 2      # fp32, then transpiled


def test_float16_transpiled_program_survives_clone():
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
        pred = tfluid.layers.fc(input=x, size=2)
    infer = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.contrib.Float16Transpiler().transpile(infer)
    clone = infer.clone(for_test=True)
    out, = exe.run(clone, feed={'x': np.ones((2, 4), 'float32')},
                   fetch_list=[pred.name], scope=scope)
    # the fetch-f32 contract and amp mode survive cloning
    assert out.dtype == np.float32
    # device fetches too: a bf16 weight comes back as an fp32 tensor
    w = [p.name for p in clone.all_parameters()][0]
    dev, = exe.run(clone, feed={'x': np.ones((2, 4), 'float32')},
                   fetch_list=[w], scope=scope, return_numpy=False)
    assert scope.vars[w].dtype == torch.bfloat16
    assert dev.dtype == torch.float32
    assert torch.equal(dev, scope.vars[w].to(torch.float32))
    assert getattr(clone, '_fetch_f32', False)
    assert tfluid.amp.is_amp(clone)
    with pytest.raises(TypeError):
        tfluid.contrib.Float16Transpiler().transpile('not a program')
    assert tfluid.contrib.BF16Transpiler is tfluid.contrib.Float16Transpiler


CFG = dict(src_vocab_size=50, trg_vocab_size=50, max_length=12, n_layer=2,
           d_model=32, n_head=4, d_inner=64)


def _logits_var(program):
    blk = program.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    return blk.var([op.input('X')[0] for op in blk.ops
                    if op.type == 'reshape' and op.output('Out')[0] == lg][0])


def _transformer_artifact(pkg, transformer):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        transformer.transformer(dropout_rate=0.0, **CFG)
    return main, startup


def _requests(n, rows):
    r = np.random.RandomState(21)
    out = []
    for _ in range(n):
        feed = {k: r.randint(1, CFG['src_vocab_size'],
                             (rows, CFG['max_length'])).astype('int64')
                for k in ('src_word', 'trg_word')}
        feed['trg_word'][0, 8:] = 0          # a padded target
        out.append(feed)
    return out


def test_transpiled_transformer_serves_as_the_jax_one(tmp_path):
    jmain, jstartup = _transformer_artifact(JAX, jtransformer)
    jscope = JScope()
    reqs = _requests(3, 2)
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
        logits = _logits_var(jmain)
        jinfer = jmain.clone(for_test=True).prune([logits])
        jfluid.contrib.Float16Transpiler().transpile(jinfer, scope=jscope)
        want = [np.asarray(jexe.run(jinfer, feed=f,
                                    fetch_list=[logits.name])[0])
                for f in reqs]
    main, _ = _transformer_artifact(PORT, ttransformer)
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    tfluid.io.save_inference_model(str(tmp_path), ['src_word', 'trg_word'],
                                   [_logits_var(main)], exe,
                                   main_program=main, scope=scope)
    pred = tinference.Predictor(str(tmp_path), place=tfluid.CPUPlace())
    converted = tfluid.contrib.Float16Transpiler().transpile(
        pred._program, scope=pred._scope)
    assert len(converted) > 30
    engine = tserving.ServingEngine(pred, tserving.ServingConfig(
        max_batch_size=4, max_queue_delay_ms=5.0))
    try:
        engine.warmup()
        answers = [f.result(timeout=300)[0]
                   for f in [engine.submit(r) for r in reqs]]
    finally:
        engine.shutdown()
    for req, got, ref in zip(reqs, answers, want):
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, pred.run(req)[0])
        np.testing.assert_allclose(got, ref.astype(np.float32), rtol=0,
                                   atol=4 * 2.0 ** (np.floor(np.log2(
                                       np.abs(ref).max())) - 7))


def test_transpiled_weights_survive_save_and_load(tmp_path):
    main, startup, pred = _fc_net(PORT)
    infer = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.contrib.Float16Transpiler().transpile(infer, scope=scope)
    X = np.random.RandomState(1).randn(3, 8).astype('float32')
    want, = exe.run(infer, feed={'x': X}, fetch_list=[pred], scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), ['x'],
                                   [infer.global_block().var(pred)], exe,
                                   main_program=infer, scope=scope)
    loaded = tinference.Predictor(str(tmp_path), place=tfluid.CPUPlace())
    w = loaded._scope.vars['fc_0.w_0']
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, scope.vars['fc_0.w_0'])
    # the saved program keeps the bf16 dtypes, not the AMP flag (the
    # program desc carries no execution flags, as in the JAX package):
    # transpiling the loaded program gives the same answers
    tfluid.contrib.Float16Transpiler().transpile(loaded._program,
                                                 scope=loaded._scope)
    np.testing.assert_array_equal(loaded.run({'x': X})[0], want)
