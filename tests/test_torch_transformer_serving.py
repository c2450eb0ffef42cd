"""The PyTorch port's serving slice against the JAX package, on the CPU, at a
small Transformer (2+2 layers, d_model 64, 4 heads, d_inner 128, vocab 100,
max_length 16):

  * the port's builder emits the same Program as the JAX builder, op for op
    (types, slots, var names, shapes, attrs); dtypes compare modulo
    int64/int32, because the JAX package runs with x64 off and infers int32
    for ids;
  * an inference artifact saved by either package loads in the other and
    gives the same logits, at 1e-4 (fp32, different summation orders over
    a few layers);
  * the port's ServingEngine answers concurrent requests as Predictor.run
    does.
"""
import concurrent.futures
import json

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
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

CFG = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
           n_layer=2, d_model=64, n_head=4, d_inner=128)
TOL = 1e-4

JAX = (jfluid, jframework, junique, jtransformer, JScope)
PORT = (tfluid, tframework, tunique, ttransformer, tfluid.Scope)


def _build(pkg):
    fluid, framework, unique_name, transformer, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        transformer.transformer(**CFG)
    return main, startup


def logits_var(program):
    """The decoder logits [B, T, V]: the X input of the reshape whose
    output is the Logits input of softmax_with_cross_entropy."""
    blk = program.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    return blk.var([op.input('X')[0] for op in blk.ops
                    if op.type == 'reshape' and op.output('Out')[0] == lg][0])


def _save_artifact(pkg, dirname):
    fluid = pkg[0]
    main, startup = _build(pkg)
    main.random_seed = startup.random_seed = 7
    scope = pkg[4]()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(str(dirname), ['src_word', 'trg_word'],
                                      [logits_var(main)], exe,
                                      main_program=main)
    return str(dirname)


def _feed(B=3, seed=0):
    r = np.random.RandomState(seed)
    T = CFG['max_length']
    src = r.randint(1, CFG['src_vocab_size'], (B, T)).astype('int64')
    trg = r.randint(1, CFG['trg_vocab_size'], (B, T)).astype('int64')
    for i in range(B):      # ragged lengths, padded with id 0
        src[i, r.randint(1, T + 1):] = 0
        trg[i, r.randint(1, T + 1):] = 0
    return {'src_word': src, 'trg_word': trg}


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


@pytest.mark.parametrize('which', ['main', 'startup'])
def test_builder_emits_the_jax_program(which):
    j = _build(JAX)[0 if which == 'main' else 1]
    t = _build(PORT)[0 if which == 'main' else 1]
    dj, dt = _normalized(j), _normalized(t)
    bj, bt = dj['blocks'][0], dt['blocks'][0]
    assert [v['name'] for v in bt['vars']] == [v['name'] for v in bj['vars']]
    for vj, vt in zip(bj['vars'], bt['vars']):
        assert vt == vj
    assert [o['type'] for o in bt['ops']] == [o['type'] for o in bj['ops']]
    for oj, ot in zip(bj['ops'], bt['ops']):
        assert ot == oj
    assert dt == dj
    if which == 'main':
        n_attention = sum(o['type'] == 'flash_attention' for o in bt['ops'])
        assert n_attention == 3 * CFG['n_layer']


@pytest.mark.parametrize('saved_by', ['jax', 'port'])
def test_artifact_crosses_packages_with_the_same_logits(tmp_path, saved_by):
    d = _save_artifact(JAX if saved_by == 'jax' else PORT, tmp_path)
    feed = _feed()
    want = jinference.Predictor(d, place=jfluid.CPUPlace()).run(feed)[0]
    pred = tinference.Predictor(d, place=tfluid.CPUPlace())
    got = pred.run(feed)[0]
    assert got.shape == (3, CFG['max_length'], CFG['trg_vocab_size'])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert pred.feed_names == ['src_word', 'trg_word']
    assert pred.input_spec == {'src_word': ((-1, 16), 'int64'),
                               'trg_word': ((-1, 16), 'int64')}


def test_weights_carry_across_through_a_scope(tmp_path):
    """The JAX scope's parameters, as {name: ndarray}, loaded into a port
    Scope, run the port's program to the JAX program's logits."""
    jmain, jstart = _build(JAX)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        feed = _feed(B=2, seed=1)
        jlogits = logits_var(jmain).name
        want = jexe.run(jmain.clone(for_test=True).prune([jlogits]),
                        feed=feed, fetch_list=[jlogits])[0]
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    tmain, _ = _build(PORT)
    tscope = tfluid.Scope()
    tscope.load_numpy(arrays, tfluid.CPUPlace())
    tlogits = logits_var(tmain).name
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain.clone(for_test=True).prune([tlogits]), feed=feed,
        fetch_list=[tlogits], scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    back = tscope.to_numpy(sorted(arrays))
    for n in arrays:
        np.testing.assert_array_equal(back[n], arrays[n])


def test_serving_engine_answers_as_predictor_run(tmp_path):
    pred = tinference.Predictor(_save_artifact(PORT, tmp_path),
                                place=tfluid.CPUPlace())
    feeds = [_feed(B=n, seed=10 + i) for i, n in enumerate([1, 3, 2, 1, 4])]
    engine = tserving.ServingEngine(pred, tserving.ServingConfig(
        max_batch_size=8, max_queue_delay_ms=200.0))
    try:
        assert engine.warmup() == [1, 2, 4, 8]
        with concurrent.futures.ThreadPoolExecutor(len(feeds)) as pool:
            futs = list(pool.map(engine.submit, feeds))
        answers = [f.result(timeout=60)[0] for f in futs]
        stats = engine.stats
    finally:
        assert engine.shutdown(timeout=60)
    assert stats['completed'] == len(feeds) and stats['batch_errors'] == 0
    assert stats['batches'] < len(feeds)       # requests were coalesced
    for feed, ans in zip(feeds, answers):
        np.testing.assert_allclose(ans, pred.run(feed)[0], rtol=1e-5,
                                   atol=1e-5)


def test_seeded_startup_is_reproducible_and_predictor_is_thread_safe(
        tmp_path):
    a = tinference.Predictor(_save_artifact(PORT, tmp_path / 'a'),
                             place=tfluid.CPUPlace())
    b = tinference.Predictor(_save_artifact(PORT, tmp_path / 'b'),
                             place=tfluid.CPUPlace())
    for n in a._scope.vars:
        np.testing.assert_array_equal(a._scope.vars[n].numpy(),
                                      b._scope.vars[n].numpy())
    feed = _feed(B=2, seed=3)
    want = a.run(feed)[0]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: a.run(feed)[0], range(8)))
    for o in outs:
        np.testing.assert_array_equal(o, want)


def test_executor_names_a_missing_feed():
    main, startup = _build(PORT)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(KeyError, match='trg_word'):
        exe.run(main.clone(for_test=True),
                feed={'src_word': _feed()['src_word']},
                fetch_list=[logits_var(main).name], scope=scope)
