"""The port's compiled serving artifact (inference.export_compiled /
load_compiled on torch.export, the flash-attention forward as the custom
operator torch.ops.paddle_tpu_torch.flash_attention_lse, ServingEngine
over a loaded artifact, Router.swap without a builder) against the JAX
package's, on the CPU, at small sizes: the two-layer fc net and the
sequence model of tests/test_inference.py, and a Transformer of 2+2
layers, d_model 64, 4 heads, d_inner 128, vocab 100, max_length 16, each
from the JAX startup weights carried into a port Scope by name.

  * each artifact's outputs equal the port's Predictor and the JAX
    load_compiled of the same weights within rtol 1e-5, atol 1e-6 (the
    tests/test_inference.py bound); the Transformer's exported graph holds
    the flash-attention operator 3 x n_layer times and no softmax of its
    own; a Float16Transpiler program exports (bf16 weights) and answers
    as its Predictor does;
  * feeds are validated with the JAX messages (missing, unknown, shape,
    a dtype across kinds; same-kind narrowing accepted); an artifact
    exported for another device type is refused naming both; the default
    place is the card;
  * a fresh python process that imports only paddle_tpu_torch loads and
    runs the artifact;
  * the flash-attention operator: its CPU implementation is the plain
    version (bitwise), torch.library.opcheck passes it, meta tensors get
    the output shapes;
  * ServingEngine over a loaded artifact (its one batch size as the only
    bucket), push_rows into it raising DeltaUnsupported, and
    Router.swap(model, path) from a Predictor generation to an artifact
    under traffic with no future lost.
"""
import concurrent.futures
import importlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
import paddle_tpu.fluid.layers as jlayers
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.fluid.layers as tlayers
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.contrib import Float16Transpiler
from paddle_tpu_torch.models import transformer as ttransformer

fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')

CPU = tfluid.CPUPlace()
RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {'jax': (jfluid, jlayers, jframework, junique, JScope, jinference),
       'port': (tfluid, tlayers, tframework, tunique, tfluid.Scope,
                tinference)}
CFG = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
           n_layer=2, d_model=64, n_head=4, d_inner=128)


def _fc_net(layers):
    x = layers.data(name='x', shape=[8])
    h = layers.fc(input=x, size=16, act='relu')
    return layers.fc(input=h, size=1)


def _seq_net(layers):
    words = layers.data(name='words', shape=[1], dtype='int64', lod_level=1)
    emb = layers.embedding(input=words, size=[30, 8])
    pooled = layers.sequence_pool(input=emb, pool_type='average')
    return layers.fc(input=pooled, size=3, act='softmax')


def _logits_var(program):
    blk = program.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    return blk.var([op.input('X')[0] for op in blk.ops
                    if op.type == 'reshape' and op.output('Out')[0] == lg][0])


def _transformer(layers):
    (jtransformer if layers is jlayers else ttransformer).transformer(**CFG)
    return None       # _build fetches the logits


def _build(pkg, net, seed=0):
    fluid, layers, framework, unique_name, Scope, _ = PKG[pkg]
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        out = net(layers)
    if out is None:
        out = _logits_var(main)
    return main, startup, out


def _exported(tmp_path, net, feed, seed=0):
    """The same net in both packages from the JAX startup weights: each
    package's compiled artifact and the port's inference model saved.
    Returns (port dir, JAX dir, port model dir)."""
    jmain, jstart, jout = _build('jax', net, seed)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        jdir = str(tmp_path / 'jax')
        jinference.export_compiled(jdir, feed, [jout], jexe,
                                   main_program=jmain)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    tmain, _, tout = _build('port', net, seed)
    tscope = tfluid.Scope()
    tscope.load_numpy(arrays, CPU)
    texe = tfluid.Executor(CPU)
    tdir, mdir = str(tmp_path / 'port'), str(tmp_path / 'model')
    path = tinference.export_compiled(tdir, feed, [tout], texe,
                                      main_program=tmain, scope=tscope)
    assert path == os.path.join(tdir, '__model__.pt2')
    tfluid.io.save_inference_model(mdir, sorted(feed), [tout], texe,
                                   main_program=tmain, scope=tscope)
    return tdir, jdir, mdir


def _transformer_feed(B=3, seed=0):
    r = np.random.RandomState(seed)
    T = CFG['max_length']
    src = r.randint(1, CFG['src_vocab_size'], (B, T)).astype('int64')
    trg = r.randint(1, CFG['trg_vocab_size'], (B, T)).astype('int64')
    for i in range(B):
        src[i, r.randint(1, T + 1):] = 0
        trg[i, r.randint(1, T + 1):] = 0
    return {'src_word': src, 'trg_word': trg}


FC_FEED = {'x': np.random.RandomState(0).rand(4, 8).astype('float32')}
SEQ_FEED = {'words': np.random.RandomState(1).randint(
    0, 30, size=(2, 5, 1)).astype('int64')}


@pytest.fixture(scope='module')
def transformer_dirs(tmp_path_factory):
    return _exported(tmp_path_factory.mktemp('tfm'), _transformer,
                     _transformer_feed())


@pytest.mark.parametrize('which', ['fc', 'sequence', 'transformer'])
def test_artifact_answers_as_predictor_and_the_jax_artifact(
        which, tmp_path, transformer_dirs):
    if which == 'transformer':
        (tdir, jdir, mdir), feed = transformer_dirs, _transformer_feed()
    else:
        net, feed = {'fc': (_fc_net, FC_FEED),
                     'sequence': (_seq_net, SEQ_FEED)}[which]
        tdir, jdir, mdir = _exported(tmp_path, net, feed)
    run = tinference.load_compiled(tdir, place=CPU)
    assert run.feed_names == sorted(feed)
    got = run(feed)
    assert run.run(feed)[0].tobytes() == got[0].tobytes()
    want = tinference.Predictor(mdir, place=CPU).run(feed)
    jwant = jinference.load_compiled(jdir)(feed)
    assert len(got) == len(want) == len(jwant) == 1
    assert got[0].shape == np.asarray(jwant[0]).shape
    np.testing.assert_allclose(got[0], np.asarray(want[0]).reshape(
        got[0].shape), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], np.asarray(jwant[0]), rtol=RTOL,
                               atol=ATOL)


def test_transformer_graph_holds_the_flash_attention_operator(
        transformer_dirs):
    ep = torch.export.load(os.path.join(transformer_dirs[0],
                                        '__model__.pt2'))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert targets.count('paddle_tpu_torch.flash_attention_lse.default') \
        == 3 * CFG['n_layer']
    # the plain decomposition's softmax is nowhere in the graph
    assert not [t for t in targets if 'softmax' in t or 'amax' in t
                or t.startswith('aten.exp')]
    with open(os.path.join(transformer_dirs[0], '__model__.meta.json')) as f:
        meta = json.load(f)
    assert meta['device'] == 'cpu'
    assert meta['inputs'] == {
        'src_word': {'shape': [3, 16], 'dtype': 'int64'},
        'trg_word': {'shape': [3, 16], 'dtype': 'int64'}}


def test_compiled_artifact_validates_feeds_with_the_jax_messages(tmp_path):
    tdir, jdir, _ = _exported(tmp_path, _fc_net, FC_FEED)
    xv = FC_FEED['x']
    run = tinference.load_compiled(tdir, place=CPU)
    jrun = jinference.load_compiled(jdir)
    assert run.input_spec == {'x': ((4, 8), 'float32')} == jrun.input_spec
    bad = [{}, {'x': xv, 'bogus': xv}, {'x': xv[:2]},
           {'x': xv.astype('int32')}]
    for feed in bad:
        with pytest.raises(ValueError) as e:
            run(feed)
        with pytest.raises(ValueError) as je:
            jrun(feed)
        assert str(e.value).replace('paddle_tpu_torch', 'paddle_tpu') \
            == str(je.value)
    want, = run({'x': xv})
    got, = run({'x': xv.astype('float64')})      # same-kind narrowing
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_compiled_refuses_another_device_and_defaults_to_the_card(
        tmp_path):
    tdir, _, _ = _exported(tmp_path, _fc_net, FC_FEED)
    meta_path = os.path.join(tdir, '__model__.meta.json')
    with open(meta_path) as f:
        meta = json.load(f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tinference.load_compiled(tdir)
    meta['device'] = 'cuda'
    with open(meta_path, 'w') as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match='exported for cuda.*on cpu'):
        tinference.load_compiled(tdir, place=CPU)


def test_a_fresh_process_serves_the_artifact(tmp_path, transformer_dirs):
    """The Transformer's artifact: loading it needs the flash-attention
    operator registered, which importing paddle_tpu_torch does."""
    tdir = transformer_dirs[0]
    feed = _transformer_feed()
    np.savez(str(tmp_path / 'feed.npz'), **feed)
    code = (
        'import sys, numpy as np\n'
        'import paddle_tpu_torch\n'
        'from paddle_tpu_torch import fluid, inference\n'
        'run = inference.load_compiled(sys.argv[1], fluid.CPUPlace())\n'
        'feed = dict(np.load(sys.argv[2]))\n'
        'np.save(sys.argv[3], run(feed)[0])\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "paddle_tpu" or m.startswith("paddle_tpu.")]\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code, tdir,
                        str(tmp_path / 'feed.npz'), str(tmp_path / 'out')],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    got = np.load(str(tmp_path / 'out.npy'))
    want = tinference.load_compiled(tdir, place=CPU)(feed)[0]
    assert np.array_equal(got, want)


def test_a_float16_transpiled_program_exports(tmp_path):
    _, _, mdir = _exported(tmp_path, _fc_net, FC_FEED)
    feed = FC_FEED
    pred = tinference.Predictor(mdir, place=CPU)
    Float16Transpiler().transpile(pred._program, scope=pred._scope)
    want = pred.run(feed)[0]
    adir = str(tmp_path / 'bf16')
    tinference.export_compiled(adir, feed, pred._fetch_vars, pred._exe,
                               main_program=pred._program,
                               scope=pred._scope)
    ep = torch.export.load(os.path.join(adir, '__model__.pt2'))
    assert {t.dtype for t in ep.state_dict.values()
            if t.is_floating_point()} == {torch.bfloat16}
    got = tinference.load_compiled(adir, place=CPU)(feed)[0]
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the flash-attention operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_operator_on_the_cpu_is_the_plain_version(
        dtype, causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 5, 8, generator=g).to(dtype)
               for _ in range(3))
    kb = torch.zeros(2, 5)
    kb[1, 3:] = -1e9
    o, lse = torch.ops.paddle_tpu_torch.flash_attention_lse(
        q, k, v, kb, causal, 0.25)
    po, plse = fa.flash_attention_lse_plain(q, k, v, kb, causal, 0.25)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_attention_lse,
                          (q, k, v, kb, causal, 0.25))
    mo, mlse = torch.ops.paddle_tpu_torch.flash_attention_lse(
        q.to('meta'), k.to('meta'), v.to('meta'), kb.to('meta'), causal,
        0.25)
    assert mo.shape == q.shape and mo.dtype == dtype
    assert mlse.shape == q.shape[:3] and mlse.dtype == torch.float32


# ---------------------------------------------------------------------------
# the artifact behind the serving engine and the router
# ---------------------------------------------------------------------------

def test_engine_over_a_compiled_artifact(tmp_path):
    tdir, _, mdir = _exported(tmp_path, _fc_net, FC_FEED)
    run = tinference.load_compiled(tdir, place=CPU)
    want = tinference.Predictor(mdir, place=CPU).run(FC_FEED)[0]
    eng = serving.ServingEngine(run, serving.ServingConfig(
        max_batch_size=4, buckets=[4], max_queue_delay_ms=5))
    try:
        assert eng.warmup() == [4]          # zeros from the exported spec
        xv = FC_FEED['x']
        futs = [eng.submit({'x': xv[i:i + 2]}) for i in (0, 2)]
        got = np.concatenate([f.result(30)[0] for f in futs], axis=0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        with pytest.raises(serving.DeltaUnsupported,
                           match='compiled artifact'):
            eng.push_rows({'fc_0.w_0': (np.array([0]),
                                        np.zeros((1, 16), np.float32))})
    finally:
        eng.shutdown()


def test_router_swap_loads_the_compiled_artifact(tmp_path):
    """The JAX tests/test_decode.py:1306 drill in the port."""
    tdir, _, _ = _exported(tmp_path, _fc_net, FC_FEED)
    cfg = serving.ServingConfig(max_batch_size=4, buckets=[4],
                                max_queue_delay_ms=5)
    eng = serving.ServingEngine(tinference.load_compiled(tdir, place=CPU),
                                cfg)
    eng.warmup()
    want, = eng.predict(FC_FEED, timeout=30)
    r = serving.Router(window_s=1e9)
    r.add_model('m', [eng])
    try:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            r.swap('m', tdir)   # the default builder loads on the card
        assert r.models()['m']['version'] == 1
        assert r.swap('m', tdir, config=cfg,
                      builder=lambda p: serving.ServingEngine(
                          tinference.load_compiled(p, place=CPU),
                          cfg)) == 2
        out, = r.predict('m', FC_FEED, timeout=30)
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
        assert r.models()['m']['path'] == tdir
    finally:
        assert r.shutdown(timeout=60)


def test_router_swap_without_builder_under_traffic(tmp_path, monkeypatch):
    """Generation 1 a Predictor, generation 2 an artifact of other
    weights, cut over by swap(model, path) while a client sends requests:
    no future fails or is lost, answers before equal generation 1's and
    after equal generation 2's."""
    _, _, mdir = _exported(tmp_path / 'g1', _fc_net, FC_FEED, seed=1)
    tdir2, _, mdir2 = _exported(tmp_path / 'g2', _fc_net, FC_FEED, seed=2)
    want1 = tinference.Predictor(mdir, place=CPU).run(FC_FEED)[0]
    want2 = tinference.Predictor(mdir2, place=CPU).run(FC_FEED)[0]
    assert not np.allclose(want1, want2)
    # the default builder's load_compiled on the CPU of this machine
    load = tinference.load_compiled
    monkeypatch.setattr(tinference, 'load_compiled',
                        lambda d, place=None: load(d, place=CPU))
    cfg = serving.ServingConfig(max_batch_size=4, buckets=[4],
                                max_queue_delay_ms=2)
    eng1 = serving.ServingEngine(tinference.Predictor(mdir, place=CPU), cfg)
    eng1.warmup()
    r = serving.Router(window_s=0.0)
    r.add_model('m', [eng1])
    answers, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            fut = r.submit('m', FC_FEED)
            answers.append(fut)

    th = threading.Thread(target=client, daemon=True)
    try:
        th.start()
        while len(answers) < 5:
            time.sleep(0.001)
        assert r.swap('m', tdir2) == 2
        n_at_swap = len(answers)
        while len(answers) < n_at_swap + 5:
            time.sleep(0.001)
        stop.set()
        th.join(30)
        results = [f.result(30)[0] for f in answers]
    finally:
        stop.set()
        r.shutdown(timeout=60)
    gen = []
    for got in results:
        if np.allclose(got, want1, rtol=RTOL, atol=ATOL):
            gen.append(1)
        else:
            np.testing.assert_allclose(got, want2, rtol=RTOL, atol=ATOL)
            gen.append(2)
    assert gen[0] == 1 and gen[-1] == 2
    assert gen == sorted(gen)       # one cutover, never back
    assert isinstance(r.models()['m'], dict)
