"""The port's decoder library (fluid/contrib/decoder: InitState, StateCell,
TrainingDecoder, BeamSearchDecoder) against the JAX package's, on the
CPU, at the sizes of the JAX tests/test_contrib.py (dict 30, word and
hidden 8, beam 2, max_len 5):

  * TrainingDecoder's seq2seq emits the JAX program op for op (every
    block, startup too), and 3 Adagrad steps from the JAX startup scope
    (Scope.load_numpy) give the JAX losses and parameters within
    TOL = 1e-5 of max(1, |x|);
  * BeamSearchDecoder from the JAX scope gives the JAX ids, equal, and
    scores within TOL; the beams come best first;
  * with the start id equal to end_id every beam stays at end_id.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.contrib import decoder as jdecoder
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.executor import scope_guard as jscope_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.contrib import decoder as tdecoder
from paddle_tpu_torch.fluid.executor import scope_guard as tscope_guard

from test_torch_training import _assert_same_program

JAX = (jfluid, jframework, junique, JScope, jscope_guard, jdecoder)
PORT = (tfluid, tframework, tunique, tfluid.Scope, tscope_guard, tdecoder)
DICT = 30
WORD_DIM = 8
HIDDEN = 8
BEAM = 2
MAX_LEN = 5
TOL = 1e-5
STEPS = 3


def _encoder(layers):
    src = layers.data(name='src_word', shape=[1], dtype='int64', lod_level=1)
    emb = layers.embedding(input=src, size=[DICT, WORD_DIM], dtype='float32')
    fc1 = layers.fc(input=emb, size=HIDDEN * 4, act='tanh')
    h, _ = layers.dynamic_lstm(input=fc1, size=HIDDEN * 4)
    return layers.sequence_last_step(input=h)


def _state_cell(layers, decoder, context):
    h = decoder.InitState(init=context, need_reorder=True)
    cell = decoder.StateCell(inputs={'x': None}, states={'h': h},
                             out_state='h')

    @cell.state_updater
    def updater(cell):
        word = cell.get_input('x')
        prev_h = cell.get_state('h')
        cell.set_state('h', layers.fc(input=[prev_h, word], size=HIDDEN,
                                      act='tanh'))
    return cell


def _training(pkg):
    fluid, framework, unique_name, _, _, decoder = pkg
    layers = fluid.layers
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        cell = _state_cell(layers, decoder, _encoder(layers))
        trg = layers.data(name='trg_word', shape=[1], dtype='int64',
                          lod_level=1)
        trg_emb = layers.embedding(input=trg, size=[DICT, WORD_DIM],
                                   dtype='float32')
        dec = decoder.TrainingDecoder(cell)
        with dec.block():
            word = dec.step_input(trg_emb)
            dec.state_cell.compute_state(inputs={'x': word})
            score = layers.fc(input=dec.state_cell.get_state('h'),
                              size=DICT, act='softmax')
            dec.state_cell.update_states()
            dec.output(score)
        label = layers.data(name='next_word', shape=[1], dtype='int64',
                            lod_level=1)
        cost = layers.mean(layers.cross_entropy(input=dec(), label=label))
        fluid.optimizer.Adagrad(learning_rate=0.1).minimize(cost)
    return main, startup, cost.name


def _copy_batch():
    rng = np.random.RandomState(0)
    batch = []
    for n in (4, 3, 5, 2):
        seq = rng.randint(2, DICT, size=(n, 1)).astype('int64')
        batch.append((seq, seq, seq))
    return batch


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


@pytest.mark.parametrize('which', [0, 1])
def test_training_decoder_emits_the_jax_program(which):
    _assert_same_program(_training(JAX)[which], _training(PORT)[which])


def test_training_decoder_three_adagrad_steps():
    jmain, jstart, jcost = _training(JAX)
    tmain, tstart, tcost = _training(PORT)
    names = ['src_word', 'trg_word', 'next_word']
    batch = _copy_batch()
    jscope = JScope()
    with jscope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in _persistables(jmain) if jscope.find_var(n)}
        jfeed = jfluid.DataFeeder(place=jfluid.CPUPlace(), feed_list=names,
                                  program=jmain).feed(batch)
        jloss = [float(np.asarray(jexe.run(jmain, feed=jfeed,
                                           fetch_list=[jcost])[0]).reshape(-1)[0])
                 for _ in range(STEPS)]
        jafter = {n: np.asarray(jscope.find_var(n).get_tensor())
                  for n in init}
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstart, scope=tscope)
    tscope.load_numpy(init, tfluid.CPUPlace())
    tfeed = tfluid.DataFeeder(names, tfluid.CPUPlace(),
                              program=tmain).feed(batch)
    tloss = [float(np.asarray(texe.run(tmain, feed=tfeed, fetch_list=[tcost],
                                       scope=tscope)[0]).reshape(-1)[0])
             for _ in range(STEPS)]
    np.testing.assert_allclose(tloss, jloss, rtol=0,
                               atol=TOL * max(1.0, max(map(abs, jloss))))
    assert tloss[-1] < tloss[0]
    tafter = tscope.to_numpy(list(init))
    for n, want in jafter.items():
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tafter[n], want, rtol=0, atol=TOL * scale,
                                   err_msg=n)


def _beam(pkg, topk):
    fluid, framework, unique_name, _, _, decoder = pkg
    layers = fluid.layers
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        cell = _state_cell(layers, decoder, _encoder(layers))
        init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                               lod_level=2)
        init_scores = layers.data(name='init_scores', shape=[1],
                                  dtype='float32', lod_level=2)
        dec = decoder.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=DICT, word_dim=WORD_DIM, input_var_dict={},
            topk_size=topk, sparse_emb=False, max_len=MAX_LEN,
            beam_size=BEAM, end_id=1)
        dec.decode()
        ids, scores = dec()
    return main, startup, ids.name, scores.name


def _decode_both(feed, topk):
    jmain, jstart, jids, jsc = _beam(JAX, topk)
    tmain, tstart, tids, tsc = _beam(PORT, topk)
    _assert_same_program(jmain, tmain)
    jscope = JScope()
    with jscope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in _persistables(jmain) if jscope.find_var(n)}
        want = jexe.run(jmain, feed=feed, fetch_list=[jids, jsc])
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstart, scope=tscope)
    tscope.load_numpy(init, tfluid.CPUPlace())
    got = texe.run(tmain, feed=feed, fetch_list=[tids, tsc], scope=tscope)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL * max(
        1.0, float(np.abs(want[1]).max())))
    return got


def test_beam_search_decoder_matches_jax():
    B = 2
    rng = np.random.RandomState(1)
    feed = {'src_word': rng.randint(2, DICT, size=(B, 4, 1)).astype('int64'),
            'init_ids': np.zeros((B, 1), 'int64'),
            'init_scores': np.ones((B, 1), 'float32')}
    ids, scores = _decode_both(feed, topk=10)
    assert ids.shape == (B, BEAM, MAX_LEN) and scores.shape == (B, BEAM)
    assert ((ids >= 0) & (ids < DICT)).all() and np.isfinite(scores).all()
    assert (scores[:, 0] >= scores[:, 1] - 1e-6).all()


def test_beam_search_decoder_respects_end_id():
    feed = {'src_word': np.full((1, 3, 1), 3, 'int64'),
            'init_ids': np.full((1, 1), 1, 'int64'),
            'init_scores': np.ones((1, 1), 'float32')}
    ids, _ = _decode_both(feed, topk=5)
    assert (ids == 1).all()


def test_decoder_exports_the_jax_classes():
    assert sorted(tdecoder.__all__) == sorted(jdecoder.__all__) == sorted(
        ['InitState', 'StateCell', 'TrainingDecoder', 'BeamSearchDecoder'])
