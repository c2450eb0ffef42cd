"""Boundaries of the PyTorch port (paddle_tpu_torch):

  * it imports neither jax nor the JAX package (checked in a fresh
    interpreter, and on every source line), nor ml_dtypes, which the
    machine with the card does not have (bf16 crosses numpy through
    16-bit views);
  * its entry points run on the card unless asked for the CPU: with no
    card, Executor(), Predictor(dirname), inference.load_compiled(dirname)
    and serving.DecodeEngine(weights) raise instead of running on the CPU (Trainer() and Inferencer():
    tests/test_torch_trainer.py);
  * chip_smoke.py refuses to run, and prints no result, without a card or
    outside a checkout;
  * every module the two packages share exports (`__all__`) every name the
    JAX module exports, less the names a ROADMAP queue item holds, each
    listed in _HELD with the item's title.
"""
import importlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
SUBMODULES = [
    'paddle_tpu_torch', 'paddle_tpu_torch.obs', 'paddle_tpu_torch.fluid',
    'paddle_tpu_torch.fluid.layers', 'paddle_tpu_torch.fluid.io',
    'paddle_tpu_torch.fluid.executor', 'paddle_tpu_torch.fluid.ops_impl',
    'paddle_tpu_torch.ops', 'paddle_tpu_torch.ops.flash_attention',
    'paddle_tpu_torch.inference', 'paddle_tpu_torch.serving',
    'paddle_tpu_torch.models.transformer', 'paddle_tpu_torch.batch',
    'paddle_tpu_torch.dataset.wmt16', 'paddle_tpu_torch.fluid.backward',
    'paddle_tpu_torch.fluid.optimizer', 'paddle_tpu_torch.fluid.clip',
    'paddle_tpu_torch.fluid.regularizer',
    'paddle_tpu_torch.fluid.layers.learning_rate_scheduler',
    'paddle_tpu_torch.fluid.ops_impl.optim_ops',
    'paddle_tpu_torch.fluid.layers.metric_op', 'paddle_tpu_torch.embedding',
    'paddle_tpu_torch.embedding.lookup', 'paddle_tpu_torch.ops.kernels',
    'paddle_tpu_torch.ops.kernels.sparse_optim',
    'paddle_tpu_torch.models.deepfm', 'paddle_tpu_torch.dataset.common',
    'paddle_tpu_torch.ops.kernels.paged_attention',
    'paddle_tpu_torch.fluid.ops_impl.lod_beam',
    'paddle_tpu_torch.fluid.ops_impl.sampled_ops',
    'paddle_tpu_torch.serving.pages', 'paddle_tpu_torch.serving.decode',
    'paddle_tpu_torch.reader', 'paddle_tpu_torch.dataset.uci_housing',
    'paddle_tpu_torch.dataset.mnist', 'paddle_tpu_torch.dataset.cifar',
    'paddle_tpu_torch.dataset.image', 'paddle_tpu_torch.dataset.flowers',
    'paddle_tpu_torch.fluid.nets', 'paddle_tpu_torch.fluid.data_feeder',
    'paddle_tpu_torch.fluid.ops_impl.nn_ops',
    'paddle_tpu_torch.models.fit_a_line', 'paddle_tpu_torch.models.mnist',
    'paddle_tpu_torch.models.resnet', 'paddle_tpu_torch.fluid.amp',
    'paddle_tpu_torch.fluid.contrib',
    'paddle_tpu_torch.fluid.contrib.float16_transpiler',
    'paddle_tpu_torch.fluid.ops_impl.math_ops',
    'paddle_tpu_torch.fluid.lod_tensor',
    'paddle_tpu_torch.fluid.ops_impl.sequence_ops',
    'paddle_tpu_torch.fluid.ops_impl.extra_ops',
    'paddle_tpu_torch.models.stacked_dynamic_lstm',
    'paddle_tpu_torch.models.understand_sentiment',
    'paddle_tpu_torch.models.machine_translation',
    'paddle_tpu_torch.dataset.imdb', 'paddle_tpu_torch.dataset.wmt14',
    # machine translation generation and token-fed decode: the prefill's
    # admission buckets and the engine's typed errors
    'paddle_tpu_torch.serving.buckets', 'paddle_tpu_torch.serving.engine',
    # the last three book models: the CRF/CTC rules, their datasets and
    # models, compat
    'paddle_tpu_torch.fluid.ops_impl.crf_ctc_ops',
    'paddle_tpu_torch.dataset.imikolov', 'paddle_tpu_torch.dataset.movielens',
    'paddle_tpu_torch.dataset.conll05', 'paddle_tpu_torch.models.word2vec',
    'paddle_tpu_torch.models.recommender_system',
    'paddle_tpu_torch.models.label_semantic_roles',
    'paddle_tpu_torch.compat',
    # control flow and the LoD beam search: the block ops, the debug
    # rules, the layers and the decoder library
    'paddle_tpu_torch.fluid.ops_impl.block_ops',
    'paddle_tpu_torch.fluid.ops_impl.control_ops',
    'paddle_tpu_torch.fluid.layers.control_flow',
    'paddle_tpu_torch.fluid.contrib.decoder',
    'paddle_tpu_torch.fluid.contrib.decoder.beam_search_decoder',
    # the high-level Trainer and its data path: the Trainer, Inferencer,
    # metrics, the reader decorators and prefetch pipeline, retry
    'paddle_tpu_torch.fluid.trainer', 'paddle_tpu_torch.fluid.inferencer',
    'paddle_tpu_torch.fluid.metrics', 'paddle_tpu_torch.fluid.average',
    'paddle_tpu_torch.fluid.evaluator', 'paddle_tpu_torch.reader.pipeline',
    'paddle_tpu_torch.reader.creator', 'paddle_tpu_torch.reader.decorator',
    'paddle_tpu_torch.utils', 'paddle_tpu_torch.utils.retry',
    # online training with live serving freshness: the vocab, the
    # publisher, the row codec, the router and the shared LRU
    'paddle_tpu_torch.streaming', 'paddle_tpu_torch.streaming.vocab',
    'paddle_tpu_torch.streaming.publish',
    'paddle_tpu_torch.embedding.quant_rows',
    'paddle_tpu_torch.serving.router', 'paddle_tpu_torch.utils.lru',
    # token streaming and the compiled serving artifact: the request
    # trace, the step artifact's exported form
    'paddle_tpu_torch.obs.trace', 'paddle_tpu_torch.fluid.step_artifact',
    # tiered embedding storage and the run-log report: the tier store,
    # the report, the SLO budgets, the fault harness
    'paddle_tpu_torch.embedding.tiers', 'paddle_tpu_torch.obs.report',
    'paddle_tpu_torch.obs.slo', 'paddle_tpu_torch.utils.faults',
    # detection: the SSD family's rules and layers
    'paddle_tpu_torch.fluid.ops_impl.detection_ops',
    'paddle_tpu_torch.fluid.layers.detection',
    # the rest of the training surface and the fluid aux modules
    'paddle_tpu_torch.fluid.initializer',
    'paddle_tpu_torch.fluid.layers.layer_function_generator',
    'paddle_tpu_torch.fluid.layers.device', 'paddle_tpu_torch.models',
    'paddle_tpu_torch.fluid.annotations', 'paddle_tpu_torch.fluid.concurrency',
    'paddle_tpu_torch.fluid.default_scope_funcs',
    'paddle_tpu_torch.fluid.graphviz', 'paddle_tpu_torch.fluid.net_drawer',
    'paddle_tpu_torch.fluid.debugger', 'paddle_tpu_torch.version',
    # the recordio half of the data path: the record files, the native
    # host library, the reader layers and the datasets' converters
    'paddle_tpu_torch.reader.recordio', 'paddle_tpu_torch.utils.native',
    'paddle_tpu_torch.fluid.recordio_writer',
    'paddle_tpu_torch.fluid.layers.io', 'paddle_tpu_torch.dataset.mq2007',
    'paddle_tpu_torch.dataset.sentiment', 'paddle_tpu_torch.dataset.voc2012',
    # data and expert parallelism: the mesh, the collectives, MoE, LocalSGD,
    # the mesh step, ParallelExecutor and the distribute transpiler
    'paddle_tpu_torch.parallel', 'paddle_tpu_torch.parallel.moe',
    'paddle_tpu_torch.parallel.local_sgd',
    'paddle_tpu_torch.fluid.mesh_step',
    'paddle_tpu_torch.fluid.parallel_executor',
    'paddle_tpu_torch.fluid.transpiler',
    'paddle_tpu_torch.fluid.transpiler.distribute_transpiler',
    'paddle_tpu_torch.fluid.transpiler.ps_dispatcher',
    'paddle_tpu_torch.fluid.ops_impl.moe_ops',
]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the no-card contract does not '
                    'apply')


def test_port_imports_without_jax_or_the_jax_package():
    code = ('import sys\n'
            'for m in %r:\n'
            '    __import__(m)\n'
            'bad = sorted(m for m in sys.modules if m == "jax" '
            'or m.startswith("jax.") or m == "paddle_tpu" '
            'or m.startswith("paddle_tpu."))\n'
            'assert not bad, bad\n'
            'print("clean")\n' % (SUBMODULES,))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'clean'


_FORBIDDEN = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)(\.|\s|$)')


def test_no_source_file_of_the_port_imports_jax_or_paddle_tpu():
    offenders = []
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if _FORBIDDEN.match(line):
                        offenders.append('%s:%d: %s' % (
                            os.path.relpath(path, REPO), i, line.strip()))
    with open(os.path.join(REPO, 'chip_smoke.py')) as fh:
        for i, line in enumerate(fh, 1):
            if _FORBIDDEN.match(line):
                offenders.append('chip_smoke.py:%d: %s' % (i, line.strip()))
    assert not offenders, offenders


_ML_DTYPES = re.compile(r'^\s*(import|from)\s+ml_dtypes(\.|\s|$)')


def test_port_imports_without_ml_dtypes():
    """Nothing of the port, chip_smoke.py included, imports ml_dtypes: not
    in a fresh interpreter that imports every module (bf16 feeds, scopes
    and fetches included), not on any source line."""
    code = ('import sys\n'
            'for m in %r:\n'
            '    __import__(m)\n'
            'import numpy as np, paddle_tpu_torch.fluid as fluid\n'
            's = fluid.Scope()\n'
            's.load_numpy({"w": np.ones((2, 2), "float32")}, '
            'fluid.CPUPlace())\n'
            's.vars["w"] = s.vars["w"].bfloat16()\n'
            'assert s.to_numpy()["w"].dtype == np.float32\n'
            'assert "ml_dtypes" not in sys.modules\n'
            'print("clean")\n' % (SUBMODULES,))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'clean'
    offenders = []
    paths = [os.path.join(REPO, 'chip_smoke.py')] + [
        os.path.join(root, f) for root, _, files in os.walk(PORT_DIR)
        for f in files if f.endswith('.py')]
    for path in paths:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if _ML_DTYPES.match(line):
                    offenders.append('%s:%d' % (path, i))
    assert not offenders, offenders


def test_executor_defaults_to_the_card_and_raises_without_one():
    _no_card()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fluid.Executor()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fluid.Executor(fluid.CUDAPlace(0))
    assert fluid.TPUPlace is fluid.CUDAPlace
    assert fluid.core.is_compiled_with_cuda() is False
    assert fluid.Executor(fluid.CPUPlace()).device.type == 'cpu'


def test_predictor_defaults_to_the_card_and_raises_without_one(tmp_path):
    _no_card()
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4])
        y = fluid.layers.fc(input=x, size=3)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        fluid.io.save_inference_model(str(tmp_path), ['x'], [y], exe,
                                      main_program=main, scope=scope)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.Predictor(str(tmp_path))
    got = inference.Predictor(str(tmp_path), place=fluid.CPUPlace()).run(
        {'x': np.ones((2, 4), 'float32')})[0]
    assert got.shape == (2, 3)


def test_load_compiled_defaults_to_the_card_and_raises_without_one(
        tmp_path):
    _no_card()
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4])
        y = fluid.layers.fc(input=x, size=3)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        inference.export_compiled(str(tmp_path), {
            'x': np.ones((2, 4), 'float32')}, [y], exe, main_program=main,
            scope=scope)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.load_compiled(str(tmp_path))
    got = inference.load_compiled(str(tmp_path), place=fluid.CPUPlace())(
        {'x': np.ones((2, 4), 'float32')})[0]
    assert got.shape == (2, 3)


def test_decode_engine_defaults_to_the_card_and_raises_without_one():
    _no_card()
    from paddle_tpu_torch import serving
    r = np.random.RandomState(0)
    weights = {k: r.randn(*shape).astype('float32') for k, shape in (
        ('w_dec', (10, 16)), ('u_dec', (4, 16)), ('b_dec', (1, 16)),
        ('w_q', (4, 6)), ('w_emb', (9, 4)), ('w_out', (4, 9)),
        ('b_out', (1, 9)))}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serving.DecodeEngine(weights)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serving.DecodeEngine(weights, serving.DecodeConfig(
            page_size=4, pages=8))
    eng = serving.DecodeEngine(weights, serving.DecodeConfig(
        slots=2, max_len=4, src_cap=3, page_size=2, pages=4),
        place=fluid.CPUPlace())
    try:
        eng.warmup()
        ids, scores = eng.predict({'enc': r.randn(2, 6)}, timeout=60)
        assert ids.shape == (3, 4) and scores.shape == (3,)
    finally:
        eng.shutdown()


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path,
                                                              where):
    _no_card()
    script = os.path.join(REPO, 'chip_smoke.py')
    if where == 'alone':
        shutil.copy(script, str(tmp_path))
        cwd, script = str(tmp_path), os.path.join(str(tmp_path),
                                                  'chip_smoke.py')
    else:
        cwd = REPO
    out = subprocess.run([sys.executable, script], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# Names the JAX module exports and the port's does not yet, each held by a
# ROADMAP.md queue item (its title) or a recorded departure.
_PARALLEL = 'Parallel'
_TOOLING = 'Analysis and tooling'
_SERVING = 'Serving, the rest'
_NO_SWITCH = 'Known departures: no kernel switch'
_TRANSPILERS = ['PipelineTranspiler', 'SequenceParallelTranspiler',
                'TensorParallelTranspiler']
_HELD = {
    'embedding': {n: _PARALLEL for n in (
        'sharded_lookup', 'pad_vocab', 'wire_stats', 'table_attr',
        'gather_table')},
    'embedding.lookup': {n: _PARALLEL for n in (
        'sharded_lookup', 'pad_vocab', 'wire_stats')},
    'fluid': dict({n: _PARALLEL for n in ['device_guard'] + _TRANSPILERS},
                  profiler=_TOOLING),
    'fluid.analysis': {n: _TOOLING for n in (
        'analyze', 'maybe_verify', 'report_findings', 'verify_mode',
        'executor_donates', 'persistable_write_set', 'register_infer',
        'ENV_VERIFY', 'CostReport', 'cost_report', 'collective_sequence')},
    'fluid.contrib': {'memory_usage_calc': _TOOLING,
                      'memory_usage': _TOOLING},
    'fluid.framework': {'device_guard': _PARALLEL,
                        'strict_infer_shape': _TOOLING},
    'fluid.step_artifact': {n: _SERVING for n in (
        'aot_manifest', 'write_aot', 'read_aot', 'aot_check',
        'AOT_MANIFEST', 'AOT_CACHE_DIR')},
    'fluid.transpiler': {n: _PARALLEL for n in _TRANSPILERS},
    'ops': {'reference_attention': _NO_SWITCH},
    # tensor, sequence and pipeline parallelism and the host heartbeat:
    # the later parts of "Parallel"
    'parallel': {n: _PARALLEL for n in (
        'annotate_tp', 'auto_tp_rules', 'ring_attention',
        'ring_self_attention', 'ulysses_attention', 'ulysses_self_attention',
        'pipeline_apply', 'pipeline_manual_axes', 'stack_stage_params',
        'Heartbeat', 'HostLost')},
    'ops.kernels': {n: _NO_SWITCH for n in (
        'register_kernel', 'available', 'enabled', 'configure', 'signature',
        'note_dispatch', 'interpret_default', 'ENV_KERNELS',
        'paged_attention_reference')},
    'serving': {n: _SERVING for n in (
        'transport', 'Channel', 'RpcServer', 'TransportError', 'PodRouter',
        'PodWorker', 'RemoteReplica', 'RpcReplica', 'ShardedPredictor',
        'sharded_replica', 'save_serving_program', 'AutoscalePolicy',
        'Autoscaler')},
}
# listed in the JAX fluid.__all__ but not defined on the JAX fluid module
# (the port defines Block, grad_var_name, FetchHandle and
# normalize_sharding there)
_UNDEFINED_IN_JAX = {'fluid': [
    'Block', 'grad_var_name', 'strict_infer_shape', 'normalize_sharding',
    'FetchHandle', 'HashName', 'RoundRobin', 'learning_rate_decay']}


def _module_names(pkg_dir):
    out = set()
    for root, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith('.py'):
                rel = os.path.relpath(os.path.join(root, f), pkg_dir)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == '__init__':
                    parts = parts[:-1]
                out.add('.'.join(parts))
    return out


def test_every_shared_module_exports_the_jax_names():
    """The port's __all__ holds the JAX __all__ of every module both
    packages have, less _HELD; every held name is really missing (so the
    list shrinks as the port grows), and every queue title it names
    stands in ROADMAP.md."""
    import paddle_tpu
    jax_dir = os.path.dirname(os.path.abspath(paddle_tpu.__file__))
    shared = sorted(_module_names(jax_dir) & _module_names(PORT_DIR))
    assert len(shared) > 100 and '' in shared and 'fluid.initializer' in shared
    missing, undefined, phantom = {}, {}, []
    for m in shared:
        jm = importlib.import_module('paddle_tpu' + ('.' + m if m else ''))
        tm = importlib.import_module('paddle_tpu_torch' + ('.' + m if m
                                                            else ''))
        jall = getattr(jm, '__all__', None)
        if jall is None:
            continue
        tall = set(getattr(tm, '__all__', None) or ())
        for n in jall:
            if not hasattr(jm, n):
                undefined.setdefault(m or '<root>', []).append(n)
                continue
            if n not in tall:
                missing.setdefault(m, {})[n] = None
        phantom.extend('%s.%s' % (m, n) for n in sorted(tall)
                       if not hasattr(tm, n))
    assert not phantom, 'in the port\'s __all__ but undefined: %r' % phantom
    assert undefined == _UNDEFINED_IN_JAX
    unheld = {m: sorted(n for n in ns if n not in _HELD.get(m, {}))
              for m, ns in missing.items()}
    unheld = {m: ns for m, ns in unheld.items() if ns}
    assert not unheld, unheld
    stale = {m: sorted(n for n in ns if n not in missing.get(m, {}))
             for m, ns in _HELD.items()}
    stale = {m: ns for m, ns in stale.items() if ns}
    assert not stale, stale
    with open(os.path.join(REPO, 'ROADMAP.md')) as fh:
        roadmap = fh.read()
    for title in {t for ns in _HELD.values() for t in ns.values()}:
        assert title.split(': ')[-1] in roadmap, title
