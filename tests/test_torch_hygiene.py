"""Boundaries of the PyTorch port (paddle_tpu_torch):

  * it imports neither jax nor the JAX package (checked in a fresh
    interpreter, and on every source line);
  * its entry points run on the card unless asked for the CPU: with no
    card, Executor() and Predictor(dirname) raise instead of running on
    the CPU;
  * chip_smoke.py refuses to run, and prints no result, without a card or
    outside a checkout.
"""
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
