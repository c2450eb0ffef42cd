"""Model persistence. Parity: reference python/paddle/fluid/io.py and the JAX
package's fluid/io.py:38-161, in the SAME formats: programs serialize to
`__model__.json` (framework.Program._to_dict) and persistables to one
`__params__.npz` of numpy arrays. An artifact saved by either package
loads in the other; this is how weights carry across between them.

The failure-recovery checkpoints (save_checkpoint, list_checkpoint_serials,
load_checkpoint; the JAX :164-268) keep the JAX on-disk format byte for
byte: `checkpoint_<n>/__params__.npz` and a `meta.json` written last and
atomically, recording the params file's size and CRC32. A serial either
package writes resumes in the other. The JAX package's sharded format
(utils/checkpoint.py) waits for the parallel slice.
"""
import json
import os
import re
import shutil
import zlib

import numpy as np
import torch

from .. import obs
from .framework import Program, Parameter, Variable, default_main_program
from .executor import global_scope, numpy_of, tensor_of_numpy
from .lowering import data_of

__all__ = [
    'save_vars', 'save_params', 'save_persistables', 'load_vars',
    'load_params', 'load_persistables', 'save_inference_model',
    'load_inference_model', 'save_checkpoint', 'load_checkpoint',
    'list_checkpoint_serials',
]

_PARAMS_FILE = '__params__.npz'
_PROGRAM_FILE = '__model__.json'


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return var.persistable


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """reference io.py:save_vars: the named scope tensors, as numpy arrays,
    into one .npz file (a bf16 tensor widened to float32, exactly; a
    sequence value's padded data)."""
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    if scope is None:
        scope = global_scope()
    arrays = {}
    for var in vars:
        name = var.name if isinstance(var, Variable) else str(var)
        v = scope._chain_get(name)
        if v is None:
            raise RuntimeError("variable %s is not initialized in scope" % name)
        # a LoD (SeqValue) value saves its padded data, as the JAX
        # save_vars (:61-64) does
        arrays[name] = numpy_of(data_of(v).detach().cpu())
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    np.savez(path, **arrays)
    if not path.endswith('.npz'):
        os.replace(path + '.npz', path)
    return path


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, None, is_parameter,
                     filename)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program, None, is_persistable,
                     filename, scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """reference io.py:load_vars: each named array of the .npz goes into
    `scope` (default: the global scope) as a tensor on the executor's
    device; a var declared bfloat16 (a Float16Transpiler's program) is
    rounded back to bf16, which undoes save_vars' widening exactly."""
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    if scope is None:
        scope = global_scope()
    with np.load(path) as data:
        for var in vars:
            name = var.name if isinstance(var, Variable) else str(var)
            if name not in data:
                raise RuntimeError("variable %s not found in %s"
                                   % (name, path))
            t = tensor_of_numpy(data[name])
            if isinstance(var, Variable) and var.dtype == 'bfloat16':
                t = t.to(torch.bfloat16)
            scope.vars[name] = t.to(executor.device)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program, None, is_parameter, filename,
              scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    load_vars(executor, dirname, main_program, None, is_persistable, filename,
              scope=scope)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, scope=None):
    """reference io.py:save_inference_model: prune to the inference graph
    and save program + persistables."""
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    if main_program is None:
        main_program = default_main_program()
    os.makedirs(dirname, exist_ok=True)
    inference_program = main_program.clone(for_test=True).prune(target_vars)
    meta = {
        'program': inference_program._to_dict(),
        'feed_names': list(feeded_var_names),
        'fetch_names': [v.name if isinstance(v, Variable) else str(v)
                        for v in target_vars],
    }
    with open(os.path.join(dirname, model_filename or _PROGRAM_FILE), 'w') as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, inference_program, params_filename,
                      scope=scope)


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """reference io.py:load_inference_model -> (program, feed_names,
    fetch_vars). `scope` None loads into the global scope; Predictor
    passes its private scope."""
    with open(os.path.join(dirname, model_filename or _PROGRAM_FILE)) as f:
        meta = json.load(f)
    program = Program._from_dict(meta['program'])
    load_persistables(executor, dirname, program, params_filename,
                      scope=scope)
    fetch_vars = [program.global_block()._var_recursive(n)
                  for n in meta['fetch_names']]
    return [program, meta['feed_names'], fetch_vars]


def _crc32_file(path, chunk=1 << 20):
    """CRC32 of a file's bytes, streamed (the JAX utils/checkpoint.py:54)."""
    crc = 0
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(chunk), b''):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def save_checkpoint(executor, checkpoint_dir, trainer_id=0, main_program=None,
                    step=0, max_num_checkpoints=3, trainer_args=None,
                    scope=None):
    """Failure-recovery checkpoint: persistables + step counter + optional
    trainer args like {'epoch_id', 'step_id'} (reference io.py checkpoint
    utilities / trainer.py:641 save_checkpoint; the JAX :164). On the card
    each value is read after every step launched before it has written it
    (save_vars' copy to the host waits on the stream the steps run on).
    Returns the serial's directory."""
    serial_dir = os.path.join(checkpoint_dir, 'checkpoint_%d' % step)
    with obs.span('checkpoint.save', serial=step):
        params_path = save_persistables(executor, serial_dir, main_program,
                                        scope=scope)
    # meta written atomically and LAST: its presence marks a complete
    # snapshot (reference writes a _SUCCESS marker, trainer.py:1190). It
    # records the params file's size AND content CRC32, so load_checkpoint
    # can tell a torn/bit-rotted snapshot from an intact one and the
    # Trainer can fall back to the previous serial instead of silently
    # resuming from corrupted weights.
    tmp = os.path.join(serial_dir, 'meta.json.tmp')
    with open(tmp, 'w') as f:
        json.dump({'step': step, 'trainer_id': trainer_id,
                   'trainer_args': trainer_args or {},
                   'params_file': os.path.basename(params_path),
                   'params_bytes': os.path.getsize(params_path),
                   'params_crc32': _crc32_file(params_path)}, f)
    os.replace(tmp, os.path.join(serial_dir, 'meta.json'))
    for s in list_checkpoint_serials(checkpoint_dir)[:-max_num_checkpoints]:
        shutil.rmtree(os.path.join(checkpoint_dir, 'checkpoint_%d' % s),
                      ignore_errors=True)
    return serial_dir


def list_checkpoint_serials(checkpoint_dir):
    """Sorted serial numbers of checkpoint_<n> subdirs (may be torn)."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for d in os.listdir(checkpoint_dir):
        m = re.fullmatch(r'checkpoint_(\d+)', d)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _verify_params(serial, serial_dir, meta):
    """The integrity gate of a serial's params file: present, of the size
    and CRC32 its meta recorded; raises RuntimeError naming what differs."""
    with obs.span('checkpoint.verify', serial=serial):
        params_path = os.path.join(
            serial_dir, meta.get('params_file') or _PARAMS_FILE)
        problem = None
        if not os.path.exists(params_path):
            problem = ('checkpoint serial %d: params file %r is missing'
                       % (serial, params_path))
        elif meta.get('params_bytes') is not None \
                and os.path.getsize(params_path) != meta['params_bytes']:
            problem = ('checkpoint serial %d is corrupt: params file %r '
                       'holds %d bytes, meta recorded %d (truncated write?)'
                       % (serial, params_path, os.path.getsize(params_path),
                          meta['params_bytes']))
        else:
            got = _crc32_file(params_path)
            if got != meta['params_crc32']:
                problem = ('checkpoint serial %d is corrupt: params CRC32 '
                           '%08x does not match the meta record %08x'
                           % (serial, got, meta['params_crc32']))
        obs.counter('checkpoint.crc_verify',
                    outcome='fail' if problem else 'ok').inc()
        if problem:
            raise RuntimeError(problem)


def load_checkpoint(executor, checkpoint_dir, serial=None, main_program=None,
                    scope=None):
    """Load serial `serial` (default: the newest) into `scope` (default:
    the global scope) and return its meta. The params file is verified
    against the meta's size and CRC32 BEFORE any value reaches the scope: a
    truncated or bit-rotted file raises RuntimeError (the Trainer's resume
    falls back to the previous serial, loudly). Loaded values rebind the
    scope; a step captured over it copies them into its static state
    before its next replay."""
    if serial is None:
        cands = list_checkpoint_serials(checkpoint_dir)
        if not cands:
            raise RuntimeError("no checkpoints in %s" % checkpoint_dir)
        serial = cands[-1]
    serial_dir = os.path.join(checkpoint_dir, 'checkpoint_%d' % serial)
    with open(os.path.join(serial_dir, 'meta.json')) as f:
        meta = json.load(f)
    if meta.get('params_crc32') is not None:
        _verify_params(serial, serial_dir, meta)
    load_persistables(executor, serial_dir, main_program, scope=scope)
    return meta
