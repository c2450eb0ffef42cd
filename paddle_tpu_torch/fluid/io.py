"""Model persistence. Parity: reference python/paddle/fluid/io.py and the JAX
package's fluid/io.py:38-161, in the SAME formats: programs serialize to
`__model__.json` (framework.Program._to_dict) and persistables to one
`__params__.npz` of numpy arrays. An artifact saved by either package
loads in the other; this is how weights carry across between them.

Checkpoint helpers (save_checkpoint/load_checkpoint) wait for the training
slice.
"""
import json
import os

import numpy as np
import torch

from .framework import Program, Parameter, Variable, default_main_program
from .executor import global_scope, numpy_of, tensor_of_numpy
from .lowering import data_of

__all__ = [
    'save_vars', 'save_params', 'save_persistables', 'load_vars',
    'load_params', 'load_persistables', 'save_inference_model',
    'load_inference_model',
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
