"""IO layers: `data` and the reader layers.

Parity: reference layers/io.py and the JAX package's fluid/layers/io.py
(:33-304). The reference's C++ reader-op chain (open_files ->
double_buffer -> read) is a host-side python reader here, bound to feed
variables: a reader layer returns a _PyReader whose generator the next
layer wraps. Record files are scanned by the native library
(reader/recordio.py); double_buffer given a CUDAPlace stages each item into
pinned host memory on its prefetch thread, as Trainer(double_buffer=True)
does through Executor._place_feed.

Departure from the JAX package: open_recordio_file and open_files read a
file of fluid.recordio_writer back as its feed slots (each record one
batch; a LoD slot as a LoDTensor), as the reference Paddle does. The JAX
layers hand the writer's schema header to the user as slot 0
(ROADMAP.md, known departures).
"""
import contextlib

import numpy as np
import torch

from ..layer_helper import LayerHelper
from ..core import convert_dtype

__all__ = ['data', 'open_recordio_file', 'open_files', 'read_file',
           'shuffle', 'batch', 'double_buffer', 'random_data_generator',
           'py_reader', 'Preprocessor', 'load']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=None, stop_gradient=True):
    """reference layers/io.py:data."""
    helper = LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level and lod_level > 0:
        # padded layout: sequences are dense [batch, time, ...], so the
        # declared fluid shape gains a dynamic time axis
        shape = [shape[0], -1] + shape[1:]
    return helper.create_global_variable(
        name=name, shape=shape, dtype=convert_dtype(dtype),
        lod_level=lod_level, stop_gradient=stop_gradient, is_data=True)


class _PyReader(object):
    """Host-side python reader bound to feed targets: `_gen` makes the
    stream, and each reader layer wraps it."""

    def __init__(self, feed_list=None, capacity=64, shapes=None, dtypes=None,
                 lod_levels=None, name=None):
        self.feed_list = feed_list
        self.capacity = capacity
        self.shapes = shapes
        self.dtypes = dtypes
        self.lod_levels = lod_levels
        self._gen = None
        self._iter = None
        self._vars = None
        if shapes is not None:
            self._vars = []
            for i, (s, d) in enumerate(zip(shapes, dtypes)):
                lod = (lod_levels or [0] * len(shapes))[i]
                self._vars.append(data(
                    name='%s_slot_%d' % (name or 'py_reader', i),
                    shape=list(s)[1:], dtype=d, lod_level=lod))

    def decorate_paddle_reader(self, reader):
        self._gen = reader

    decorate_tensor_provider = decorate_paddle_reader
    decorate_batch_generator = decorate_paddle_reader
    decorate_sample_list_generator = decorate_paddle_reader

    def start(self):
        self._iter = self._gen()

    def reset(self):
        self._iter = None

    def next(self):
        return next(self._iter)

    def __call__(self):
        return self._gen()


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """reference layers/io.py:py_reader."""
    return _PyReader(capacity=capacity, shapes=shapes, dtypes=dtypes,
                     lod_levels=lod_levels, name=name)


def read_file(reader):
    if isinstance(reader, _PyReader) and reader._vars is not None:
        return reader._vars
    raise TypeError("read_file expects a py_reader with declared shapes")


def _file_records(filename, lod_levels):
    """One file's records: a record of fluid.recordio_writer as its feed
    slots, a record of reader.recordio.write_samples as its arrays."""
    from ...reader import recordio as rio
    from ..recordio_writer import feed_record_levels, unpack_feed_slots
    for arrays in rio.read_samples(filename):
        if feed_record_levels(arrays, lod_levels):
            yield tuple(unpack_feed_slots(arrays))
        else:
            yield arrays


def _files_reader(filenames, shapes, lod_levels, dtypes, pass_num):
    lod_levels = list(lod_levels or [0] * len(shapes))

    def gen():
        for _ in range(pass_num):
            for fn in filenames:
                yield from _file_records(fn, lod_levels)

    r = _PyReader(shapes=shapes, dtypes=dtypes, lod_levels=lod_levels)
    r.decorate_paddle_reader(gen)
    return r


def open_recordio_file(filename, shapes, lod_levels, dtypes,
                       pass_num=1, for_parallel=True):
    """Record file reader (reference layers/io.py:open_recordio_file),
    scanned by the native library."""
    return _files_reader([filename], shapes, lod_levels, dtypes, pass_num)


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1,
               buffer_size=None, pass_num=1, for_parallel=True):
    """Several record files read in turn (reference layers/io.py:
    open_files; one reading thread, the native prefetch thread a file)."""
    return _files_reader(list(filenames), shapes, lod_levels, dtypes,
                         pass_num)


def shuffle(reader, buffer_size):
    from ... import reader as reader_mod
    if isinstance(reader, _PyReader):
        reader._gen = reader_mod.shuffle(reader._gen, buffer_size)
        return reader
    return reader_mod.shuffle(reader, buffer_size)


def batch(reader, batch_size):
    from ...batch import batch as _batch
    if isinstance(reader, _PyReader):
        reader._gen = _batch(reader._gen, batch_size)
        return reader
    return _batch(reader, batch_size)


def _pinned_tensor(a):
    """A copy of ndarray `a` in pinned host memory."""
    a = np.asarray(a)
    t = torch.empty(a.shape, dtype=torch.from_numpy(
        np.empty(0, a.dtype)).dtype, pin_memory=True)
    np.copyto(t.numpy(), a)
    return t


def _staged(item):
    """`item` with every array in pinned host memory, its structure kept:
    an ndarray pinned; a LoDTensor as the padded SeqValue the Executor
    makes of it (data_feeder.seq_pad's bucket), its leaves pinned; tuples
    and lists entry by entry; anything else as it is."""
    from ..data_feeder import seq_pad
    from ..lod_tensor import LoDTensor
    from ..lowering import map_value
    if isinstance(item, np.ndarray):
        return _pinned_tensor(item)
    if isinstance(item, LoDTensor):
        lens = item.recursive_sequence_lengths()
        if not lens:
            return _pinned_tensor(item.data)
        return map_value(torch.Tensor.pin_memory,
                         item.to_seq_value(pad_to=seq_pad(lens)))
    if isinstance(item, (tuple, list)):
        return type(item)(_staged(x) for x in item)
    return item


def double_buffer(reader, place=None, name=None):
    """A depth-2 background prefetch of the reader (reference layers/io.py:
    double_buffer). Given a CUDAPlace, the prefetch thread also stages
    each item into pinned host memory (_staged), so the step's copy to the
    card reads pinned memory and the host copy overlaps the step before."""
    from ...reader.pipeline import prefetch
    transform = None
    if place is not None and place.torch_device().type == 'cuda':
        transform = _staged
    if isinstance(reader, _PyReader):
        reader._gen = prefetch(reader._gen, depth=2, transform=transform)
        return reader
    return prefetch(reader, depth=2, transform=transform)


def random_data_generator(low, high, shapes, lod_levels, for_parallel=True):
    """An endless reader of float32 uniform draws in [low, high) from
    numpy's global generator, one array a shape."""

    def gen():
        while True:
            yield tuple(
                np.random.uniform(low, high, size=s).astype('float32')
                for s in shapes)

    r = _PyReader(shapes=shapes,
                  dtypes=['float32'] * len(shapes),
                  lod_levels=lod_levels)
    r.decorate_paddle_reader(gen)
    return r


class Preprocessor(object):
    """reference layers/io.py:Preprocessor — a reader-to-reader transform
    written with graph ops.

    The ops appended inside `block()` are taken out of the main program and
    run on each item of the wrapped reader through the port's lowering
    rules, on `place`'s device (the card unless asked for the CPU): the
    same op set that would run in a step transforms the stream. The
    wrapped reader yields the outputs as ndarrays (bf16 widened to float32,
    as Scope.to_numpy gives it). Random ops draw from a torch.Generator
    seeded by the instance and the epoch (each call of the reader), so a
    stream is the same from run to run. Parameters the block reads (a
    mean, say) stay in the programs and are read from the global scope."""

    _instance_counter = 0

    def __init__(self, reader, name=None, place=None):
        from ..core import CUDAPlace
        self.reader = reader
        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        self.sub_program = None
        self._inputs = None
        self._outputs = None

    def block(self):
        @contextlib.contextmanager
        def _blk():
            from ..framework import (default_main_program,
                                     default_startup_program)
            blk = default_main_program().global_block()
            sblk = default_startup_program().global_block()
            start = len(blk.ops)
            s_start = len(sblk.ops)
            pre_vars = set(blk.vars)
            pre_svars = set(sblk.vars)
            try:
                yield self
            except BaseException:
                # failed block: remove everything it created — main ops,
                # main vars, and any startup initializers/params
                del blk.ops[start:]
                for n in [n for n in blk.vars if n not in pre_vars]:
                    del blk.vars[n]
                del sblk.ops[s_start:]
                for n in [n for n in sblk.vars if n not in pre_svars]:
                    del sblk.vars[n]
                raise
            self._captured_ops = list(blk.ops[start:])
            # the transform's ops never stay in the main program; the temp
            # vars they made go too. Parameters (and their startup
            # initializers) stay: the stream reads their scope values,
            # which the startup program fills.
            del blk.ops[start:]
            for n in [n for n in blk.vars if n not in pre_vars
                      and not getattr(blk.vars[n], 'persistable', False)]:
                del blk.vars[n]
            self._install()
        return _blk()

    def inputs(self):
        self._inputs = read_file(self.reader)
        return self._inputs

    def outputs(self, *outs):
        self._outputs = outs

    def _install(self):
        if self._inputs is None:
            raise ValueError('Preprocessor.block must call inputs()')
        if not self._outputs:
            raise ValueError('Preprocessor.block must call outputs(...)')
        from .. import lowering
        from ..executor import global_scope, numpy_of, tensor_of_numpy
        from ..lowering import Ctx

        in_names = [v.name for v in self._inputs]
        out_names = [v.name for v in self._outputs]
        ops = self._captured_ops
        inner = self.reader._gen
        device = self.device

        # names read by the block but produced neither by the reader nor
        # by an earlier block op: parameters / pre-existing vars, resolved
        # from the scope at stream time
        produced = set(in_names)
        external, seen_ext = [], set()
        for op in ops:
            for vs in op.inputs.values():
                for v in vs:
                    if v.name not in produced and v.name not in seen_ext:
                        external.append((op.type, v.name))
                        seen_ext.add(v.name)
            for vs in op.outputs.values():
                for v in vs:
                    produced.add(v.name)

        in_ranks = [len(v.shape) for v in self._inputs]
        inst = Preprocessor._instance_counter
        Preprocessor._instance_counter += 1
        epoch = [0]

        def gen():
            # a stream of its own per epoch (each reader() call) and per
            # Preprocessor instance, the same from run to run
            g = torch.Generator(device=device)
            g.manual_seed((inst * 1000003 + epoch[0]) % (1 << 63))
            epoch[0] += 1
            ctx = Ctx(device, generator=g, is_test=False)
            for sample in inner():
                env = {}
                for n, s, rank in zip(in_names, sample, in_ranks):
                    a = np.asarray(s)
                    if a.ndim == rank - 1:
                        a = a[None]  # per-sample slot: add the batch axis
                    env[n] = tensor_of_numpy(a).to(device)
                for op_type, name in external:
                    val = global_scope()._chain_get(name)
                    if val is None:
                        raise NameError(
                            'Preprocessor op %r reads %r, which is neither '
                            'a reader slot, a block-produced var, nor in '
                            'the scope (run the startup program first?)'
                            % (op_type, name))
                    env[name] = val.to(device)
                for op in ops:
                    lowering.run_op(op, env, ctx)
                yield tuple(numpy_of(env[n].detach().cpu())
                            for n in out_names)

        self.reader._gen = gen


def _scope_device(scope, name):
    """Where `name` lives in `scope`, else where the scope's first tensor
    lives, else the CPU."""
    v = scope._chain_get(name)
    if isinstance(v, torch.Tensor):
        return v.device
    for v in scope.vars.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device('cpu')


def load(out, file_path, load_as_fp16=None):
    """Load one tensor from a .npy file into `out`'s name in the global
    scope, on the scope's device (reference layers/io.py:load). As in the
    JAX package, load_as_fp16 is accepted and the file's dtype kept."""
    from ..executor import global_scope, tensor_of_numpy
    path = file_path if file_path.endswith('.npy') else file_path + '.npy'
    scope = global_scope()
    scope.vars[out.name] = tensor_of_numpy(np.load(path)).to(
        _scope_device(scope, out.name))
    return out
