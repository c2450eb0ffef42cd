"""Inference runtime: load a saved inference model and run it.

Parity: reference paddle/fluid/inference and the JAX package's
paddle_tpu.inference.Predictor (:26-100). The compiled-artifact path of the
JAX package (export_compiled / load_compiled) waits for a later slice.
"""
from ..fluid import core, io
from ..fluid.executor import Executor, Scope

__all__ = ['Predictor']


class Predictor(object):
    """Load + run a saved inference model (reference: NativePaddlePredictor,
    inference/api/api_impl.cc).

    place None means CUDAPlace(0): without a card the constructor raises;
    pass CPUPlace() to run on the CPU. Thread-safe: the model's variables
    live in a PRIVATE scope passed explicitly to Executor.run, never
    through the process-global scope; the serving engine relies on it."""

    def __init__(self, dirname, place=None):
        self._place = core.CUDAPlace(0) if place is None else place
        self._exe = Executor(self._place)
        self._scope = Scope()
        prog, feeds, fetches = io.load_inference_model(dirname, self._exe,
                                                       scope=self._scope)
        self._program = prog
        self.feed_names = feeds
        self._fetch_vars = fetches

    @property
    def fetch_names(self):
        return [v.name for v in self._fetch_vars]

    @property
    def input_spec(self):
        """{feed name: (shape, dtype str)} from the loaded program; the
        leading batch dim is -1 (any). The serving engine's warmup uses
        this to build per-bucket feeds without an example."""
        blk = self._program.global_block()
        spec = {}
        for n in self.feed_names:
            v = blk.vars.get(n)
            if v is not None:
                spec[n] = (tuple(int(d) for d in v.shape), str(v.dtype))
        return spec

    def run(self, feed):
        """feed: dict name -> ndarray, or LoDTensor / SeqValue for a
        sequence input (a padded ndarray of a sequence input reads as all
        rows full length). Returns the list of fetched ndarrays (a
        sequence fetch as its flat valid rows). On the card each feed signature (batch size) is warmed
        up on its first call and captured into a CUDA graph on its
        second; later calls replay it, and the fetches come back through
        pinned host buffers."""
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)
