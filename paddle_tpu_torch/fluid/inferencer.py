"""High-level Inferencer API. Parity: reference python/paddle/fluid/
inferencer.py:31 and the JAX package's fluid/inferencer.py — builds the
inference program from infer_func, loads params saved by
Trainer.save_params, and runs feeds through the Executor (on the card, one
captured step per feed signature).

There is ONE inference execution path: the Executor with this
Inferencer's private scope passed explicitly (the same contract as
paddle_tpu_torch.inference.Predictor — no global scope_guard on the run
path, so inferencers are thread-safe). The reference's `parallel=True`
ParallelExecutor branch is retired, as in the JAX package: batched and
concurrent serving belongs to paddle_tpu_torch.serving.
"""
import warnings

from . import framework
from . import io
from . import unique_name
from .executor import Executor, Scope
from .trainer import check_and_get_place

__all__ = ['Inferencer']


class Inferencer(object):
    """reference inferencer.py:31. place None means the card, and raises
    without one (trainer.check_and_get_place)."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        if parallel:
            warnings.warn(
                'Inferencer(parallel=True) is deprecated and ignored: '
                'inference runs through the single Executor path; for '
                'high-throughput concurrent inference use '
                'paddle_tpu_torch.serving.ServingEngine',
                DeprecationWarning, stacklevel=2)
        self.param_path = param_path
        self.scope = Scope()
        self.place = check_and_get_place(place)

        self.inference_program = framework.Program()
        with framework.program_guard(self.inference_program):
            with unique_name.guard():
                self.predict_var = infer_func()

        self.exe = Executor(self.place)
        io.load_params(self.exe, param_path,
                       main_program=self.inference_program, scope=self.scope)

        self.inference_program = self.inference_program.clone(for_test=True)

    def infer(self, inputs, return_numpy=True):
        """reference inferencer.py:79."""
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        return self.exe.run(self.inference_program, feed=inputs,
                            fetch_list=[self.predict_var],
                            return_numpy=return_numpy, scope=self.scope)
