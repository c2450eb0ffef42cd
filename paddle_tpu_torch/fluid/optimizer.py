"""Optimizers: append per-param update ops after backward.

Parity: reference python/paddle/fluid/optimizer.py and the JAX package's
fluid/optimizer.py (Optimizer :28, SGD, Momentum, Adagrad, Adam, Adamax
:277, DecayedAdagrad :324, Adadelta :351, RMSProp :385, Ftrl :420, the
aliases :455-463, ModelAverage :466). The update ops run eagerly after the
autodiff marker (executor.py); their rules are ops_impl/optim_ops.py.

LARS_weight_decay is kept on the optimizer and, as in the JAX package,
not applied by minimize (the reference calls layers.append_LARS in its
create_optimization_pass); layers.append_LARS builds the per-parameter
rates for a caller that wants them (ROADMAP.md Queue C).
"""
import contextlib
from collections import defaultdict

import torch

from . import unique_name
from .framework import Variable, default_main_program, program_guard, \
    ROLE_OPTIMIZE
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .layers import tensor as tensor_layers

__all__ = [
    'SGD', 'Momentum', 'Adagrad', 'Adam', 'Adamax', 'DecayedAdagrad', 'Ftrl',
    'SGDOptimizer', 'MomentumOptimizer', 'AdagradOptimizer', 'AdamOptimizer',
    'AdamaxOptimizer', 'DecayedAdagradOptimizer', 'RMSPropOptimizer',
    'FtrlOptimizer', 'Adadelta', 'AdadeltaOptimizer', 'RMSProp',
    'ModelAverage', 'Optimizer',
]


class Optimizer(object):
    """Base optimizer (reference optimizer.py:Optimizer)."""

    def __init__(self, learning_rate, regularization=None,
                 LARS_weight_decay=0.0):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = dict()
        self._accumulators = defaultdict(lambda: dict())
        self.helper = None
        self._LARS_weight_decay = LARS_weight_decay

    def _create_global_learning_rate(self):
        if isinstance(self._global_learning_rate(), Variable):
            return
        if isinstance(self._learning_rate, Variable):
            # scheduled lr (a Variable computed by lr_scheduler ops)
            self._learning_rate_map[default_main_program()] = \
                self._learning_rate
            return
        self._learning_rate_map[default_main_program()] = \
            tensor_layers.create_global_var(
                name=unique_name.generate("learning_rate"),
                shape=[1], value=float(self._learning_rate),
                dtype='float32', persistable=True)

    def _global_learning_rate(self, program=None):
        if program is None:
            program = default_main_program()
        return self._learning_rate_map.get(program, None)

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError()

    def _create_param_lr(self, param_and_grad):
        param_lr = param_and_grad[0].optimize_attr['learning_rate']
        if param_lr == 1.0:
            return self._global_learning_rate()
        from .layers import ops as ops_layers
        return ops_layers.scale(self._global_learning_rate(),
                                scale=float(param_lr))

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            raise Exception("Accumulator %s already exists for %s" %
                            (name, param.name))
        if shape is None:
            shape = list(param.shape)
        var = self.helper.create_global_variable(
            name=unique_name.generate(name + "_" + param.name),
            persistable=True, dtype=dtype or param.dtype, shape=shape)
        var._is_optimizer_accumulator = True
        self._accumulators[name][param.name] = var
        self.helper.set_variable_initializer(
            var, initializer=Constant(value=float(fill_value)))
        return var

    def _get_accumulator(self, name, param):
        if name not in self._accumulators or \
                param.name not in self._accumulators[name]:
            raise Exception("Accumulator %s does not exist for %s" %
                            (name, param.name))
        return self._accumulators[name][param.name]

    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        """reference optimizer.py:create_optimization_pass."""
        program = loss.block.program
        with program_guard(program, startup_program):
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_accumulators(
                loss.block,
                [p[0] for p in parameters_and_grads if p[0].trainable])
            self._create_global_learning_rate()

            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if param_and_grad[0].trainable:
                    op = self._append_optimize_op(loss.block, param_and_grad)
                    op.attrs['op_role'] = ROLE_OPTIMIZE
                    optimize_ops.append(op)
            self._finish_update(loss.block)
            return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """reference optimizer.py:Optimizer.minimize."""
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super(SGDOptimizer, self).__init__(learning_rate=learning_rate,
                                           **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate=learning_rate,
                                                **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str,
                                             param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Velocity": velocity_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "VelocityOut": velocity_acc},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1.0e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate=learning_rate,
                                               **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment_acc},
            attrs={"epsilon": self._epsilon}, infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate=learning_rate,
                                            **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name.generate('beta1_pow_acc'), dtype='float32',
            shape=[1], persistable=True)
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, initializer=Constant(self._beta1))
        self._beta2_pow_acc = self.helper.create_global_variable(
            name=unique_name.generate('beta2_pow_acc'), dtype='float32',
            shape=[1], persistable=True)
        self.helper.set_variable_initializer(
            self._beta2_pow_acc, initializer=Constant(self._beta2))
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment1 = self._get_accumulator(self._moment1_acc_str,
                                        param_and_grad[0])
        moment2 = self._get_accumulator(self._moment2_acc_str,
                                        param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment1": moment1, "Moment2": moment2,
                    "Beta1Pow": self._beta1_pow_acc,
                    "Beta2Pow": self._beta2_pow_acc},
            outputs={"ParamOut": param_and_grad[0], "Moment1Out": moment1,
                     "Moment2Out": moment2},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)

    def _finish_update(self, block):
        """Update beta1^t / beta2^t once per step (reference appends scale
        ops in a with-block)."""
        block.append_op(
            type="adam_beta_pow_update",
            inputs={"Beta1Pow": self._beta1_pow_acc,
                    "Beta2Pow": self._beta2_pow_acc},
            outputs={"Beta1PowOut": self._beta1_pow_acc,
                     "Beta2PowOut": self._beta2_pow_acc},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "op_role": ROLE_OPTIMIZE},
            infer_shape=False)


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate=learning_rate,
                                              **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name.generate('beta1_pow_acc'), dtype='float32',
            shape=[1], persistable=True)
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, initializer=Constant(self._beta1))
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment": moment, "InfNorm": inf_norm,
                    "Beta1Pow": self._beta1_pow_acc},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment,
                     "InfNormOut": inf_norm},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)

    def _finish_update(self, block):
        """Scale beta1^t once per step (reference: a scale op)."""
        block.append_op(
            type="scale",
            inputs={"X": self._beta1_pow_acc},
            outputs={"Out": self._beta1_pow_acc},
            attrs={"scale": self._beta1, "op_role": ROLE_OPTIMIZE},
            infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1.0e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment_acc},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate=learning_rate,
                                                **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        avg_squared_grad_acc = self._get_accumulator(
            self._avg_squared_grad_acc_str, param_and_grad[0])
        avg_squared_update_acc = self._get_accumulator(
            self._avg_squared_update_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "AvgSquaredGrad": avg_squared_grad_acc,
                    "AvgSquaredUpdate": avg_squared_update_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "AvgSquaredGradOut": avg_squared_grad_acc,
                     "AvgSquaredUpdateOut": avg_squared_update_acc},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6, momentum=0.0,
                 **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate=learning_rate,
                                               **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": momentum_acc, "MeanSquare": mean_square_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "MomentOut": momentum_acc,
                     "MeanSquareOut": mean_square_acc},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum}, infer_shape=False)


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate=learning_rate,
                                            **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        squared_acc = self._get_accumulator(self._squared_acc_str,
                                            param_and_grad[0])
        linear_acc = self._get_accumulator(self._linear_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "SquaredAccumulator": squared_acc,
                    "LinearAccumulator": linear_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "SquaredAccumOut": squared_acc,
                     "LinearAccumOut": linear_acc},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
            infer_shape=False)


# reference optimizer.py end-of-module aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage(Optimizer):
    """Running average of the parameters for evaluation (reference
    optimizer.py:ModelAverage; the JAX package's :466-528): accumulate()
    once per trained batch adds every averaged parameter into a sum,
    apply() puts sum / count in the scope and restore() puts the trained
    values back. As in the JAX package, the window arguments are kept and
    not read (the average runs over every accumulated batch).

    The scope's persistables are a captured step's static buffers, so the
    sums stay on the parameters' device and apply() and restore() copy_
    into the scope's tensors in place: the next replay reads what they
    wrote, and a replay after restore() is the replay without the
    averaging. The scope is the global scope (fluid.scope_guard sets it),
    as in the JAX package."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super(ModelAverage, self).__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._sums = {}
        self._num_acc = 0
        self._backup = {}
        main = default_main_program()
        for param in main.global_block().all_parameters():
            if param.do_model_average is not False:
                self.params_grads.append((param, None))

    def accumulate(self, executor=None):
        """Call once per trained batch: the sums grow on the device."""
        from .executor import global_scope
        vars_ = global_scope().vars
        with torch.no_grad():
            for param, _ in self.params_grads:
                v = vars_.get(param.name)
                if v is None:
                    continue
                if param.name in self._sums:
                    self._sums[param.name].add_(v)
                else:
                    self._sums[param.name] = v.detach().clone()
        self._num_acc += 1

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        from .executor import global_scope
        vars_ = global_scope().vars
        self._backup = {}
        with torch.no_grad():
            for param, _ in self.params_grads:
                if param.name in self._sums and self._num_acc > 0:
                    v = vars_[param.name]
                    self._backup[param.name] = v.detach().clone()
                    v.copy_(self._sums[param.name] / float(self._num_acc))
        yield
        if need_restore:
            self.restore(executor)

    def restore(self, executor=None):
        from .executor import global_scope
        vars_ = global_scope().vars
        with torch.no_grad():
            for name, v in self._backup.items():
                vars_[name].copy_(v)
        self._backup = {}
