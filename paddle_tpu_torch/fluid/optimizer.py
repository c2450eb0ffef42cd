"""Optimizers: append per-param update ops after backward.

Parity: reference python/paddle/fluid/optimizer.py and the JAX package's
fluid/optimizer.py:28-274 (Optimizer, SGD, Momentum, Adagrad, Adam). The
update ops run eagerly after the autodiff marker (executor.py); their rules
are ops_impl/optim_ops.py. Adamax, DecayedAdagrad, RMSProp, Ftrl, Adadelta
and ModelAverage wait for a later slice (ROADMAP.md).
"""
from collections import defaultdict

from . import unique_name
from .framework import Variable, default_main_program, program_guard, \
    ROLE_OPTIMIZE
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .layers import tensor as tensor_layers

__all__ = ['SGD', 'Momentum', 'Adagrad', 'Adam', 'SGDOptimizer',
           'MomentumOptimizer', 'AdagradOptimizer', 'AdamOptimizer',
           'Optimizer']


class Optimizer(object):
    """Base optimizer (reference optimizer.py:Optimizer)."""

    def __init__(self, learning_rate, regularization=None,
                 LARS_weight_decay=0.0):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        if LARS_weight_decay:
            raise NotImplementedError(
                'LARS weight decay (append_LARS) is not ported yet')
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = dict()
        self._accumulators = defaultdict(lambda: dict())
        self.helper = None

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


# reference optimizer.py end-of-module aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
