"""LayerHelper: shared plumbing for layer functions.

Parity: reference python/paddle/fluid/layer_helper.py and the JAX package's
fluid/layer_helper.py — creates parameters (registering their init op on
the startup program), temp variables, bias and activation epilogues.
"""
import copy

from . import unique_name
from .framework import Variable, default_main_program, \
    default_startup_program
from .param_attr import ParamAttr

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get('name')
        if name is None:
            self.kwargs['name'] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs['name']

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return list(inputs)

    def input(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input" % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('param_attr', None))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('bias_attr', None))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError("parameter number mismatch")
        elif len(param_attr) == 1 and length != 1:
            param_attr = [copy.deepcopy(param_attr[0]) for _ in range(length)]
        return param_attr

    def iter_inputs_and_params(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("data type mismatch in inputs")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        """Creates the Parameter in the main program's global block AND a
        same-named var + init op in the startup program (reference
        layer_helper.py:create_parameter)."""
        if not isinstance(attr, ParamAttr):
            raise TypeError("expected a ParamAttr, got %r" % (attr,))
        suffix = 'b' if is_bias else 'w'
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, suffix]))
        if default_initializer is None and attr.initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)

        shape = [int(s) for s in shape]
        startup_blk = self.startup_program.global_block()
        sp_var = startup_blk.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr.to_kwargs(with_initializer=False).items()
               if k != 'name'})
        attr.initializer(sp_var, startup_blk)
        main_blk = self.main_program.global_block()
        if attr.name in main_blk.vars:
            return main_blk.vars[attr.name]
        return main_blk.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr.to_kwargs().items() if k != 'name'})

    def create_variable_for_type_inference(self, dtype, stop_gradient=False,
                                           shape=None, lod_level=0):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, 'tmp'])),
            dtype=dtype, shape=shape, persistable=False,
            lod_level=lod_level, stop_gradient=stop_gradient)

    # reference name
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Declare `var` in the startup program (persistable) and append
        its init op there."""
        startup_blk = self.startup_program.global_block()
        if var.name not in startup_blk.vars:
            startup_blk.create_var(name=var.name, shape=var.shape,
                                   dtype=var.dtype, persistable=True)
        initializer(startup_blk.vars[var.name], startup_blk)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """Add a bias over dims [dim_start, dim_end) of the input."""
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr and any(d == -1 for d in size):
            raise ValueError(
                "bias shape %s contains a dynamic dim; pass dim_start/"
                "dim_end selecting only static dims" % (size,))
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape,
            lod_level=input_var.lod_level)
        self.append_op(
            type='elementwise_add',
            inputs={'X': [input_var], 'Y': [b]},
            outputs={'Out': [tmp]},
            attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act', None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop('type')
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape,
            lod_level=input_var.lod_level)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
