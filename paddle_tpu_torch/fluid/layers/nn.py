"""Neural-network layers. Parity: reference python/paddle/fluid/layers/nn.py
and the JAX package's fluid/layers/nn.py — the subset models/transformer.py
builds with. Each appends op symbols lowered by ops_impl/.
"""
import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = [
    'fc', 'embedding', 'layer_norm', 'dropout', 'reshape', 'transpose',
    'fused_attention', 'label_smooth', 'one_hot',
    'softmax_with_cross_entropy', 'reduce_sum',
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected (reference nn.py:fc): one mul per input + sum +
    bias + act."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        if input_var.lod_level > 0 and num_flatten_dims == 1:
            flat_dims = 2   # sequence input [B, T, d]: apply fc per step
        else:
            flat_dims = num_flatten_dims
        param_shape = [int(np.prod(input_shape[flat_dims:]))] + [size]
        w = helper.create_parameter(attr=param_attr_, shape=param_shape,
                                    dtype=dtype, is_bias=False)
        # static out shape (reference mul_op InferShape): X.dims[:k] + [size]
        out_shape = list(input_shape[:flat_dims]) + [size]
        tmp = helper.create_variable_for_type_inference(
            dtype, shape=out_shape,
            lod_level=getattr(input_var, 'lod_level', 0) or 0)
        helper.append_op(
            type="mul", inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": flat_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype, shape=mul_results[0].shape,
            lod_level=mul_results[0].lod_level)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]}, attrs={})
    pre_act = helper.append_bias_op(pre_bias, dim_start=-1, dim_end=None)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """reference nn.py:embedding (lookup_table op). is_sparse and
    is_distributed are recorded on the op for artifact parity; the port
    runs the dense lookup."""
    helper = LayerHelper('embedding', **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    # static out shape (reference lookup_table_op InferShape): an id
    # column [..., 1] embeds to [..., emb_dim]
    in_shape = getattr(input, 'shape', None)
    out_shape = None
    if in_shape is not None and len(in_shape):
        base = list(in_shape[:-1]) if in_shape[-1] == 1 else list(in_shape)
        out_shape = base + [size[-1]]
    tmp = helper.create_variable_for_type_inference(
        dtype, shape=out_shape,
        lod_level=getattr(input, 'lod_level', 0) or 0)
    padding_idx = -1 if padding_idx is None else \
        padding_idx if padding_idx >= 0 else (size[0] + padding_idx)
    helper.append_op(type='lookup_table',
                     inputs={'Ids': [input], 'W': [w]},
                     outputs={'Out': [tmp]},
                     attrs={'is_sparse': is_sparse,
                            'is_distributed': is_distributed,
                            'padding_idx': padding_idx})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {'X': [input]}
    if scale:
        scale_p = helper.create_parameter(attr=helper.param_attr,
                                          shape=param_shape, dtype=dtype,
                                          default_initializer=Constant(1.0))
        inputs['Scale'] = [scale_p]
    if shift:
        bias_p = helper.create_parameter(attr=helper.bias_attr,
                                         shape=param_shape, dtype=dtype,
                                         is_bias=True)
        inputs['Bias'] = [bias_p]
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    variance_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    layer_norm_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [layer_norm_out], "Mean": [mean_out],
                 "Variance": [variance_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(layer_norm_out)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper('reduce_sum', name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type='reduce_sum', inputs={'X': [input]}, outputs={'Out': [out]},
        attrs={'dim': dim if dim is not None else [0],
               'keep_dim': keep_dim,
               'reduce_all': True if dim is None else False})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper('dropout', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(type='dropout', inputs={'X': [x]},
                     outputs={'Out': [out], 'Mask': [mask]},
                     attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
                            'fix_seed': seed is not None, 'seed': seed or 0})
    return out


def fused_attention(q, k, v, key_bias=None, causal=False, scale=None,
                    name=None):
    """Whole-attention fused op: softmax(q k^T * scale + bias) v in ONE op.

    q/k/v: [B, H, T, D]. key_bias: optional [B, Tk] (or [B,1,1,Tk]) additive
    bias for padded keys; causal adds lower-triangular masking. On a CUDA
    device the op runs the hand-written flash-attention forward kernel
    (paddle_tpu_torch/ops/flash_attention.py); on the CPU its plain torch
    version. The [B,H,Tq,Tk] score matrix is never kept in device memory
    by the kernel."""
    helper = LayerHelper('fused_attention', **locals())
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {'Q': [q], 'K': [k], 'V': [v]}
    if key_bias is not None:
        inputs['KeyBias'] = [key_bias]
    helper.append_op(type='flash_attention', inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'causal': bool(causal),
                            'scale': (float(scale) if scale is not None
                                      else -1.0)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='transpose', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': perm})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper('softmax_with_cross_entropy', **locals())
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(type='softmax_with_cross_entropy',
                     inputs={'Logits': [logits], 'Label': [label]},
                     outputs={'Softmax': [softmax], 'Loss': [loss]},
                     attrs={'soft_label': soft_label})
    return loss


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **locals())
    one_hot_out = helper.create_variable_for_type_inference(dtype='float32')
    helper.append_op(type="one_hot", inputs={'X': [input]},
                     attrs={'depth': depth},
                     outputs={'Out': [one_hot_out]})
    return one_hot_out


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", **locals())
    reshaped = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [reshaped]},
                     attrs={"shape": [int(d) for d in shape]})
    return helper.append_activation(reshaped)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    if epsilon > 1.0 or epsilon < 0.0:
        raise ValueError("epsilon must be in [0, 1]")
    helper = LayerHelper("label_smooth", **locals())
    label.stop_gradient = True
    smooth_label = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [smooth_label]},
                     attrs={"epsilon": float(epsilon)})
    return smooth_label
