"""Neural-network layers. Parity: reference python/paddle/fluid/layers/nn.py
and the JAX package's fluid/layers/nn.py — the dense, vision, sequence and
recurrent layers, the CRF/CTC layers and the sampled losses nce and
hsigmoid and the mixture-of-experts FFN moe_mlp (the detection layers are
in layers/detection.py). Each appends op symbols lowered by ops_impl/.
"""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr
from . import tensor as tensor_mod

__all__ = [
    'fc', 'embedding', 'layer_norm', 'dropout', 'reshape', 'transpose',
    'fused_attention', 'label_smooth', 'one_hot',
    'softmax_with_cross_entropy', 'reduce_sum', 'conv2d', 'pool2d',
    'batch_norm', 'softmax', 'cross_entropy', 'square_error_cost', 'topk',
    'matmul', 'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod',
    'cos_sim', 'l2_normalize', 'split', 'multiplex', 'pad', 'gather',
    'expand', 'scatter', 'random_crop', 'relu', 'log', 'crop', 'flatten',
    'stack', 'autoincreased_step_counter',
    'dynamic_lstm', 'dynamic_lstmp', 'dynamic_gru', 'gru_unit', 'lstm_unit',
    'sequence_conv', 'sequence_pool', 'sequence_first_step',
    'sequence_last_step', 'sequence_softmax', 'sequence_expand',
    'sequence_reshape', 'im2sequence', 'row_conv', 'lod_reset',
    'sequence_mask', 'linear_chain_crf', 'crf_decoding', 'chunk_eval',
    'ctc_greedy_decoder', 'edit_distance', 'warpctc', 'beam_search',
    'beam_search_decode', 'conv3d', 'pool3d', 'conv2d_transpose',
    'conv3d_transpose', 'smooth_l1', 'lrn', 'roi_pool', 'dice_loss',
    'image_resize', 'resize_bilinear', 'image_resize_short', 'mean_iou',
    'rank_loss', 'prelu', 'nce', 'hsigmoid', 'moe_mlp',
]


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


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
    """reference nn.py:embedding (lookup_table op). With is_sparse=True a
    training step hands the table's optimizer the touched rows (a
    lowering.SparseRows, fluid/executor.py) instead of a dense gradient.
    is_distributed is recorded on the op for artifact parity; the
    row-sharded lookup wire waits for the parallel slice."""
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


def _reduce_layer(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type=op_type, inputs={'X': [input]}, outputs={'Out': [out]},
        attrs={'dim': dim if dim is not None else [0],
               'keep_dim': keep_dim,
               'reduce_all': True if dim is None else False})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer('reduce_sum', input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer('reduce_mean', input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer('reduce_max', input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer('reduce_min', input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer('reduce_prod', input, dim, keep_dim, name)


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


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper('matmul', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='matmul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'transpose_X': transpose_x,
                            'transpose_Y': transpose_y,
                            'alpha': float(alpha)})
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


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None, data_format='NCHW'):
    """reference nn.py:conv2d (NCHW); data_format='NHWC' runs channels-last
    with the SAME OIHW filter params, so a model switches layout without
    touching checkpoints (JAX package layers/nn.py:399)."""
    if data_format not in ('NCHW', 'NHWC'):
        raise ValueError("data_format must be 'NCHW' or 'NHWC', got %r"
                         % (data_format,))
    num_channels = (input.shape[-1] if data_format == 'NHWC'
                    else input.shape[1])
    helper = LayerHelper('conv2d', **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] ** 2 * num_channels)) ** 0.5
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std, 0))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='conv2d',
        inputs={'Input': [input], 'Filter': [filter_param]},
        outputs={"Output": [pre_bias]},
        attrs={'strides': _pair(stride), 'paddings': _pair(padding),
               'dilations': _pair(dilation), 'groups': groups,
               'use_cudnn': use_cudnn, 'data_format': data_format})
    if data_format == 'NHWC':
        pre_act = helper.append_bias_op(pre_bias, dim_start=-1)
    else:
        pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def softmax(input, param_attr=None, bias_attr=None, use_cudnn=True,
            name=None):
    helper = LayerHelper('softmax', **locals())
    dtype = helper.input_dtype()
    softmax_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [softmax_out]}, attrs={})
    return softmax_out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None,
           data_format='NCHW'):
    """reference nn.py:pool2d; data_format='NHWC' pools channels-last. The
    op carries no `exclusive` attr, so an average is exclusive (the
    rule's default)."""
    if pool_type not in ["max", "avg"]:
        raise ValueError("pool_type must be 'max' or 'avg'")
    if data_format not in ('NCHW', 'NHWC'):
        raise ValueError("data_format must be 'NCHW' or 'NHWC', got %r"
                         % (data_format,))
    if global_pooling is False and pool_size == -1:
        raise ValueError("pool_size must be set without global pooling")
    helper = LayerHelper('pool2d', **locals())
    dtype = helper.input_dtype()
    pool_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='pool2d', inputs={"X": [input]}, outputs={"Out": [pool_out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "global_pooling": global_pooling,
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding), "ceil_mode": ceil_mode,
               "data_format": data_format})
    return pool_out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    """reference nn.py:batch_norm. The running mean and variance are
    persistable parameters, not trainable and stop_gradient, initialized
    to 0 and 1; the op writes them back (MeanOut, VarianceOut) in
    training, so a training step's scope holds the updated stats."""
    if data_layout not in ('NCHW', 'NHWC'):
        raise ValueError("data_layout must be 'NCHW' or 'NHWC', got %r"
                         % (data_layout,))
    helper = LayerHelper('batch_norm', **locals())
    dtype = helper.input_dtype()
    channel_num = input.shape[1] if data_layout == 'NCHW' \
        else input.shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                       trainable=False), shape=param_shape, dtype=dtype)
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                       trainable=False), shape=param_shape, dtype=dtype)
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(dtype,
                                                           stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    batch_norm_out = input if in_place else \
        helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [batch_norm_out], "MeanOut": [mean],
                 "VarianceOut": [variance], "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout})
    return helper.append_activation(batch_norm_out)


def cross_entropy(input, label, soft_label=False):
    """-log(input[label] + 1e-8) per row: input is a probability (a softmax
    before it), not a logit."""
    helper = LayerHelper('cross_entropy', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='cross_entropy',
                     inputs={'X': [input], 'Label': [label]},
                     outputs={'Y': [out]}, attrs={'soft_label': soft_label})
    return out


def square_error_cost(input, label):
    """reference nn.py:square_error_cost = (input - label)^2."""
    helper = LayerHelper('square_error_cost', **locals())
    minus_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='elementwise_sub',
                     inputs={'X': [input], 'Y': [label]},
                     outputs={'Out': [minus_out]}, attrs={'axis': -1})
    square_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='square', inputs={'X': [minus_out]},
                     outputs={'Out': [square_out]})
    return square_out


def topk(input, k, name=None):
    """The k largest entries of each row of input and their int64 ids,
    equal values in index order (stop_gradient both)."""
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def cos_sim(X, Y):
    helper = LayerHelper('cos_sim', **locals())
    out = helper.create_variable_for_type_inference(dtype=X.dtype)
    xnorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    ynorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    helper.append_op(type='cos_sim', inputs={'X': [X], 'Y': [Y]},
                     outputs={'Out': [out], 'XNorm': [xnorm],
                              'YNorm': [ynorm]})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    if len(x.shape) == 1:
        axis = 0
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', **locals())
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = None
    else:
        num = len(num_or_sections)
        sections = list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(num)]
    helper.append_op(
        type='split', inputs={'X': [input]}, outputs={'Out': outs},
        attrs={'num': num_or_sections if isinstance(num_or_sections, int)
               else 0,
               'sections': sections or [], 'axis': dim})
    return outs


def multiplex(inputs, index):
    helper = LayerHelper('multiplex', **locals())
    if not isinstance(inputs, list) or len(inputs) < 2:
        raise ValueError("multiplex needs >= 2 inputs")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type='multiplex',
                     inputs={'X': inputs, 'Ids': [index]},
                     outputs={'Out': [out]})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """reference nn.py:autoincreased_step_counter: a persistable int64
    counter, incremented by `step` at every run, `begin` at the first."""
    helper = LayerHelper('global_step_counter')
    counter_name = counter_name or '@STEP_COUNTER@'
    blk = helper.main_program.global_block()
    if counter_name in blk.vars:
        counter = blk.vars[counter_name]
    else:
        counter = helper.create_global_variable(
            name=counter_name, dtype='int64', shape=[1], persistable=True)
        helper.set_variable_initializer(
            counter, initializer=Constant(value=float(begin - 1)))
    helper.append_op(type='increment', inputs={'X': [counter]},
                     outputs={'Out': [counter]}, attrs={'step': float(step)},
                     infer_shape=False)
    counter.stop_gradient = True
    return counter


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper('pad', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='pad', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'paddings': list(paddings),
                            'pad_value': float(pad_value)})
    return out


def gather(input, index):
    helper = LayerHelper('gather', **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def expand(x, expand_times, name=None):
    """Tile each dim of x by expand_times (reference
    operators/expand_op.cc)."""
    helper = LayerHelper('expand', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='expand', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'expand_times': list(expand_times)})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper('scatter', **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="random_crop", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return out


def relu(x, name=None):
    helper = LayerHelper('relu', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def log(x, name=None):
    helper = LayerHelper('log', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="log", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper('crop', **locals())
    if offsets is None:
        offsets = [0] * len(x.shape)
    out = helper.create_variable_for_type_inference(x.dtype)
    ipts = {'X': [x]}
    attrs = {'offsets': list(offsets)}
    if isinstance(shape, Variable):
        ipts['Y'] = [shape]
    else:
        attrs['shape'] = list(shape)
    helper.append_op(type='crop', inputs=ipts, outputs={'Out': [out]},
                     attrs=attrs)
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper('flatten', **locals())
    if not (isinstance(axis, int)) or axis > len(x.shape) or axis < 0:
        raise ValueError("axis must be in [0, rank(x)]")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='flatten', inputs={"X": [x]},
                     outputs={'Out': [out]}, attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper('stack', **locals())
    if not isinstance(x, list) and not isinstance(x, tuple):
        x = [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type='stack', inputs={'X': x}, outputs={'Y': [out]},
                     attrs={'axis': axis})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None):
    """Noise-contrastive estimation (the JAX layers/nn.py:1306; reference
    nn.py:nce): Weight [N, D], Bias [N, 1]; returns the cost divided by
    num_neg_samples + 1 (10 negatives by default)."""
    helper = LayerHelper('nce', **locals())
    dim = input.shape[1]
    num_true_class = label.shape[1] if len(label.shape) > 1 else 1
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[num_total_classes, 1],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(dtype=input.dtype)
    sample_logits = helper.create_variable_for_type_inference(
        dtype=input.dtype)
    sample_labels = helper.create_variable_for_type_inference(
        dtype=label.dtype)
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    inputs = {'Input': [input], 'Label': [label], 'Weight': [w], 'Bias': [b]}
    if sample_weight is not None:
        inputs['SampleWeight'] = [sample_weight]
    helper.append_op(type='nce', inputs=inputs,
                     outputs={'Cost': [cost], 'SampleLogits': [sample_logits],
                              'SampleLabels': [sample_labels]},
                     attrs={'num_total_classes': int(num_total_classes),
                            'num_neg_samples': num_neg_samples,
                            'num_true_classes': num_true_class})
    return cost / (num_neg_samples + 1)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None):
    """Hierarchical sigmoid (the JAX layers/nn.py:1334; reference
    nn.py:hsigmoid): W [C - 1, D], Bias [1, C - 1]."""
    helper = LayerHelper('hierarchical_sigmoid', **locals())
    dim = input.shape[1]
    weights = helper.create_parameter(attr=helper.param_attr,
                                      shape=[num_classes - 1, dim],
                                      dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {'X': [input], 'W': [weights], 'Label': [label]}
    if helper.bias_attr:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[1, num_classes - 1],
                                       dtype=input.dtype, is_bias=True)
        inputs['Bias'] = [bias]
    helper.append_op(type='hierarchical_sigmoid', inputs=inputs,
                     outputs={'Out': [out], 'PreOut': [pre_out]},
                     attrs={'num_classes': num_classes})
    return out


def moe_mlp(input, num_experts, hidden_size, size=None, act='relu',
            capacity_factor=2.0, gate_param_attr=None, param_attr=None,
            bias_attr=None, name=None, top_k=1, return_aux_loss=False):
    """Top-k gated mixture-of-experts FFN (the JAX layers/nn.py:1399).

    Each of `num_experts` experts is a two-layer MLP
    ``act(x @ w1 + b1) @ w2 + b2`` with hidden width `hidden_size`; tokens
    are routed top-k by a learned linear gate with fixed capacity
    (capacity_factor * top_k * tokens / experts; overflow dropped, all
    first choices claiming slots before any second choice). top_k=1 uses
    Switch-style raw-probability gates; top_k>=2 renormalizes the selected
    gates per token (GShard). On a mesh whose dp size divides num_experts,
    each rank runs num_experts/dp experts and dispatch rides two
    all_to_alls (parallel.moe); otherwise every expert runs locally with
    the same semantics.

    With return_aux_loss=True, also returns the scalar load-balancing
    auxiliary loss (E * sum_e f_e * P_e, 1.0 for a uniform router) to add
    to the objective with a small weight, e.g. ``cost + 0.01 * aux``.

    input: [N, d] tokens or [B, T, d] activations. Parameters: GateW [d, E],
    W1 [E, d, h], B1 [E, h], W2 [E, h, out], B2 [E, out]. Returns the input's
    shape with the last dim `size` (default d), or (out, aux_loss)."""
    from ..ops_impl.moe_ops import supported_acts
    if (act or None) is not None and act not in supported_acts():
        raise ValueError(
            "moe_mlp act=%r is not supported; pick one of %s"
            % (act, sorted(a for a in supported_acts() if a)))
    if not 1 <= int(top_k) <= int(num_experts):
        raise ValueError('moe_mlp top_k=%r must be in [1, num_experts=%d]'
                         % (top_k, num_experts))
    helper = LayerHelper('moe_mlp', **locals())
    dtype = helper.input_dtype()
    d = int(input.shape[-1])
    out_d = int(size) if size is not None else d
    gate_w = helper.create_parameter(attr=ParamAttr.to_attr(gate_param_attr),
                                     shape=[d, num_experts], dtype=dtype,
                                     is_bias=False)
    w1 = helper.create_parameter(attr=ParamAttr.to_attr(param_attr),
                                 shape=[num_experts, d, hidden_size],
                                 dtype=dtype, is_bias=False)
    b1 = helper.create_parameter(attr=ParamAttr.to_attr(bias_attr),
                                 shape=[num_experts, hidden_size],
                                 dtype=dtype, is_bias=True)
    w2 = helper.create_parameter(attr=ParamAttr.to_attr(param_attr),
                                 shape=[num_experts, hidden_size, out_d],
                                 dtype=dtype, is_bias=False)
    b2 = helper.create_parameter(attr=ParamAttr.to_attr(bias_attr),
                                 shape=[num_experts, out_d], dtype=dtype,
                                 is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    aux = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='moe_mlp',
        inputs={'X': [input], 'GateW': [gate_w], 'W1': [w1], 'B1': [b1],
                'W2': [w2], 'B2': [b2]},
        outputs={'Out': [out], 'AuxLoss': [aux]},
        attrs={'num_experts': int(num_experts),
               'capacity_factor': float(capacity_factor),
               'top_k': int(top_k),
               'act': act or ''})
    if return_aux_loss:
        return out, aux
    return out


# -- sequence and recurrent layers (the JAX layers/nn.py :163-300, :376,
# :480-516, :730, :907-951, :1026, :1286) -------------------------------

def _create_rnn_bias_param(helper, attr, shape, dtype):
    return helper.create_parameter(attr=attr, shape=shape, dtype=dtype,
                                   is_bias=True)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None):
    """reference nn.py:dynamic_lstm: input is the projected gates
    [*, 4 * hidden]; one lstm op."""
    helper = LayerHelper('lstm', **locals())
    size = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 4 * size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = _create_rnn_bias_param(helper, helper.bias_attr, bias_size, dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if c_0 is not None:
        inputs['C0'] = [c_0]
    helper.append_op(type='lstm', inputs=inputs,
                     outputs={'Hidden': [hidden], 'Cell': [cell]},
                     attrs={'use_peepholes': use_peepholes,
                            'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'cell_activation': cell_activation,
                            'candidate_activation': candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation='sigmoid', cell_activation='tanh',
                  candidate_activation='tanh', proj_activation='tanh',
                  dtype='float32', name=None):
    helper = LayerHelper('lstmp', **locals())
    size = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[proj_size, 4 * size], dtype=dtype)
    proj_weight = helper.create_parameter(
        attr=ParamAttr(name=None), shape=[size, proj_size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = _create_rnn_bias_param(helper, helper.bias_attr, bias_size, dtype)
    projection = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='lstmp',
                     inputs={'Input': [input], 'Weight': [weight],
                             'ProjWeight': [proj_weight], 'Bias': [bias]},
                     outputs={'Projection': [projection], 'Cell': [cell]},
                     attrs={'use_peepholes': use_peepholes,
                            'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'cell_activation': cell_activation,
                            'candidate_activation': candidate_activation,
                            'proj_activation': proj_activation})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None):
    helper = LayerHelper('gru', **locals())
    dtype = helper.input_dtype()
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = _create_rnn_bias_param(helper, helper.bias_attr, [1, 3 * size],
                                  dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    helper.append_op(type='gru', inputs=inputs, outputs={'Hidden': [hidden]},
                     attrs={'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'activation': candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid'):
    helper = LayerHelper('gru_unit', **locals())
    dtype = helper.input_dtype()
    size = size // 3
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'HiddenPrev': [hidden], 'Weight': [weight]}
    if helper.bias_attr:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[1, 3 * size], dtype=dtype,
                                       is_bias=True)
        inputs['Bias'] = [bias]
    helper.append_op(type='gru_unit', inputs=inputs,
                     outputs={'Hidden': [updated_hidden],
                              'ResetHiddenPrev': [reset_hidden_pre],
                              'Gate': [gate]},
                     attrs={'activation': activation,
                            'gate_activation': gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """reference nn.py:lstm_unit: fc([x, h]) then the fused cell."""
    helper = LayerHelper('lstm_unit', **locals())
    if len(x_t.shape) != 2:
        raise ValueError("x_t must be 2-D")
    size = cell_t_prev.shape[1]
    concat_out = tensor_mod.concat(input=[x_t, hidden_t_prev], axis=1)
    fc_out = fc(input=concat_out, size=4 * size, param_attr=param_attr,
                bias_attr=bias_attr)
    dtype = x_t.dtype
    c = helper.create_variable_for_type_inference(dtype)
    h = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='lstm_unit',
                     inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper('sequence_conv', **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    # the input's shape with the feature axis -> num_filters (reference
    # sequence_conv_op InferShape)
    out_shape = list(input.shape[:-1]) + [num_filters]
    pre_bias = helper.create_variable_for_type_inference(
        dtype, shape=out_shape, lod_level=input.lod_level)
    helper.append_op(type='sequence_conv',
                     inputs={'X': [input], 'Filter': [filter_param]},
                     outputs={'Out': [pre_bias]},
                     attrs={'contextStride': filter_stride,
                            'contextStart': -int(filter_size // 2),
                            'contextLength': filter_size})
    pre_act = helper.append_bias_op(pre_bias, dim_start=-1)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type):
    helper = LayerHelper('sequence_pool', **locals())
    dtype = helper.input_dtype()
    # one row per innermost sequence, the feature dims kept: the padded
    # [B, T, ...] loses its time axis (reference sequence_pool_op)
    lod = getattr(input, 'lod_level', 0) or 0
    shape = None
    if input.shape is not None:
        shape = (list(input.shape[:1]) + list(input.shape[2:])
                 if lod > 0 and len(input.shape) >= 3 else
                 list(input.shape))
    pool_out = helper.create_variable_for_type_inference(
        dtype, shape=shape, lod_level=max(lod - 1, 0))
    max_index = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [pool_out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input=input, pool_type="first")


def sequence_last_step(input):
    return sequence_pool(input=input, pool_type="last")


def sequence_softmax(input, param_attr=None, bias_attr=None, use_cudnn=True):
    helper = LayerHelper('sequence_softmax', **locals())
    dtype = helper.input_dtype()
    softmax_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [softmax_out]}, attrs={})
    return softmax_out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper('sequence_expand', **locals())
    dtype = helper.input_dtype('x')
    # a sequence [rows, T (dynamic), features...]: each x row broadcast
    # over y's time axis
    shape = None
    if x.shape is not None:
        feat = (list(x.shape[2:]) if (x.lod_level or 0) > 0
                and len(x.shape) >= 3 else list(x.shape[1:]))
        shape = [x.shape[0], -1] + feat
    tmp = helper.create_variable_for_type_inference(
        dtype, shape=shape,
        lod_level=max(1, getattr(y, 'lod_level', 0) or 0))
    helper.append_op(type='sequence_expand',
                     inputs={'X': [x], 'Y': [y]}, outputs={'Out': [tmp]},
                     attrs={'ref_level': ref_level})
    return tmp


def sequence_reshape(input, new_dim):
    helper = LayerHelper('sequence_reshape', **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type='sequence_reshape', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'new_dim': new_dim})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    padding = _pair(padding)
    if len(padding) == 2:
        padding = [padding[0], padding[1], padding[0], padding[1]]
    helper = LayerHelper('im2sequence', **locals())
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype())
    helper.append_op(type='im2sequence', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'kernels': _pair(filter_size),
                            'strides': _pair(stride), 'paddings': padding})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper('row_conv', **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='row_conv',
                     inputs={'X': [input], 'Filter': [filter_param]},
                     outputs={'Out': [out]})
    return helper.append_activation(out)


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset", **locals())
    # x's valid rows regrouped under the new lod: a sequence
    # [n_seqs (dynamic), T (dynamic), features...]
    new_lod = (getattr(y, 'lod_level', 0) or 1) if y is not None else 1
    shape = None
    if x.shape is not None:
        feat = (list(x.shape[2:]) if (x.lod_level or 0) > 0
                and len(x.shape) >= 3 else list(x.shape[1:]))
        shape = [-1, -1] + feat
    out = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=shape, lod_level=new_lod)
    if y is not None:
        helper.append_op(type="lod_reset", inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [out]})
    elif target_lod is not None:
        helper.append_op(type="lod_reset", inputs={'X': [x]},
                         attrs={'target_lod': list(target_lod)},
                         outputs={'Out': [out]})
    else:
        raise ValueError("y and target_lod should not be both None.")
    return out


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    helper = LayerHelper('sequence_mask', **locals())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type='sequence_mask', inputs={'X': [x]},
                     outputs={'Y': [out]},
                     attrs={'maxlen': maxlen if maxlen is not None else -1,
                            'out_dtype': dtype})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """The CRF's negative log-likelihood per sequence [B, 1]; its
    transition parameter [size + 2, size] holds the start weights in row
    0, the stop weights in row 1 and the pair weights below."""
    helper = LayerHelper('linear_chain_crf', **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(attr=helper.param_attr,
                                         shape=[size + 2, size],
                                         dtype=helper.input_dtype())
    alpha = helper.create_variable_for_type_inference(helper.input_dtype())
    emission_exps = helper.create_variable_for_type_inference(
        helper.input_dtype())
    transition_exps = helper.create_variable_for_type_inference(
        helper.input_dtype())
    log_likelihood = helper.create_variable_for_type_inference(
        helper.input_dtype())
    helper.append_op(type='linear_chain_crf',
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label]},
                     outputs={"Alpha": [alpha],
                              "EmissionExps": [emission_exps],
                              "TransitionExps": [transition_exps],
                              "LogLikelihood": [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """The Viterbi path under the transition `param_attr` names; with a
    label, the per-token 0/1 match mask."""
    helper = LayerHelper('crf_decoding', **locals())
    transition = helper.get_parameter(param_attr.name)
    viterbi_path = helper.create_variable_for_type_inference('int64')
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type='crf_decoding', inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Precision, recall, F1 and the three chunk counts of a tagging
    against its label, under chunk_scheme 'IOB', 'IOE', 'IOBES' or
    'plain'."""
    helper = LayerHelper("chunk_eval", **locals())
    precision = helper.create_variable_for_type_inference(dtype="float32")
    recall = helper.create_variable_for_type_inference(dtype="float32")
    f1_score = helper.create_variable_for_type_inference(dtype="float32")
    num_infer_chunks = helper.create_variable_for_type_inference(
        dtype="int64")
    num_label_chunks = helper.create_variable_for_type_inference(
        dtype="int64")
    num_correct_chunks = helper.create_variable_for_type_inference(
        dtype="int64")
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1_score],
                 "NumInferChunks": [num_infer_chunks],
                 "NumLabelChunks": [num_label_chunks],
                 "NumCorrectChunks": [num_correct_chunks]},
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
            num_correct_chunks)


def ctc_greedy_decoder(input, blank, name=None):
    """The per-frame argmax with repeats merged and blanks dropped (the
    ctc_align op)."""
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    ctc_out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="ctc_align", inputs={"Input": [input]},
                     outputs={"Output": [ctc_out]},
                     attrs={"merge_repeated": True, "blank": blank})
    return ctc_out


def edit_distance(input, label, normalized=True, ignored_tokens=None):
    """The Levenshtein distance of each hypothesis to its reference [B, 1]
    (divided by the reference's length when normalized) and the number of
    sequences."""
    helper = LayerHelper("edit_distance", **locals())
    edit_distance_out = helper.create_variable_for_type_inference(
        dtype="float32")
    sequence_num = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [edit_distance_out],
                              "SequenceNum": [sequence_num]},
                     attrs={"normalized": normalized,
                            "ignored_tokens": ignored_tokens or []})
    return edit_distance_out, sequence_num


def warpctc(input, label, blank=0, norm_by_times=False):
    """The CTC loss of each sequence of logits against its label [B, 1]."""
    helper = LayerHelper('warpctc', **locals())
    loss_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    grad_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='warpctc',
                     inputs={'Logits': [input], 'Label': [label]},
                     outputs={'WarpCTCGrad': [grad_out], 'Loss': [loss_out]},
                     attrs={'blank': blank, 'norm_by_times': norm_by_times})
    return loss_out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id, level=0,
                name=None, return_parent_idx=False):
    """One beam-search step (reference nn.py:2658 +
    operators/beam_search_op.cc): the dense [batch*beam] layout with
    explicit parent pointers instead of LoD lineage; on the 2-level LoD
    values of the book's While-loop decoder, the reference algorithm at a
    fixed capacity (ops_impl/lod_beam.py)."""
    helper = LayerHelper('beam_search', **locals())
    selected_scores = helper.create_variable_for_type_inference('float32')
    selected_ids = helper.create_variable_for_type_inference('int64')
    parent_idx = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='beam_search',
                     inputs={'pre_ids': [pre_ids],
                             'pre_scores': [pre_scores],
                             'ids': [ids], 'scores': [scores]},
                     outputs={'selected_ids': [selected_ids],
                              'selected_scores': [selected_scores],
                              'parent_idx': [parent_idx]},
                     attrs={'level': level, 'beam_size': beam_size,
                            'end_id': end_id})
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_size=None, end_id=0, parents=None,
                       name=None):
    """reference nn.py:2770. Dense contract: ids/scores are stacked
    [T, batch, beam] tensors (use layers.stack over per-step outputs);
    `parents` carries the beam lineage emitted by beam_search. Tokens past
    each sentence's first end_id come out as end_id (padding). beam_size is
    taken from the tensor shape; the arg is accepted for API parity.
    Passed the LoDTensorArrays of the book's While-loop decoder, it
    backtraces them into 2-level LoD sentences."""
    helper = LayerHelper('beam_search_decode', **locals())
    sentence_ids = helper.create_variable_for_type_inference('int64')
    sentence_scores = helper.create_variable_for_type_inference('float32')
    inputs = {"Ids": [ids], "Scores": [scores]}
    if parents is not None:
        inputs["Parents"] = [parents]
    helper.append_op(type="beam_search_decode",
                     inputs=inputs,
                     outputs={"SentenceIds": [sentence_ids],
                              "SentenceScores": [sentence_scores]},
                     attrs={'end_id': end_id})
    return sentence_ids, sentence_scores


# -- the vision layers (the JAX layers/nn.py :448-1255) ---------------------

def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    """reference nn.py:conv3d, NCDHW with an OIDHW filter."""
    num_channels = input.shape[1]
    helper = LayerHelper('conv3d', **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    filter_size = _triple(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (int(np.prod(filter_size)) * num_channels)) ** 0.5
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std, 0))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='conv3d',
        inputs={'Input': [input], 'Filter': [filter_param]},
        outputs={"Output": [pre_bias]},
        attrs={'strides': _triple(stride), 'paddings': _triple(padding),
               'dilations': _triple(dilation), 'groups': groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None):
    helper = LayerHelper('pool3d', **locals())
    dtype = helper.input_dtype()
    pool_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='pool3d', inputs={"X": [input]}, outputs={"Out": [pool_out]},
        attrs={"pooling_type": pool_type, "ksize": _triple(pool_size),
               "global_pooling": global_pooling,
               "strides": _triple(pool_stride),
               "paddings": _triple(pool_padding), "ceil_mode": ceil_mode})
    return pool_out


def _conv_transpose(op_type, ntuple, input, num_filters, filter_size,
                    padding, stride, dilation, groups, param_attr,
                    bias_attr, act, name):
    """A transposed convolution layer: filter [in_c, num_filters / groups,
    *filter_size], then the bias and the activation."""
    helper = LayerHelper(op_type, input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = 1 if groups is None else groups
    filter_shape = [input.shape[1], num_filters // groups] + filter_size
    img_filter = helper.create_parameter(dtype=input.dtype,
                                         shape=filter_shape,
                                         attr=helper.param_attr)
    pre_bias = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type=op_type,
        inputs={'Input': [input], 'Filter': [img_filter]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': ntuple(stride), 'paddings': ntuple(padding),
               'dilations': ntuple(dilation), 'groups': groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """reference nn.py:conv2d_transpose; without filter_size it is derived
    from output_size."""
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is "
                             "None")
        output_size = _pair(output_size)
        padding, stride, dilation = (_pair(padding), _pair(stride),
                                     _pair(dilation))
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in range(2)]
    return _conv_transpose('conv2d_transpose', _pair, input, num_filters,
                           _pair(filter_size), padding, stride, dilation,
                           groups, param_attr, bias_attr, act, name)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    if filter_size is None:
        raise ValueError("filter_size is required for conv3d_transpose")
    return _conv_transpose('conv3d_transpose', _triple, input, num_filters,
                           _triple(filter_size), padding, stride, dilation,
                           groups, param_attr, bias_attr, act, name)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper('smooth_l1_loss', **locals())
    diff = helper.create_variable_for_type_inference(dtype=x.dtype)
    loss = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {'X': [x], 'Y': [y]}
    if inside_weight is not None:
        inputs['InsideWeight'] = [inside_weight]
    if outside_weight is not None:
        inputs['OutsideWeight'] = [outside_weight]
    helper.append_op(type='smooth_l1_loss', inputs=inputs,
                     outputs={'Diff': [diff], 'Out': [loss]},
                     attrs={'sigma': sigma if sigma is not None else 1.0})
    return loss


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper('lrn', **locals())
    dtype = helper.input_dtype()
    if len(input.shape) != 4:
        raise ValueError("Input of lrn must be 4-D (NCHW)")
    mid_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    lrn_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='lrn', inputs={'X': [input]},
                     outputs={'Out': [lrn_out], 'MidOut': [mid_out]},
                     attrs={'n': n, 'k': k, 'alpha': alpha, 'beta': beta})
    return lrn_out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    helper = LayerHelper('roi_pool', **locals())
    dtype = helper.input_dtype()
    pool_out = helper.create_variable_for_type_inference(dtype)
    argmaxes = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type="roi_pool",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [pool_out], "Argmax": [argmaxes]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return pool_out


def dice_loss(input, label, epsilon=0.00001):
    helper = LayerHelper('dice_loss', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="dice_loss",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Out": [out]}, attrs={"epsilon": epsilon})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample='BILINEAR'):
    resample_methods = {'BILINEAR': 'bilinear_interp',
                        'NEAREST': 'nearest_interp'}
    if resample not in resample_methods:
        raise ValueError("resample must be BILINEAR or NEAREST")
    if out_shape is None and scale is None:
        raise ValueError("one of out_shape and scale must be set")
    helper = LayerHelper(resample_methods[resample], **locals())
    dtype = helper.input_dtype()
    inputs = {"X": [input]}
    if out_shape is not None:
        if isinstance(out_shape, Variable):
            inputs['OutSize'] = [out_shape]
            out_h = out_w = 0
        else:
            out_h, out_w = int(out_shape[0]), int(out_shape[1])
    else:
        out_h = int(input.shape[2] * scale)
        out_w = int(input.shape[3] * scale)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type=resample_methods[resample], inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"out_h": out_h, "out_w": out_w},
                     infer_shape='OutSize' not in inputs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, 'BILINEAR')


def image_resize_short(input, out_short_len, resample='BILINEAR'):
    """Resize so the shorter side is out_short_len, the aspect kept."""
    in_shape = input.shape
    if len(in_shape) != 4:
        raise ValueError("image_resize_short needs a 4-D (NCHW) input")
    hw = list(in_shape[2:4])
    short_idx = hw.index(min(hw))
    out_shape = list(hw)
    out_shape[short_idx] = out_short_len
    out_shape[1 - short_idx] = int(
        float(out_shape[1 - short_idx]) *
        (float(out_short_len) / float(hw[short_idx])) + 0.5)
    return image_resize(input=input, out_shape=out_shape, resample=resample)


def mean_iou(input, label, num_classes):
    helper = LayerHelper('mean_iou', **locals())
    out_mean_iou = helper.create_variable_for_type_inference(dtype='float32')
    out_wrong = helper.create_variable_for_type_inference(dtype='int64')
    out_correct = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [out_mean_iou],
                              "OutWrong": [out_wrong],
                              "OutCorrect": [out_correct]},
                     attrs={"num_classes": num_classes})
    return out_mean_iou, out_wrong, out_correct


def rank_loss(label, left, right, name=None):
    helper = LayerHelper('rank_loss', **locals())
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type='rank_loss',
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={'Out': [out]})
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper('prelu', **locals())
    if mode not in ['all', 'channel', 'element']:
        raise ValueError('mode should be one of all, channel, element')
    alpha_shape = [1]
    if mode == 'channel':
        alpha_shape = [1, x.shape[1], 1, 1]
    elif mode == 'element':
        alpha_shape = list(x.shape)
        alpha_shape[0] = 1
    alpha = helper.create_parameter(attr=ParamAttr.to_attr(param_attr),
                                    shape=alpha_shape, dtype='float32',
                                    is_bias=False,
                                    default_initializer=Constant(1.0))
    out = helper.create_variable_for_type_inference('float32')
    helper.append_op(type="prelu", inputs={"X": [x], 'Alpha': [alpha]},
                     attrs={"mode": mode}, outputs={"Out": [out]})
    return out
