"""Composite networks. Parity: reference python/paddle/fluid/nets.py and
the JAX package's fluid/nets.py:8-142. scaled_dot_product_attention with
more than one head and no dropout emits one flash_attention op, whose rule
launches the hand-written flash-attention kernels on the card (forward,
and the backward pair under training)."""
from . import layers

__all__ = ["simple_img_conv_pool", "glu", "scaled_dot_product_attention",
           "img_conv_group", "sequence_conv_pool"]

def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type='max', use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act, use_cudnn=use_cudnn)
    pool_out = layers.pool2d(input=conv_out, pool_size=pool_size,
                             pool_type=pool_type, pool_stride=pool_stride,
                             use_cudnn=use_cudnn)
    return pool_out


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True,
                   use_mkldnn=False):
    """reference nets.py:img_conv_group (VGG blocks)."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def __extend_list__(obj):
        if not hasattr(obj, '__len__'):
            return [obj] * len(conv_num_filter)
        else:
            return list(obj)

    conv_padding = __extend_list__(conv_padding)
    conv_filter_size = __extend_list__(conv_filter_size)
    param_attr = __extend_list__(param_attr)
    conv_with_batchnorm = __extend_list__(conv_with_batchnorm)
    conv_batchnorm_drop_rate = __extend_list__(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act,
                            use_cudnn=use_cudnn)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    pool_out = layers.pool2d(input=tmp, pool_size=pool_size,
                             pool_type=pool_type, pool_stride=pool_stride,
                             use_cudnn=use_cudnn)
    return pool_out


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv then sequence_pool (reference nets.py:
    sequence_conv_pool)."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit (reference nets.py:glu)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(x=b)
    out = layers.elementwise_mul(x=a, y=act_b)
    return out


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.):
    """Multi-head scaled-dot-product attention (reference nets.py): q, k
    and v projected by fc, split into heads, attended and the heads
    combined."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError("inputs must be 3-D")
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("hidden size of queries and keys should be the same")
    if keys.shape[-2] != values.shape[-2]:
        raise ValueError("max seq len of keys and values should be the same")

    def __compute_qkv(queries, keys, values, num_heads):
        if num_heads == 1:
            return queries, keys, values
        q = layers.fc(input=queries, size=queries.shape[-1],
                      num_flatten_dims=2)
        k = layers.fc(input=keys, size=keys.shape[-1], num_flatten_dims=2)
        v = layers.fc(input=values, size=values.shape[-1], num_flatten_dims=2)
        return q, k, v

    def __split_heads(x, num_heads):
        if num_heads == 1:
            return x
        hidden_size = x.shape[-1]
        reshaped = layers.reshape(
            x=x, shape=[0, -1, num_heads, hidden_size // num_heads])
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    def __combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans_x = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            x=trans_x,
            shape=[0, -1, int(trans_x.shape[2]) * int(trans_x.shape[3])])

    q, k, v = __compute_qkv(queries, keys, values, num_heads)
    q = __split_heads(q, num_heads)
    k = __split_heads(k, num_heads)
    v = __split_heads(v, num_heads)

    key_dim_per_head = keys.shape[-1] // num_heads

    if not dropout_rate and num_heads > 1:
        # no attention-weight dropout: ONE flash_attention op (the
        # hand-written kernels on the card, which never keep the
        # [B, H, T, T] weights in memory); with dropout the unfused chain
        # below keeps the reference's semantics
        ctx = layers.fused_attention(q, k, v,
                                     scale=key_dim_per_head ** -0.5)
        return __combine_heads(ctx)

    scaled_q = layers.scale(x=q, scale=key_dim_per_head ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    # the reference flattens to 2-D because its softmax op was 2-D-only
    # (nets.py:scaled_dot_product_attention); this softmax normalizes the
    # last axis at any rank, as the JAX package's does
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return __combine_heads(ctx_multiheads)
