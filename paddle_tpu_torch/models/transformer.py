"""Transformer-base (WMT en-de) — the flagship sequence model.

A twin of the JAX package's models/transformer.py builder: the same layer
calls in the same order, so the Program it emits has the same ops, var
names, shapes and attrs. Dense padded [B, S] inputs with in-graph pad
masks; every attention is ONE flash_attention op, which on the card runs
the hand-written CUDA kernel (paddle_tpu_torch/ops/flash_attention.py).

get_model builds the training program as the JAX module's does (noam_decay
learning rate, Adam) with its wmt16 readers; training_program is that
program alone, with the dropout rate as an argument. The pp_decoder pipeline stamps
wait for the parallel slice of the port.
"""
import numpy as np

from ..batch import batch
from .. import fluid
from ..dataset import wmt16
from ..fluid import layers

__all__ = ['transformer', 'training_program', 'get_model', 'pad_batch']


def _position_encoding(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype('float32')
    i = np.arange(d_model)[None, :].astype('float32')
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.zeros((max_len, d_model), dtype='float32')
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


def _pre_post_process(prev, out, dropout_rate, mode='da'):
    """residual + dropout + layernorm (post-process 'dan' order)."""
    if 'd' in mode and dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate)
    if 'a' in mode and prev is not None:
        out = layers.elementwise_add(out, prev)
    if 'n' in mode:
        out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
    return out


def multi_head_attention(queries, keys, values, key_bias, d_model, n_head,
                         causal=False):
    """q/k/v projections + ONE fused flash-attention op + output
    projection. key_bias is the [B, S] pad bias; causal adds the decoder's
    triangular mask inside the kernel."""
    d_key = d_model // n_head
    q = layers.fc(input=queries, size=d_model, num_flatten_dims=2,
                  bias_attr=False)
    k = layers.fc(input=keys, size=d_model, num_flatten_dims=2,
                  bias_attr=False)
    v = layers.fc(input=values, size=d_model, num_flatten_dims=2,
                  bias_attr=False)

    def split_heads(x):
        x = layers.reshape(x, shape=[0, 0, n_head, d_key])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    q = split_heads(q)
    k = split_heads(k)
    v = split_heads(v)
    ctx = layers.fused_attention(q, k, v, key_bias=key_bias, causal=causal,
                                 scale=d_key ** -0.5)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, 0, d_model])
    return layers.fc(input=ctx, size=d_model, num_flatten_dims=2,
                     bias_attr=False)


def ffn(x, d_inner, d_model, dropout_rate):
    hidden = layers.fc(input=x, size=d_inner, num_flatten_dims=2, act='relu')
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate)
    return layers.fc(input=hidden, size=d_model, num_flatten_dims=2)


def encoder_layer(x, key_bias, d_model, n_head, d_inner, dropout_rate):
    attn = multi_head_attention(x, x, x, key_bias, d_model, n_head)
    x = _pre_post_process(x, attn, dropout_rate, 'dan')
    f = ffn(x, d_inner, d_model, dropout_rate)
    return _pre_post_process(x, f, dropout_rate, 'dan')


def decoder_layer(x, enc_out, self_key_bias, cross_key_bias, d_model, n_head,
                  d_inner, dropout_rate):
    attn = multi_head_attention(x, x, x, self_key_bias, d_model, n_head,
                                causal=True)
    x = _pre_post_process(x, attn, dropout_rate, 'dan')
    cross = multi_head_attention(x, enc_out, enc_out, cross_key_bias,
                                 d_model, n_head)
    x = _pre_post_process(x, cross, dropout_rate, 'dan')
    f = ffn(x, d_inner, d_model, dropout_rate)
    return _pre_post_process(x, f, dropout_rate, 'dan')


def _pad_mask_bias(word, name):
    """[B, S] additive key bias: -1e9 on pad (id 0) positions."""
    w = layers.cast(word, 'float32')
    nonpad = layers.clip(w, 0.0, 1.0)  # id 0 -> 0, others -> 1
    return layers.scale(nonpad, scale=1e9, bias=-1e9)  # 0 -> -1e9, 1 -> 0


def _embed(word, vocab_size, d_model, max_len, dropout_rate, name_prefix):
    emb = layers.embedding(
        input=word, size=[vocab_size, d_model],
        param_attr=fluid.ParamAttr(
            name=name_prefix + '_emb',
            initializer=fluid.initializer.Normal(0., d_model ** -0.5)))
    emb = layers.scale(emb, scale=d_model ** 0.5)
    pos = layers.assign(_position_encoding(max_len, d_model))
    pos.stop_gradient = True
    out = layers.elementwise_add(emb, pos, axis=1)
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate)
    return out


def transformer(src_vocab_size, trg_vocab_size, max_length, n_layer=6,
                d_model=512, n_head=8, d_inner=2048, dropout_rate=0.1,
                label_smooth_eps=0.1):
    """Build the training graph; returns (avg_cost, token_count, feeds).
    The decoder logits [B, T, V] are the X input of the reshape op that
    feeds softmax_with_cross_entropy — what an inference artifact
    fetches."""
    src_word = layers.data(name='src_word', shape=[max_length],
                           dtype='int64')
    trg_word = layers.data(name='trg_word', shape=[max_length],
                           dtype='int64')
    lbl_word = layers.data(name='lbl_word', shape=[max_length],
                           dtype='int64')

    src_bias = _pad_mask_bias(src_word, 'src')
    self_bias = _pad_mask_bias(trg_word, 'trg')

    enc = _embed(src_word, src_vocab_size, d_model, max_length,
                 dropout_rate, 'src')
    for _ in range(n_layer):
        enc = encoder_layer(enc, src_bias, d_model, n_head, d_inner,
                            dropout_rate)

    dec = _embed(trg_word, trg_vocab_size, d_model, max_length,
                 dropout_rate, 'trg')
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, self_bias, src_bias, d_model,
                            n_head, d_inner, dropout_rate)

    logits = layers.fc(input=dec, size=trg_vocab_size, num_flatten_dims=2,
                       bias_attr=False)
    logits2d = layers.reshape(logits, shape=[-1, trg_vocab_size])
    lbl2d = layers.reshape(lbl_word, shape=[-1, 1])
    if label_smooth_eps:
        soft = layers.label_smooth(
            layers.one_hot(lbl2d, depth=trg_vocab_size),
            epsilon=label_smooth_eps)
        cost = layers.softmax_with_cross_entropy(logits2d, soft,
                                                 soft_label=True)
    else:
        cost = layers.softmax_with_cross_entropy(logits2d, lbl2d)
    weights = layers.clip(layers.cast(lbl2d, 'float32'), 0.0, 1.0)
    weighted = layers.elementwise_mul(cost, weights)
    token_count = layers.reduce_sum(weights)
    avg_cost = layers.elementwise_div(layers.reduce_sum(weighted),
                                      token_count)
    return avg_cost, token_count, ['src_word', 'trg_word', 'lbl_word']


def pad_batch(batch, max_length):
    """Host-side: pad wmt16-style (src, trg, lbl) id lists to max_length."""
    out = []
    for src, trg, lbl in batch:
        def pad(x):
            x = list(x)[:max_length]
            return np.asarray(x + [0] * (max_length - len(x)), dtype='int64')
        out.append((pad(src), pad(trg), pad(lbl)))
    return out


def training_program(dict_size, max_length, n_layer=6, d_model=512,
                     n_head=8, d_inner=2048, learning_rate=2.0,
                     warmup_steps=4000, dropout_rate=0.1):
    """get_model's training program in the default programs: the
    Transformer, noam_decay scaled by learning_rate, and Adam. With
    dropout_rate 0 it is the same program without its dropout ops (the same
    parameter and accumulator names), which two devices or two packages
    step alike. Returns (avg_cost, token_count, feed names)."""
    avg_cost, token_count, feeds = transformer(
        dict_size, dict_size, max_length, n_layer, d_model, n_head, d_inner,
        dropout_rate=dropout_rate)
    lr = layers.learning_rate_scheduler.noam_decay(d_model, warmup_steps)
    lr = layers.scale(lr, scale=float(learning_rate))
    opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                               epsilon=1e-9)
    opt.minimize(avg_cost)
    return avg_cost, token_count, feeds


def get_model(batch_size=16, max_length=64, n_layer=6, d_model=512,
              n_head=8, d_inner=2048, dict_size=10000, learning_rate=2.0,
              warmup_steps=4000, pp_decoder=False):
    """The JAX package's models/transformer.py:get_model: the training
    program in the default programs, and its readers. Returns (avg_cost,
    token_count, train_reader, test_reader, feed names)."""
    if pp_decoder:
        raise NotImplementedError(
            'pp_decoder (the GPipe decoder stages) waits for the parallel '
            'slice of the port')
    avg_cost, token_count, feeds = training_program(
        dict_size, max_length, n_layer, d_model, n_head, d_inner,
        learning_rate, warmup_steps)

    raw_train = wmt16.train(dict_size, dict_size)
    raw_test = wmt16.test(dict_size, dict_size)

    def train_reader():
        for b in batch(raw_train, batch_size)():
            yield pad_batch(b, max_length)

    def test_reader():
        for b in batch(raw_test, batch_size)():
            yield pad_batch(b, max_length)

    return avg_cost, token_count, train_reader, test_reader, feeds
