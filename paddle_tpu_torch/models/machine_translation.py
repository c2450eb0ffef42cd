"""Seq2seq LSTM encoder-decoder with attention (WMT14 en-fr).

Parity: reference benchmark/fluid/models/machine_translation.py
(seq_to_seq_net:91, lstm_step:31) and the JAX package's
models/machine_translation.py, op for op: a forward and a reverse
dynamic_lstm encoder, concatenated; the fused attention_lstm_decoder
(teacher-forced); a softmax projection over the target vocabulary; the
cross entropy averaged over valid target steps; Adam. With
is_generating=True the encoder feeds one attention_lstm_beam_decode op
(the JAX :41-74, :105-107), the whole beam search, which reuses the
training decoder's parameters by name: build it under unique_name.guard()
so the encoder's names line up with training's too.
"""
from .. import fluid
from ..batch import batch
from ..dataset import wmt14
from ..fluid.layer_helper import LayerHelper

__all__ = ['seq_to_seq_net', 'get_model']

def _attention_decoder(trg_emb, enc_out, hidden_dim, name='mt'):
    helper = LayerHelper('attention_lstm_decoder')
    dtype = trg_emb.dtype
    e = trg_emb.shape[-1]
    d = enc_out.shape[-1]
    w_dec = helper.get_or_create_parameter(
        name + '_w_dec', shape=[e + d, 4 * hidden_dim], dtype=dtype)
    u_dec = helper.get_or_create_parameter(
        name + '_u_dec', shape=[hidden_dim, 4 * hidden_dim], dtype=dtype)
    b_dec = helper.get_or_create_parameter(
        name + '_b_dec', shape=[1, 4 * hidden_dim], dtype=dtype,
        is_bias=True)
    w_q = helper.get_or_create_parameter(
        name + '_w_attnq', shape=[hidden_dim, d], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='attention_lstm_decoder',
                     inputs={'TrgEmb': [trg_emb], 'EncOut': [enc_out],
                             'WDec': [w_dec], 'UDec': [u_dec],
                             'BDec': [b_dec], 'WAttnQ': [w_q]},
                     outputs={'Hidden': [out]})
    return out


def _beam_decode(enc_out, decoder_size, target_dict_dim, embedding_dim,
                 beam_size, max_length, start_id=0, end_id=1, name='mt'):
    """The whole beam search as one op over the training decoder's
    parameters, the target embedding and the output projection, taken by
    name. Returns (SentenceIds int64 [B, beam, max_length], SentenceScores
    float32 [B, beam])."""
    helper = LayerHelper('attention_lstm_beam_decode')
    dtype = enc_out.dtype
    d = enc_out.shape[-1]
    e, h = embedding_dim, decoder_size

    def param(suffix, shape, is_bias=False):
        return helper.get_or_create_parameter(name + suffix, shape=shape,
                                              dtype=dtype, is_bias=is_bias)

    ins = {'EncOut': [enc_out],
           'WDec': [param('_w_dec', [e + d, 4 * h])],
           'UDec': [param('_u_dec', [h, 4 * h])],
           'BDec': [param('_b_dec', [1, 4 * h], is_bias=True)],
           'WAttnQ': [param('_w_attnq', [h, d])],
           'WEmb': [param('_trg_emb', [target_dict_dim, e])],
           'WOut': [param('_w_out', [h, target_dict_dim])],
           'BOut': [param('_b_out', [1, target_dict_dim], is_bias=True)]}
    sent_ids = helper.create_variable_for_type_inference('int64')
    sent_scores = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='attention_lstm_beam_decode', inputs=ins,
        outputs={'SentenceIds': [sent_ids], 'SentenceScores': [sent_scores]},
        attrs={'beam_size': beam_size, 'max_len': max_length,
               'start_id': start_id, 'end_id': end_id})
    return sent_ids, sent_scores


def seq_to_seq_net(embedding_dim, encoder_size, decoder_size,
                   source_dict_dim, target_dict_dim, is_generating=False,
                   beam_size=3, max_length=50, name='mt'):
    """reference machine_translation.py:seq_to_seq_net. Feeds
    source_sequence, target_sequence and label_sequence (int64, lod_level
    1). Returns (avg_cost, the feed names); with is_generating=True it
    feeds source_sequence only and returns (sentence_ids [B, beam_size,
    max_length], sentence_scores [B, beam_size])."""
    src_word_idx = fluid.layers.data(name='source_sequence', shape=[1],
                                     dtype='int64', lod_level=1)
    src_embedding = fluid.layers.embedding(
        input=src_word_idx, size=[source_dict_dim, embedding_dim])
    src_forward = fluid.layers.fc(input=src_embedding,
                                  size=encoder_size * 4, bias_attr=True)
    enc_fwd, _ = fluid.layers.dynamic_lstm(input=src_forward,
                                           size=encoder_size * 4,
                                           use_peepholes=False)
    src_reversed = fluid.layers.fc(input=src_embedding,
                                   size=encoder_size * 4, bias_attr=True)
    enc_bwd, _ = fluid.layers.dynamic_lstm(input=src_reversed,
                                           size=encoder_size * 4,
                                           use_peepholes=False,
                                           is_reverse=True)
    encoded_vector = fluid.layers.concat(input=[enc_fwd, enc_bwd], axis=2)

    if is_generating:
        return _beam_decode(encoded_vector, decoder_size, target_dict_dim,
                            embedding_dim, beam_size, max_length, name=name)

    trg_word_idx = fluid.layers.data(name='target_sequence', shape=[1],
                                     dtype='int64', lod_level=1)
    trg_embedding = fluid.layers.embedding(
        input=trg_word_idx, size=[target_dict_dim, embedding_dim],
        param_attr=fluid.ParamAttr(name=name + '_trg_emb'))

    dec_hidden = _attention_decoder(trg_embedding, encoded_vector,
                                    decoder_size, name=name)
    prediction = fluid.layers.fc(
        input=dec_hidden, size=target_dict_dim, act='softmax',
        num_flatten_dims=2, param_attr=fluid.ParamAttr(name=name + '_w_out'),
        bias_attr=fluid.ParamAttr(name=name + '_b_out'))

    label = fluid.layers.data(name='label_sequence', shape=[1],
                              dtype='int64', lod_level=1)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = _masked_mean(cost)
    feeding_list = ["source_sequence", "target_sequence", "label_sequence"]
    return avg_cost, feeding_list


def _masked_mean(cost):
    """The mean over valid (unpadded) target steps: the sequences' masked
    sums over the sum of their lengths."""
    per_seq = fluid.layers.sequence_pool(cost, 'sum')
    total = fluid.layers.reduce_sum(per_seq)
    ones = fluid.layers.scale(cost, scale=0.0, bias=1.0)   # a sequence of 1s
    denom = fluid.layers.reduce_sum(fluid.layers.sequence_pool(ones, 'sum'))
    return fluid.layers.elementwise_div(total, denom)


def get_model(batch_size=16, embedding_dim=512, encoder_size=512,
              decoder_size=512, dict_size=30000):
    """In the default programs. Returns (avg_cost, the for_test clone
    taken before the optimizer, train_reader, test_reader, the feed
    names)."""
    avg_cost, feeding_list = seq_to_seq_net(
        embedding_dim, encoder_size, decoder_size, dict_size, dict_size,
        False)
    inference_program = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.Adam(learning_rate=0.0002).minimize(avg_cost)
    train_reader = batch(wmt14.train(dict_size), batch_size=batch_size)
    test_reader = batch(wmt14.test(dict_size), batch_size=batch_size)
    return avg_cost, inference_program, train_reader, test_reader, \
        feeding_list
