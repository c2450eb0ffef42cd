"""Layered RNN decoder helper library: InitState / StateCell /
TrainingDecoder / BeamSearchDecoder.

Parity: reference python/paddle/fluid/contrib/decoder/beam_search_decoder.py
(same classes, same user contract: the reference's
tests/test_beam_search_decoder.py flow) and the JAX package's
fluid/contrib/decoder/beam_search_decoder.py, whose programs these classes
build op for op. The internals:

- TrainingDecoder rides the masked DynamicRNN (a fixed-T loop over the
  padded time axis, static shapes) instead of the reference's
  length-sorted DynamicRNNOp with per-step batch shrinking.
- BeamSearchDecoder runs a fixed-trip While loop (max_len iterations, the
  capacity of its arrays) over a dense [batch*beam] layout with explicit
  parent pointers, instead of the reference's LoD-shrinking arrays and
  early-stop is_empty. States are loop-carried vars; `need_reorder`
  states are re-gathered by the beam_search op's global parent rows each
  step. The decoded lineage is backtraced on the device by
  beam_search_decode, not by a host walk of LoDTensorArrays.
"""
import numpy as np

from ... import framework
from ...layers import control_flow, nn, ops, tensor
from ...layer_helper import LayerHelper

__all__ = ['InitState', 'StateCell', 'TrainingDecoder', 'BeamSearchDecoder']


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial value of a decoder state: either an existing Variable
    (e.g. the encoder's last step) or a (shape, value) constant built
    against a boot var's batch dim. `need_reorder` marks states that must
    follow beam lineage during search (hidden states yes, static context
    usually no)."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype='float32'):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                'init_boot must be provided to infer the init state shape')
        else:
            self._init = tensor.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState(object):
    """Training-time adapter: the state lives as a DynamicRNN memory."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _LoopState(object):
    """Beam-search adapter: the state is a loop-carried var on the decode
    While loop, pre-expanded to the dense [batch*beam] layout."""

    def __init__(self, state_name, decoder_obj, init_state):
        self._state_name = state_name
        self._decoder_obj = decoder_obj
        self._need_reorder = init_state.need_reorder
        # built OUTSIDE the While block: [batch, ...] -> [batch*beam, ...]
        self._var = tensor.assign(
            decoder_obj._expand_to_beam(init_state.value))

    def get_state(self):
        return self._var

    def update_state(self, state):
        if self._need_reorder:
            state = nn.gather(state, self._decoder_obj._parent_idx)
        tensor.assign(state, output=self._var)


class StateCell(object):
    """Holds decoder states + per-step inputs and a user-registered updater
    computing new states from them; adapts onto whichever decoder
    (training scan or beam-search loop) it is used inside."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper('state_cell', name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError('state must be an InitState object.')
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = inputs            # name -> Variable or None placeholder
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}         # state_name -> {id(decoder): adapter}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError('StateCell has already entered a decoder.')
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError('StateCell not in decoding.')
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError('Inconsistent decoder object in StateCell.')
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        """Lazily adapt each state onto the current decoder the first time
        it is touched inside the decoder's block."""
        if not self._in_decoder:
            raise ValueError('StateCell must be enclosed by a decoder.')
        if self._switched_decoder:
            raise ValueError('StateCell already switched to this decoder.')
        for state_name in self._state_names:
            if state_name not in self._states_holder:
                self._states_holder[state_name] = {}
            init_state = self._cur_states[state_name]
            if not isinstance(init_state, InitState):
                raise ValueError('Decoder switch requires an InitState; '
                                 'state %r was already consumed' % state_name)
            decoder_obj = self._cur_decoder_obj
            if decoder_obj.type == _DecoderType.TRAINING:
                adapter = _MemoryState(state_name, decoder_obj.dynamic_rnn,
                                       init_state)
            elif decoder_obj.type == _DecoderType.BEAM_SEARCH:
                adapter = _LoopState(state_name, decoder_obj, init_state)
            else:
                raise ValueError('Unknown decoder type %s' % decoder_obj.type)
            self._states_holder[state_name][id(decoder_obj)] = adapter
            self._cur_states[state_name] = adapter.get_state()
        self._switched_decoder = True

    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError('Unknown state %s.' % state_name)
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise ValueError('Invalid input %s.' % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        if state_name not in self._cur_states:
            raise ValueError('Unknown state %s.' % state_name)
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater
        return updater

    def compute_state(self, inputs):
        """Run the registered updater with this step's inputs filled in."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError('Unknown input %s. Cannot compute states.'
                                 % input_name)
            self._inputs[input_name] = input_value
        if self._state_updater is None:
            raise ValueError('No state updater registered; decorate one '
                             'with @state_cell.state_updater')
        self._state_updater(self)

    def update_states(self):
        """Push the computed states back into the decoder's carriers
        (RNN memories or loop vars)."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for state_name, decoder_state in self._states_holder.items():
            if id(self._cur_decoder_obj) not in decoder_state:
                raise ValueError('Unknown decoder object; state %s leaked '
                                 'from another decoder' % state_name)
            decoder_state[id(self._cur_decoder_obj)].update_state(
                self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder(object):
    """Teacher-forced decoding over the gold target sequence; one
    DynamicRNN loop. Usage mirrors the reference::

        decoder = TrainingDecoder(state_cell)
        with decoder.block():
            w = decoder.step_input(trg_embedding)
            decoder.state_cell.compute_state(inputs={'x': w})
            score = layers.fc(decoder.state_cell.get_state('h'), ...)
            decoder.state_cell.update_states()
            decoder.output(score)
        out = decoder()
    """
    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper('training_decoder', name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = control_flow.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def _block():
            if self._status != TrainingDecoder.BEFORE_DECODER:
                raise ValueError('decoder.block() can only be invoked once')
            self._status = TrainingDecoder.IN_DECODER
            with self._dynamic_rnn.block():
                yield
            self._status = TrainingDecoder.AFTER_DECODER
            self._state_cell._leave_decoder(self)
        return _block()

    @property
    def state_cell(self):
        self._assert_in_decoder_block('state_cell')
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x):
        self._assert_in_decoder_block('step_input')
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block('static_input')
        return self._dynamic_rnn.static_input(x)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError('Output of TrainingDecoder can only be visited '
                             'outside the block.')
        return self._dynamic_rnn(*args, **kwargs)

    def output(self, *outputs):
        self._assert_in_decoder_block('output')
        self._dynamic_rnn.output(*outputs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError('%s should be invoked inside block of '
                             'TrainingDecoder object.' % method)


class BeamSearchDecoder(object):
    """Beam-search generation driven by the same StateCell used in
    training. `decode()` builds the whole search loop (embedding of the
    previous tokens, state update, vocab projection, joint top-k beam step,
    lineage bookkeeping); `decoder()` afterwards returns
    (translation_ids [batch, beam, max_len], translation_scores
    [batch, beam]). Dense contract: every step runs all batch*beam rows;
    finished beams are frozen by the beam_search op, and the loop always
    runs max_len trips (bounded, capturable: no dynamic early exit)."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict={}, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=2, end_id=1, name=None):
        self._helper = LayerHelper('beam_search_decoder', name=name)
        self._counter = None
        self._status = BeamSearchDecoder.BEFORE_DECODER
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._type = _DecoderType.BEAM_SEARCH
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = input_var_dict
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._parent_idx = None
        self._translation_ids = None
        self._translation_scores = None

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    def _expand_to_beam(self, x):
        """[batch, ...] -> [batch*beam, ...] with each source's rows
        contiguous (row b becomes rows b*beam .. b*beam+beam-1)."""
        trailing = list(x.shape[1:])
        x3 = nn.reshape(x, shape=[-1, 1] + trailing)
        tiled = nn.expand(x3, [1, self._beam_size] + [1] * len(trailing))
        return nn.reshape(tiled, shape=[-1] + trailing)

    def decode(self):
        """Build the full decode loop. Equivalent of the reference's
        decode() (beam_search_decoder.py:653) minus the LoD machinery."""
        if self._status != BeamSearchDecoder.BEFORE_DECODER:
            raise ValueError('decode() can only be called once')
        self._status = BeamSearchDecoder.IN_DECODER
        state_cell = self._state_cell
        beam = self._beam_size

        # ---- outside the loop: dense beam expansion --------------------
        # init_ids/init_scores arrive as lod-2 vars in the reference API;
        # dense layout is one (token, score) per source: flatten first
        prev_ids = tensor.assign(self._expand_to_beam(
            nn.reshape(self._init_ids, shape=[-1, 1])))
        # non-first beams start at -1e9 so step 1 doesn't duplicate beams
        sc3 = self._expand_to_beam(
            nn.reshape(self._init_scores, shape=[-1, 1]))
        bias = np.full((beam, 1), -1e9, dtype=np.float32)
        bias[0, 0] = 0.0
        beam_bias = tensor.assign(bias)                      # [beam, 1]
        sc3 = nn.reshape(sc3, shape=[-1, beam, 1])
        sc3 = ops.elementwise_add(x=sc3, y=beam_bias, axis=1)
        prev_scores = tensor.assign(nn.reshape(sc3, shape=[-1, 1]))

        # adapt states onto this decoder NOW so their beam expansion ops
        # land outside the loop (loop-carried init, not per-trip re-init)
        if not state_cell._switched_decoder:
            state_cell._switch_decoder()
        # static per-source context: expand once, outside the loop
        expanded_inputs = {}
        for init_var_name, init_var in self._input_var_dict.items():
            if init_var_name not in state_cell._inputs:
                raise ValueError('Variable %s not found in StateCell inputs'
                                 % init_var_name)
            expanded_inputs[init_var_name] = self._expand_to_beam(init_var)

        ids_array = control_flow.create_array('int64',
                                              capacity=self._max_len)
        scores_array = control_flow.create_array('float32',
                                                 capacity=self._max_len)
        parents_array = control_flow.create_array('int64',
                                                  capacity=self._max_len)

        counter = tensor.zeros(shape=[1], dtype='int64')
        self._counter = counter
        # seed slot 0 so the loop carries have static shapes; the first
        # trip's write at counter==0 overwrites these placeholders
        control_flow.array_write(prev_ids, counter, ids_array)
        control_flow.array_write(prev_scores, counter, scores_array)
        control_flow.array_write(prev_ids, counter, parents_array)
        max_len = tensor.fill_constant(shape=[1], dtype='int64',
                                       value=self._max_len)
        cond = control_flow.less_than(x=counter, y=max_len)
        while_op = control_flow.While(cond=cond)

        with while_op.block():
            prev_ids_embedding = nn.embedding(
                input=prev_ids,
                size=[self._target_dict_dim, self._word_dim],
                dtype='float32', is_sparse=self._sparse_emb)

            feed_dict = dict(expanded_inputs)
            for input_name in state_cell._inputs:
                if input_name not in feed_dict:
                    feed_dict[input_name] = prev_ids_embedding

            state_cell.compute_state(inputs=feed_dict)
            current_state = state_cell.out_state()
            scores = nn.fc(input=current_state,
                           size=self._target_dict_dim, act='softmax')
            topk_scores, topk_indices = nn.topk(scores, k=self._topk_size)
            accu_scores = ops.elementwise_add(
                x=nn.log(topk_scores),
                y=nn.reshape(prev_scores, shape=[-1]), axis=0)
            selected_ids, selected_scores, parent_idx = nn.beam_search(
                prev_ids, prev_scores, topk_indices, accu_scores,
                self._beam_size, self._end_id, return_parent_idx=True)
            self._parent_idx = parent_idx

            control_flow.array_write(selected_ids, counter, ids_array)
            control_flow.array_write(selected_scores, counter, scores_array)
            control_flow.array_write(nn.reshape(parent_idx, shape=[-1, 1]),
                                     counter, parents_array)

            state_cell.update_states()
            tensor.assign(selected_ids, output=prev_ids)
            tensor.assign(selected_scores, output=prev_scores)
            control_flow.increment(x=counter, value=1, in_place=True)
            control_flow.less_than(x=counter, y=max_len, cond=cond)

        # ---- after the loop: stack arrays + backtrace on device --------
        stacked_ids = nn.reshape(_array_stack(ids_array),
                                 shape=[self._max_len, -1, beam])
        stacked_scores = nn.reshape(_array_stack(scores_array),
                                    shape=[self._max_len, -1, beam])
        stacked_parents = nn.reshape(_array_stack(parents_array),
                                     shape=[self._max_len, -1, beam])
        self._translation_ids, self._translation_scores = \
            nn.beam_search_decode(stacked_ids, stacked_scores,
                                  beam_size=beam, end_id=self._end_id,
                                  parents=stacked_parents)

        self._status = BeamSearchDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    def read_array(self, init, is_ids=False, is_scores=False):
        """API-parity helper (reference read_array): expand `init` to the
        beam layout and return a loop-carried var seeded with it."""
        self._assert_in_decoder_block('read_array')
        if is_ids and is_scores:
            raise ValueError('Shouldn\'t mark current array be ids array and '
                             'scores array at the same time.')
        return tensor.assign(self._expand_to_beam(init))

    def update_array(self, array, value):
        """API-parity helper (reference update_array): write this step's
        value back into the loop-carried var."""
        self._assert_in_decoder_block('update_array')
        tensor.assign(value, output=array)

    def __call__(self):
        if self._status != BeamSearchDecoder.AFTER_DECODER:
            raise ValueError('Output of BeamSearchDecoder object can only be '
                             'visited outside the block.')
        return self._translation_ids, self._translation_scores

    def _assert_in_decoder_block(self, method):
        if self._status != BeamSearchDecoder.IN_DECODER:
            raise ValueError('%s should be invoked inside block of '
                             'BeamSearchDecoder object.' % method)


def _array_stack(array):
    """Append the array_stack op: LoDTensorArray -> [capacity, ...] tensor."""
    helper = LayerHelper('array_stack')
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type='array_stack', inputs={'Array': [array]},
                     outputs={'Out': [out]}, infer_shape=False)
    return out
