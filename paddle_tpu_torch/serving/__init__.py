"""paddle_tpu_torch.serving — dynamic micro-batching serving engine.

Parity: the JAX package's paddle_tpu.serving, reduced to the
`ServingEngine` over a `Predictor` or a `load_compiled` runner (with
`push_rows`, the row deltas of the streaming freshness path), the
multi-replica `Router` (least-loaded dispatch, quotas, `push_deltas`,
`swap` to a compiled artifact, `stream` and its `TokenStream`) and the
continuous-batching `DecodeEngine` (dense, paged and speculative, fed
encoder rows or source tokens through a prefill such as
`program_prefill`; token streaming, cancel, checkpoint and resume) with
its whole-batch baseline `LockstepDecoder` (the pod and transport layers
wait for later slices of the port).

    from paddle_tpu_torch import inference, serving

    pred = inference.Predictor(model_dir)        # CUDAPlace(0)
    eng = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=16, max_queue_delay_ms=5))
    eng.warmup()                       # run every bucket once
    fut = eng.submit({'x': batch})     # concurrent.futures.Future
    logits, = fut.result()
    eng.push_rows({'emb_w': (row_ids, rows)})   # live weights, in place
    eng.shutdown()                     # drains in-flight requests

    router = serving.Router().add_model('m', [eng_a, eng_b])
    logits, = router.predict('m', {'x': batch})  # least-loaded replica
    router.push_deltas('m', {'emb_w': (row_ids, rows)})  # every replica

    dec = serving.DecodeEngine(weights, serving.DecodeConfig(   # the card
        slots=16, beam_size=3, max_len=50, src_cap=32, page_size=16,
        pages=64))
    dec.warmup()
    ids, scores = dec.submit({'enc': enc_rows}, max_new_tokens=20).result()
    dec.shutdown()

    # token requests: the generating program's encoder as the prefill
    pre = serving.program_prefill(exe, gen_program, scope,
                                  'source_sequence', encoder_out,
                                  token_cap=32)
    dec = serving.DecodeEngine(serving.mt_weights(scope), config,
                               prefill=pre)
    dec.warmup(example_feed={'source_sequence': src_ids})
    ids, scores = dec.submit({'source_sequence': src_ids}).result()

    # token streaming through the router; a compiled artifact behind swap
    router = serving.Router().add_model('mt', [dec])
    s = router.stream('mt', {'source_sequence': src_ids})
    for t, beam_row in s:              # t = 1, 2, ... in order
        ...
    ids, scores = s.result()
    inference.export_compiled(art_dir, feed, [logits], exe)
    router.swap('tfm', art_dir)        # ServingEngine(load_compiled(...))
"""
from . import buckets  # noqa: F401
from . import pages  # noqa: F401
from .pages import PagePool, PrefixCache  # noqa: F401
from .buckets import default_buckets, pad_rows, pick_bucket  # noqa: F401
from .engine import (DeadlineExceeded, DeltaUnsupported,  # noqa: F401
                     ServerClosed, ServerOverloaded, ServingConfig,
                     ServingEngine)
from .router import (ModelOverloaded, Router, TokenStream,  # noqa: F401
                     UnknownModel, estimate_state_bytes)
from .decode import (DecodeConfig, DecodeEngine,  # noqa: F401
                     DecodeSlotPoisoned, LockstepDecoder, StreamCancelled,
                     mt_weights, program_prefill)

__all__ = ['ServingEngine', 'ServingConfig', 'ServerOverloaded',
           'ServerClosed', 'DeadlineExceeded', 'DeltaUnsupported', 'Router',
           'ModelOverloaded', 'UnknownModel', 'TokenStream',
           'estimate_state_bytes', 'buckets',
           'default_buckets', 'pick_bucket', 'pad_rows', 'DecodeConfig',
           'DecodeEngine', 'DecodeSlotPoisoned', 'LockstepDecoder',
           'StreamCancelled', 'mt_weights', 'program_prefill', 'pages',
           'PagePool', 'PrefixCache']
