#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one card.

    python3 tools/torch_train_profile.py [--model transformer] [--batch 16]
                                         [--steps 20]
    python3 tools/torch_train_profile.py --model deepfm [--batch 256]
                                         [--root CHECKOUT]
    python3 tools/torch_train_profile.py --model resnet50 [--batch 32]
                                         [--amp [--layout NHWC|NCHW]]
    python3 tools/torch_train_profile.py --model mnist [--batch 128]
    python3 tools/torch_train_profile.py --model vgg16 [--batch 32]
    python3 tools/torch_train_profile.py --model se_resnext50 [--batch 16]
    python3 tools/torch_train_profile.py --amp     (Transformer under AMP)
    python3 tools/torch_train_profile.py --model stacked_lstm | sentiment | mt
    python3 tools/torch_train_profile.py --model word2vec | recommender | srl
    python3 tools/torch_train_profile.py --model moe_encoder [--batch 16]

--model transformer (the default) builds full-width Transformer-base with
models.transformer.get_model (its defaults: 6+6 layers, d_model 512, 8
heads, d_inner 2048, vocab 10000; noam_decay, Adam, dropout 0.1) at
max_length 256 and warmup_steps 200, as chip_smoke.py trains it, and
trains it on its wmt16 reader. --model deepfm builds full-width DeepFM
(models.deepfm: 26 fields, vocab 100,000, embed_dim 10, hidden
[400, 400, 400]) with both FM tables is_sparse, auc and Adam(1e-3), as
chip_smoke.py's ctr_training phase does, and trains it on
synthetic_ctr_reader (restarted at the end of its 16 batches).
--model resnet50 builds models.resnet.get_model(data_set='imagenet',
depth=50) (1000 classes, 3x224x224, NCHW, Momentum(0.01, 0.9)), as
chip_smoke.py's image_training phase does, and trains it on batches of the
flowers reader read beforehand (restarted at the end of its 16); --model
mnist builds models.mnist.get_model (LeNet, Adam 1e-3) on its synthetic
reader. --model vgg16 builds models.vgg.get_model() (cifar10, 3x32x32,
Adam 1e-3, vgg16_bn_drop's dropouts) on its cifar reader, and --model
se_resnext50 models.se_resnext.get_model() (3x224x224, 102 classes,
cardinality 32, Momentum(0.01, 0.9)) on flowers batches read beforehand,
as chip_smoke.py's dense_training phase builds them. --model
stacked_lstm, sentiment and mt build the sequence models' get_model at
full width (stacked_dynamic_lstm: emb and lstm 512, vocab 5147, Adam,
batch 32; understand_sentiment: emb and hid 32, Adagrad 0.002, batch 32;
machine_translation's training program: emb, encoder and decoder 512,
dict 30000, Adam 2e-4, batch 16), as chip_smoke.py's sequences phase does,
and train them on one pass of their reader through the DataFeeder, the
batches kept whose padded time axes are the pass's most frequent (one
captured graph). --model word2vec, recommender and srl build the last
three book models as chip_smoke.py's book phase does: word2vec.get_model()
(dict 2073, embed 32, hidden 256, SGD 1e-3, batch 64),
recommender_system.get_model() (emb 32, towers 200, SGD 0.2, batch 256)
and label_semantic_roles at the reference book's sizes (word_dim 32,
mark_dim 5, hidden 512, depth 8, batch 10; SGD under
exponential_decay(0.01, 100000, 0.5, staircase=True); the pretrained emb
loaded), on their readers' batches of the most frequent bucket. --model
moe_encoder builds chip_smoke.py's MoE encoder (phase 7o: Transformer-base's
encoder, each FFN a moe_mlp of 8 experts, hidden 2048, top 2) on its wmt16
source batches; without a process group it runs the dense path, which at
one rank is the mesh path's arithmetic bit for bit. --amp
runs the model under fluid.amp.decorate_program: the
Transformer as it is (the bf16 attention kernels), ResNet-50 as the JAX
bench.py:215-253 builds it for AMP (a bfloat16 data var, resnet_imagenet
in --layout NHWC, the default there, or NCHW, the mean cross entropy and
accuracy, Momentum(0.01, 0.9)), on the same flowers batches made bf16 by
the DataFeeder.

Either way it initializes on CUDAPlace(0) from a seed and measures the
step two ways, side by side: `captured`, Executor.run as users call it (on
the card a replay of the step's captured CUDA graph from its third call
on), and `eager`, the same artifact's eager walk (StepArtifact.debug_step,
on a copy of the state, its fetches copied to the host). A --root
checkout whose Executor has no step_artifact reports its Executor.run as
`run` alone. For each it times each step on the host clock (each step ends in
its fetch), then traces a few more with torch.profiler: device time by
class, the share of the attention kernels and of the sparse kernels, and
the device's idle share (busy: the union of the kernels' intervals), both
of the traced wall time (the profiler slows the host) and of the untraced
median step. A replay runs no host op, so
the classes that lean on the host's ranges (the dense optimizer, the
sparse sort and merge; every class of the image models) are the eager
walk's only; the captured step's optimizer kernels count as elementwise.
The classes: matmul; the port's hand-written
kernels by name (flash attention forward and backward, sparse_adam,
sparse_adagrad); the sparse sort and the rest of the sparse merge (the
kernels launched inside _merge_sparse's `optim.merge_sparse` range, or
the rows-form wrapper's `sparse_optim.sort_ids`: the sort ops' kernels,
then the others); the dense optimizer update
(the rest of the Executor's `executor.update` range); other
elementwise/normalization kernels; copies. For the image models (resnet50,
mnist, vgg16, se_resnext50) each device kernel is classed instead by the host op that launched it (the
innermost enclosing op or range whose name matches, IMAGE_CLASSES): cuDNN
convolution forward and backward, batch norm forward (with the running
stats' var_mean) and backward, pooling, the optimizer update (the
`executor.update` range), copies, and the rest (elementwise, softmax,
loss, the fc's matmul). For srl the eager walk's kernels are classed as
matmul (by kernel name), the CRF loop (the kernels of linear_chain_crf's
and crf_decoding's rules and of their backward nodes, found through the
autograd sequence numbers of the ops inside a profiler range around each
rule), the recurrence (the lstm rule's, likewise), copies and the rest
(the fcs' elementwise work, sums, lookups, the optimizer). Prints one
JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED = 2024
MAX_LENGTH = 256
WARMUP_STEPS = 200
PROFILE_STEPS = 3
KERNEL_CLASSES = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                  'flash_attention_bwd_dkv', 'flash_attention_fwd_bf16',
                  'flash_attention_bwd_dq_bf16',
                  'flash_attention_bwd_dkv_bf16', 'sparse_adam',
                  'sparse_adagrad')
CLASSES = ('matmul',) + KERNEL_CLASSES + (
    'sparse sort', 'sparse merge (rest)', 'optimizer (dense)',
    'elementwise/norm/other', 'copy')
# the image models' classes: (class, substrings of the launching host op's
# name), tried from the innermost enclosing op outwards, first match wins
IMAGE_CLASSES = (
    ('conv backward', ('convolution_backward', 'ConvolutionBackward')),
    ('conv forward', ('convolution', 'conv2d')),
    ('batch_norm backward', ('batch_norm_backward', 'BatchNormBackward')),
    ('batch_norm forward', ('batch_norm', 'var_mean')),
    ('pool', ('pool2d',)),
    ('optimizer', ('executor.update',)),
)
# the ranges around the sparse rules' id bookkeeping: _merge_sparse's
# whole merge (the route of checkouts before the fused rows-form kernel)
# and the rows-form wrapper's cast and sort
MERGE_RANGES = ('optim.merge_sparse', 'sparse_optim.sort_ids')


def _kernel_class(name):
    n = name.lower()
    # the sparse kernels: one template over the rule since the rows form
    # (sparse_update_kernel<Adam, ...>), a kernel each before it
    sparse = 'sparse_update_kernel' in n
    if 'sparse_adagrad_kernel' in n or sparse and 'adagrad' in n:
        return 'sparse_adagrad'
    if 'sparse_adam_kernel' in n or sparse and 'adam' in n:
        return 'sparse_adam'
    for kernel in ('bwd_dq', 'bwd_dkv', 'fwd'):
        if kernel + '_bf16_kernel' in n:
            return 'flash_attention_%s_bf16' % kernel
        if kernel + '_kernel' in n:
            return 'flash_attention_' + kernel
    # cuBLAS's Hopper GEMMs (bf16 among them) are named nvjet_*
    if 'gemm' in n or 'cutlass' in n or 'xmma' in n or 'nvjet' in n:
        return 'matmul'
    if 'memcpy' in n or 'memset' in n:
        return 'copy'
    return 'elementwise/norm/other'


def _under(evt, names):
    """Whether a host event runs inside a range named in `names`."""
    parent = evt.cpu_parent
    while parent is not None:
        if parent.name in names:
            return True
        parent = parent.cpu_parent
    return False


def _sort_us(events):
    """Device time of the sorts inside the merge ranges: each outermost
    host op named *sort* under such a range, with its children."""
    import torch
    sorts = [e for e in events if 'sort' in e.name
             and e.name not in MERGE_RANGES
             and e.device_type != torch.autograd.DeviceType.CUDA]
    names = {e.name for e in sorts}
    return sum(e.device_time_total for e in sorts
               if _under(e, MERGE_RANGES) and not _under(e, names))


def busy_us(spans):
    """The device's busy time over (start, end) kernel intervals: the
    length of their union (cuDNN runs some of a grouped convolution's
    kernels at once, and a graph's independent nodes may run together, so
    their sum can pass the wall)."""
    busy, end = 0.0, float('-inf')
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def profile_steps(step, feeds, image=False, rule_classes=None):
    """Trace step(feed) over `feeds` with torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for feed in feeds:
            step(feed)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    classes = dict.fromkeys(CLASSES, 0.0)
    ranges = dict.fromkeys(('executor.update',) + MERGE_RANGES, 0.0)
    spans = []
    for evt in prof.events():
        if evt.name in ranges \
                and evt.device_type != torch.autograd.DeviceType.CUDA:
            ranges[evt.name] += evt.device_time_total
            continue
        # device-side records only (kernels, memcpys): the host ops that
        # launched them carry the same time again in their totals, and so
        # do the ops' projections onto the device timeline
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.is_user_annotation:
            continue
        classes[_kernel_class(evt.name)] += evt.time_range.elapsed_us()
        spans.append((evt.time_range.start, evt.time_range.end))
    # the update range holds the merge, the sparse kernels and the dense
    # rules; the merge's and the dense rules' kernels are elementwise,
    # sorts and scatters: move their time to their classes
    sparse_us = classes['sparse_adam'] + classes['sparse_adagrad']
    merge_us = sum(ranges[r] for r in MERGE_RANGES)
    classes['sparse sort'] = _sort_us(prof.events())
    classes['sparse merge (rest)'] = merge_us - classes['sparse sort']
    classes['optimizer (dense)'] = (ranges['executor.update'] - sparse_us
                                    - merge_us)
    classes['elementwise/norm/other'] -= (ranges['executor.update']
                                          - sparse_us)
    n = len(feeds)
    # the classes sum each kernel's own time
    busy_s = busy_us(spans) / 1e6
    if rule_classes:
        by_rule = rule_classes_us(prof.events(), rule_classes)
        return {
            'traced_wall_ms_per_step': traced_wall * 1e3 / n,
            'device_busy_ms_per_step': busy_s * 1e3 / n,
            'device_idle_share': 1.0 - busy_s / traced_wall,
            'device_kernels_per_step': len(spans) / n,
            'linked_ms_per_step': sum(by_rule.values()) / 1e3 / n,
            'device_ms_per_step_by_class': {k: v / 1e3 / n
                                            for k, v in by_rule.items()},
        }
    if image:
        image_us = image_classes_us(prof.events())
        # the same kernels by launching op; the sums agree within the
        # events the profiler could not link to an op
        return {
            'traced_wall_ms_per_step': traced_wall * 1e3 / n,
            'device_busy_ms_per_step': busy_s * 1e3 / n,
            'device_idle_share': 1.0 - busy_s / traced_wall,
            'linked_ms_per_step': sum(image_us.values()) / 1e3 / n,
            'conv_share_of_device_time': (
                image_us['conv forward'] + image_us['conv backward'])
            / 1e6 / busy_s,
            'device_ms_per_step_by_class': {k: v / 1e3 / n
                                            for k, v in image_us.items()},
        }
    shares = {}
    for group, prefix in (('attention', 'flash_attention'),
                          ('sparse_kernels', 'sparse_')):
        us = sum(v for k, v in classes.items() if k.startswith(prefix))
        shares[group + '_share_of_device_time'] = us / 1e6 / busy_s
        shares[group + '_share_of_step'] = us / 1e6 / traced_wall
    return {
        'traced_wall_ms_per_step': traced_wall * 1e3 / n,
        'device_busy_ms_per_step': busy_s * 1e3 / n,
        'device_idle_share': 1.0 - busy_s / traced_wall,
        **shares,
        'device_ms_per_step_by_class': {k: v / 1e3 / n
                                        for k, v in classes.items()},
    }


def image_classes_us(events):
    """{class: device us} over IMAGE_CLASSES, 'copy' and 'elementwise/
    other', each kernel (and memcpy/memset) charged to the class of the
    innermost host op around its launch that matches one."""
    import torch
    out = dict.fromkeys([c for c, _ in IMAGE_CLASSES]
                        + ['copy', 'elementwise/other'], 0.0)
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                or not evt.kernels:
            continue
        cls = None
        node = evt
        while node is not None and cls is None:
            for c, keys in IMAGE_CLASSES:
                if any(k in node.name for k in keys):
                    cls = c
                    break
            node = node.cpu_parent
        for k in evt.kernels:
            n = k.name.lower()
            c = 'copy' if ('memcpy' in n or 'memset' in n) \
                and cls != 'optimizer' else cls or 'elementwise/other'
            out[c] += k.duration
    return out


# srl: the rules whose kernels (forward, and backward through autograd)
# are classed together, by the profiler range the tool puts around each
SRL_CLASSES = (('crf loop', ('linear_chain_crf', 'crf_decoding')),
               ('recurrence (lstm)', ('lstm',)))


def range_rules(classes):
    """Wrap each rule named in `classes` in a torch.profiler range
    'rule.<op>' (this process only)."""
    from torch.profiler import record_function
    from paddle_tpu_torch.fluid import lowering

    def wrapped(op, rule):
        def run(ins, attrs, ctx):
            with record_function('rule.' + op):
                return rule(ins, attrs, ctx)
        return run
    for _, ops in classes:
        for op in ops:
            lowering._RULES[op] = wrapped(op, lowering.get_rule(op))


def rule_classes_us(events, classes):
    """{class: device us}: matmul kernels by name; every other kernel by
    the rule range ('rule.<op>') it was launched in, or by the forward op
    (its autograd sequence number) of the backward node that launched it;
    copies; the rest."""
    import torch
    of_range = {'rule.' + op: c for c, ops in classes for op in ops}
    host = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    seq = {}
    for e in host:
        if e.sequence_nr >= 0 and 'Backward' not in e.name:
            cls = next((of_range[a.name] for a in ancestors(e)
                        if a.name in of_range), None)
            if cls is not None:
                seq[e.sequence_nr] = cls
    out = dict.fromkeys(['matmul'] + [c for c, _ in classes]
                        + ['copy', 'elementwise/other'], 0.0)
    for e in host:
        if not e.kernels:
            continue
        cls = None
        for a in ancestors(e):
            if a.name in of_range:
                cls = of_range[a.name]
            elif 'Backward' in a.name and a.sequence_nr in seq:
                cls = seq[a.sequence_nr]
            if cls is not None:
                break
        for k in e.kernels:
            kc = _kernel_class(k.name)
            c = kc if kc in ('matmul', 'copy') else cls or \
                'elementwise/other'
            out[c] += k.duration
    return out


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build_transformer(batch_size, n_feeds):
    """get_model in fresh programs; returns (main, startup, fetch, feeds,
    units per step and their name)."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, reader, _, names = transformer.get_model(
            batch_size=batch_size, max_length=MAX_LENGTH,
            warmup_steps=WARMUP_STEPS)
    it = reader()
    feeds = [{n: np.stack([row[i] for row in batch])
              for i, n in enumerate(names)}
             for batch in (next(it) for _ in range(n_feeds))]
    return (main, startup, [avg_cost], feeds,
            batch_size * MAX_LENGTH * 2, 'source_target_positions_per_s')


def build_moe_encoder(batch_size, n_feeds):
    """chip_smoke.py's MoE encoder; returns as build_transformer."""
    sys.path.insert(0, HERE)
    import chip_smoke
    main, startup, avg_cost = chip_smoke.build_moe_encoder()
    feeds = chip_smoke._moe_feeds(batch_size, n_feeds)
    return (main, startup, [avg_cost], feeds,
            batch_size * chip_smoke.MOE_ENCODER['max_length'],
            'source_positions_per_s')


def build_deepfm(batch_size, n_feeds):
    """deepfm.training_program's defaults (both FM tables is_sparse, auc,
    Adam(1e-3)), as chip_smoke.py's ctr_training phase builds it; returns
    as build_transformer."""
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import deepfm
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, auc, _, _ = deepfm.training_program()
    epoch = [{'feat_ids': np.stack([r[0] for r in b]),
              'label': np.array([[r[1]] for r in b], dtype='int64')}
             for b in batch(deepfm.synthetic_ctr_reader(tag='train'),
                            batch_size)()]
    feeds = [epoch[i % len(epoch)] for i in range(n_feeds)]
    return main, startup, [avg_cost, auc], feeds, batch_size, \
        'examples_per_s'


def _flowers_feeds(main, reader, batch_size, n_feeds):
    """n_feeds full batches of a batched flowers reader through the
    DataFeeder, the reader restarted at its end."""
    from paddle_tpu_torch import fluid
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('data'), blk.var('label')],
                              fluid.CPUPlace(), program=main)
    feeds = []
    while len(feeds) < n_feeds:
        feeds += [feeder.feed(b) for b in reader()
                  if len(b) == batch_size][:n_feeds - len(feeds)]
    return feeds


def build_resnet50(batch_size, n_feeds):
    """resnet.get_model(data_set='imagenet', depth=50); returns as
    build_transformer."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import resnet
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, reader, _ = resnet.get_model(
            data_set='imagenet', depth=50, batch_size=batch_size)
    return (main, startup, [avg_cost],
            _flowers_feeds(main, reader, batch_size, n_feeds), batch_size,
            'images_per_s')


def build_mnist(batch_size, n_feeds):
    """mnist.get_model (LeNet, Adam 1e-3); returns as build_transformer."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import mnist
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, reader, _, _ = mnist.get_model(batch_size=batch_size)
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('pixel'), blk.var('label')],
                              fluid.CPUPlace(), program=main)
    epoch = [feeder.feed(b) for b in reader() if len(b) == batch_size]
    feeds = [epoch[i % len(epoch)] for i in range(n_feeds)]
    return main, startup, [avg_cost], feeds, batch_size, 'images_per_s'


def build_vgg16(batch_size, n_feeds):
    """vgg.get_model(batch_size) on its cifar10 reader; returns as
    build_transformer."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import vgg
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, reader, _, _ = vgg.get_model(batch_size=batch_size)
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('data'), blk.var('label')],
                              fluid.CPUPlace(), program=main)
    epoch = [feeder.feed(b) for b in reader() if len(b) == batch_size]
    feeds = [epoch[i % len(epoch)] for i in range(n_feeds)]
    return main, startup, [avg_cost], feeds, batch_size, 'images_per_s'


def build_se_resnext50(batch_size, n_feeds):
    """se_resnext.get_model(batch_size) on flowers batches; returns as
    build_transformer."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import se_resnext
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, reader, _, _ = se_resnext.get_model(
            batch_size=batch_size)
    return (main, startup, [avg_cost],
            _flowers_feeds(main, reader, batch_size, n_feeds), batch_size,
            'images_per_s')


def build_resnet50_amp(batch_size, n_feeds, layout='NHWC'):
    """ResNet-50 as the JAX bench.py builds it for AMP (chip_smoke.py's
    build_resnet_amp) on the flowers batches, bf16 from the DataFeeder;
    returns as build_transformer."""
    import torch  # noqa: F401
    sys.path.insert(0, HERE)
    import chip_smoke
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.dataset import flowers
    main, startup, avg_cost = chip_smoke.build_resnet_amp(layout)
    nchw = chip_smoke.build_resnet_amp('NCHW')[0]
    feeds = _flowers_feeds(nchw, batch(flowers.train(),
                                       batch_size=batch_size),
                           batch_size, n_feeds)
    if layout == 'NHWC':
        feeds = [dict(f, data=f['data'].permute(0, 2, 3, 1).contiguous())
                 for f in feeds]
    return main, startup, [avg_cost], feeds, batch_size, 'images_per_s'


def _sequence_feeds(main, reader, names, n_feeds):
    """n_feeds batches of one pass of a sequence model's reader through
    the DataFeeder (the shuffle seeded), all in the pass's most frequent
    time bucket, repeated in turn as needed."""
    import random
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lowering import SeqValue
    random.seed(SEED)
    feeder = fluid.DataFeeder(names, fluid.CPUPlace(), program=main)
    feeds = [feeder.feed(b) for b in reader()]
    buckets = [tuple(v.data.shape[1] for _, v in sorted(f.items())
                     if isinstance(v, SeqValue)) for f in feeds]
    common = max(set(buckets), key=buckets.count)
    same = [f for f, b in zip(feeds, buckets) if b == common]
    return [same[i % len(same)] for i in range(n_feeds)]


def _build_sequence(module, batch_size, n_feeds, names=None):
    from paddle_tpu_torch.fluid import framework, unique_name
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        out = module.get_model(batch_size=batch_size)
    avg_cost, reader = out[0], out[2]
    names = names or out[-1]
    return (main, startup, [avg_cost],
            _sequence_feeds(main, reader, names, n_feeds), batch_size,
            'sequences_per_s')


def build_stacked_lstm(batch_size, n_feeds):
    """stacked_dynamic_lstm.get_model(batch_size); returns as
    build_transformer."""
    from paddle_tpu_torch.models import stacked_dynamic_lstm
    return _build_sequence(stacked_dynamic_lstm, batch_size, n_feeds,
                           ['words', 'label'])


def build_sentiment(batch_size, n_feeds):
    from paddle_tpu_torch.models import understand_sentiment
    return _build_sequence(understand_sentiment, batch_size, n_feeds)


def build_mt(batch_size, n_feeds):
    from paddle_tpu_torch.models import machine_translation
    return _build_sequence(machine_translation, batch_size, n_feeds)


def build_word2vec(batch_size, n_feeds):
    from paddle_tpu_torch.models import word2vec
    out = _build_sequence(word2vec, batch_size, n_feeds)
    return out[:-1] + ('examples_per_s',)


def build_recommender(batch_size, n_feeds):
    """recommender_system.get_model(batch_size): its train reader is the
    fourth of get_model's results."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import recommender_system
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, _, reader, _, names = recommender_system.get_model(
            batch_size=batch_size)
    return (main, startup, [avg_cost],
            _sequence_feeds(main, reader, names, n_feeds), batch_size,
            'examples_per_s')


def build_srl(batch_size, n_feeds):
    """label_semantic_roles at the reference book's sizes, SGD under its
    staircase exponential decay."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import label_semantic_roles
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, reader, names = label_semantic_roles.get_model(
            word_dim=32, mark_dim=5, hidden_dim=512, depth=8,
            batch_size=batch_size)
        lr = fluid.layers.exponential_decay(0.01, 100000, 0.5,
                                            staircase=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return (main, startup, [avg_cost],
            _sequence_feeds(main, reader, names, n_feeds), batch_size,
            'sequences_per_s')


BUILDERS = {'transformer': (build_transformer, 16),
            'deepfm': (build_deepfm, 256),
            'resnet50': (build_resnet50, 32),
            'mnist': (build_mnist, 128),
            'vgg16': (build_vgg16, 32),
            'se_resnext50': (build_se_resnext50, 16),
            'stacked_lstm': (build_stacked_lstm, 32),
            'sentiment': (build_sentiment, 32),
            'mt': (build_mt, 16),
            'word2vec': (build_word2vec, 64),
            'recommender': (build_recommender, 256),
            'srl': (build_srl, 10),
            'moe_encoder': (build_moe_encoder, 16)}
SEQUENCE_MODELS = ('stacked_lstm', 'sentiment', 'mt', 'word2vec',
                   'recommender', 'srl')


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', choices=sorted(BUILDERS),
                    default='transformer')
    ap.add_argument('--batch', type=int, default=None,
                    help='default: 16 (transformer, se_resnext50, mt, '
                         'moe_encoder), '
                         '256 (deepfm, recommender), 32 (resnet50, vgg16, '
                         'stacked_lstm, sentiment), 128 (mnist), 64 '
                         '(word2vec), 10 (srl)')
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--amp', action='store_true',
                    help='under fluid.amp.decorate_program (transformer, '
                         'resnet50)')
    ap.add_argument('--layout', choices=('NHWC', 'NCHW'), default='NHWC',
                    help='resnet50 --amp: the tower\'s layout')
    ap.add_argument('--root', default=HERE,
                    help='the checkout whose paddle_tpu_torch is profiled '
                         '(default: this one), to time two commits with '
                         'the same tool')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_train_profile: needs a CUDA card')
    import paddle_tpu_torch
    from paddle_tpu_torch import fluid, ops
    build, default_batch = BUILDERS[args.model]
    batch = args.batch or default_batch
    if args.amp and args.model == 'resnet50':
        main_prog, startup, fetch, feeds, units, unit_name = \
            build_resnet50_amp(batch, args.steps + PROFILE_STEPS,
                               args.layout)
    else:
        main_prog, startup, fetch, feeds, units, unit_name = build(
            batch, args.steps + PROFILE_STEPS)
        if args.amp:
            fluid.amp.decorate_program(main_prog)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    if args.model == 'srl':
        from paddle_tpu_torch.models import label_semantic_roles
        label_semantic_roles.load_pretrained_embedding(scope=scope)
        range_rules(SRL_CLASSES)

    def run(feed):
        return exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)

    modes = [('run', run)]
    if hasattr(exe, 'step_artifact'):
        # a checkout with the step artifact: run() replays a captured
        # graph, debug_step is the eager walk
        art = exe.step_artifact(main_prog, feed=feeds[0], fetch_list=fetch,
                                scope=scope)
        state = {n: t.clone() for n, t in art.state_dict(scope).items()}
        gen = torch.Generator(device='cuda')

        if args.model in SEQUENCE_MODELS:
            # a sequence feed (SeqValue) goes to the card leaf by leaf
            from paddle_tpu_torch.fluid.lowering import map_value
        else:
            # dense feeds (a --root checkout may predate map_value)
            def map_value(fn, v):
                return fn(v)

        def eager(feed):
            dev = {n: map_value(lambda t: torch.as_tensor(t).cuda(), v)
                   for n, v in feed.items()}
            fetches = art.debug_step(state, dev, 0, generator=gen)[0]
            return [t.float().cpu().numpy() for t in fetches]

        modes = [('captured', run), ('eager', eager)]

    image = args.model in ('resnet50', 'mnist', 'vgg16', 'se_resnext50')
    r = dict(card=card_line(), root=os.path.dirname(os.path.dirname(
        os.path.abspath(paddle_tpu_torch.__file__))),
             model=args.model, batch=batch, steps=args.steps,
             amp=args.amp, layout=args.layout if args.amp and
             args.model == 'resnet50' else None,
             profiled_steps=PROFILE_STEPS)
    # every mode timed before any is traced: a trace leaves the
    # profiler's hooks behind
    for mode, step in modes:
        step_s, losses = [], []
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        torch.cuda.reset_peak_memory_stats()
        for feed in feeds[:args.steps]:
            t0 = time.perf_counter()
            out = step(feed)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(np.asarray(out[0]).reshape(())))
        launches = {n: (k.launches - before[n]) / args.steps
                    for n, k in ops.KERNELS.items()
                    if k.launches > before[n]}
        med = float(np.median(step_s[1:]))
        r[mode] = dict(step_s=step_s, median_step_s=med, losses=losses,
                       kernel_launches_per_step=launches,
                       peak_memory_gb=torch.cuda.max_memory_allocated()
                       / 1e9)
        r[mode][unit_name] = units / med
    for mode, step in modes:
        prof = profile_steps(step, feeds[args.steps:],
                             image=image and mode != 'captured',
                             rule_classes=SRL_CLASSES if args.model == 'srl'
                             and mode != 'captured' else None)
        r[mode].update(prof, device_idle_share_of_median_step=(
            1.0 - prof['device_busy_ms_per_step'] / 1e3
            / r[mode]['median_step_s']))
    if modes[0][0] == 'captured':
        r['cache_stats'] = exe.cache_stats
    if args.model == 'transformer':
        r['max_length'] = MAX_LENGTH
    print(json.dumps(r), flush=True)


if __name__ == '__main__':
    main()
