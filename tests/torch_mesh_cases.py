"""The data-parallel cases of tests/test_torch_parallel.py and
tests/test_torch_moe.py, written once for both packages.

Each case builds its program in either package (`pkg` 'jax' or 'port'),
makes its feeds from a seed, and runs a few steps in a MODE:

  single      the plain Executor on the whole batch (either package);
  pe          ParallelExecutor over the dp mesh;
  mesh        Program.set_mesh({'dp': N}) and the plain Executor;
  bundle      set_mesh and one run_bundle of every step;
  dist        DistributeTranspiler (slice_var_up: ZeRO accumulators);
  fsdp        DistributeTranspiler with shard_parameters (ZeRO-3);
  reduce      ParallelExecutor with BuildStrategy.Reduce (ZeRO-3).

The JAX package runs these modes on its virtual CPU mesh in the test
process; the port runs them on N gloo ranks spawned by `spawn_ranks`, each
starting from the JAX startup's weights, and every rank writes its results
with np.save. This module imports no JAX: the ranks import the port only.
"""
import importlib
import os
import pickle
import time
import traceback

import numpy as np

PKGS = {'jax': 'paddle_tpu', 'port': 'paddle_tpu_torch'}


def _mods(pkg):
    root = PKGS[pkg]
    fluid = importlib.import_module(root + '.fluid')
    return fluid, importlib.import_module(root + '.fluid.framework'), \
        importlib.import_module(root + '.fluid.unique_name')


# -- the nets -----------------------------------------------------------------

def _fc_net(fluid):
    """test_parallel.py:17-50's net."""
    x = fluid.layers.data(name='x', shape=[13], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    pred = fluid.layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(
        initializer=fluid.initializer.Constant(0.05)))
    cost = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    return cost, []


def _fc_feeds(pkg, steps):
    rng = np.random.RandomState(0)
    f = {'x': rng.rand(16, 13).astype('float32'),
         'y': rng.rand(16, 1).astype('float32')}
    return [f] * steps


def _annotated_net(fluid):
    """test_parallel.py:306-350's net: fc(32, relu) -> fc(1) -> mse, SGD."""
    x = fluid.layers.data(name='x', shape=[16], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    pa = fluid.ParamAttr(initializer=fluid.initializer.Constant(0.05))
    h = fluid.layers.fc(input=x, size=32, act='relu', param_attr=pa)
    pred = fluid.layers.fc(input=h, size=1)
    cost = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    return cost, [pred.name]


def _ab_feeds(pkg, steps):
    rng = np.random.RandomState(0)
    f = {'x': rng.rand(16, 16).astype('float32'),
         'y': rng.rand(16, 1).astype('float32')}
    return [f] * steps


def _zero_net(fluid):
    """fc(128, relu) -> fc(1), Adam: a weight of 2,048 elements, so ZeRO-3
    splits it (the floor is 1,024), and Adam moments for ZeRO-1/2."""
    x = fluid.layers.data(name='x', shape=[16], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    h = fluid.layers.fc(input=x, size=128, act='relu')
    pred = fluid.layers.fc(input=h, size=1)
    cost = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(cost)
    return cost, []


def _zero_feeds(pkg, steps):
    rng = np.random.RandomState(3)
    return [{'x': rng.rand(16, 16).astype('float32'),
             'y': rng.rand(16, 1).astype('float32')} for _ in range(steps)]


def _bn_net(fluid):
    """conv (no bias) -> batch_norm (relu) -> global pool -> fc softmax ->
    cross_entropy, Momentum: the batch statistics must be the global
    batch's."""
    img = fluid.layers.data(name='img', shape=[2, 6, 6], dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    c = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                            bias_attr=False)
    b = fluid.layers.batch_norm(input=c, act='relu')
    p = fluid.layers.pool2d(input=b, pool_type='avg', global_pooling=True)
    prob = fluid.layers.fc(input=p, size=3, act='softmax')
    cost = fluid.layers.mean(fluid.layers.cross_entropy(input=prob,
                                                        label=label))
    acc = fluid.layers.accuracy(input=prob, label=label)
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(cost)
    return cost, [acc.name, prob.name]


def _bn_feeds(pkg, steps):
    rng = np.random.RandomState(5)
    # each row's scale differs, so the shards' statistics differ
    return [{'img': (rng.randn(16, 2, 6, 6) * np.linspace(
        0.2, 3.0, 16)[:, None, None, None]).astype('float32'),
             'label': rng.randint(0, 3, (16, 1)).astype('int64')}
            for _ in range(steps)]


def _norms_net(fluid, pkg):
    """Ops that reduce a whole batch activation with no axis attr in the
    loss: squared_l2_norm (an op with no layer, appended as
    generate_layer_fn would), clip_by_norm and dice_loss. Each must see
    the global batch, as the JAX step's GSPMD reductions do."""
    LayerHelper = importlib.import_module(
        PKGS[pkg] + '.fluid.layer_helper').LayerHelper
    x = fluid.layers.data(name='x', shape=[16], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    h = fluid.layers.fc(input=x, size=8, act='relu')
    pred = fluid.layers.fc(input=h, size=1)
    mse = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    helper = LayerHelper('squared_l2_norm')
    sq = helper.create_variable_for_type_inference(dtype='float32')
    helper.append_op(type='squared_l2_norm', inputs={'X': [h]},
                     outputs={'Out': [sq]})
    clipped = fluid.layers.mean(fluid.layers.clip_by_norm(h, max_norm=1.0))
    dice = fluid.layers.dice_loss(fluid.layers.sigmoid(pred), y)
    cost = fluid.layers.sums([
        mse, fluid.layers.scale(sq, scale=0.01),
        fluid.layers.scale(clipped, scale=0.1),
        fluid.layers.scale(dice, scale=0.1)])
    fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    return cost, [sq.name, dice.name]


V, T = 60, 16
_TCFG = dict(n_layer=2, d_model=32, n_head=4, d_inner=64)


def _transformer_net(fluid, pkg):
    models = importlib.import_module(PKGS[pkg] + '.models.transformer')
    avg_cost, token_num, _ = models.transformer(
        V, V, T, _TCFG['n_layer'], _TCFG['d_model'], _TCFG['n_head'],
        _TCFG['d_inner'], dropout_rate=0.0)
    lr = fluid.layers.learning_rate_scheduler.noam_decay(_TCFG['d_model'],
                                                         100)
    lr = fluid.layers.scale(lr, scale=2.0)
    fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                         epsilon=1e-9).minimize(avg_cost)
    return avg_cost, [token_num.name]


def _transformer_feeds(pkg, steps):
    """Batches of 8 whose padding is spread unevenly over the shards: each
    batch sorted longest first, so rank 0 holds the long sentences and the
    last rank the short ones (the loss weighs tokens, not rows)."""
    from paddle_tpu_torch.dataset import wmt16
    from paddle_tpu_torch.models import transformer
    samples = list(wmt16.train(V, V)())
    out = []
    for s in range(steps):
        b = sorted(samples[s * 8:(s + 1) * 8], key=lambda r: -len(r[0]))
        # cut the short half shorter still
        b = [(r[0][:max(2, len(r[0]) // (1 + 2 * (i >= 4)))],
              r[1][:max(2, len(r[1]) // (1 + 2 * (i >= 4)))],
              r[2][:max(2, len(r[2]) // (1 + 2 * (i >= 4)))])
             for i, r in enumerate(b)]
        padded = transformer.pad_batch(b, T)
        feed = {n: np.stack([p[i] for p in padded])
                for i, n in enumerate(['src_word', 'trg_word', 'lbl_word'])}
        # the corpus starts every target with the pad id; give it a live
        # one (tests/test_torch_training.py:_feeds)
        feed['trg_word'][:, 0] = 2
        out.append(feed)
    return out


def _seq_net(fluid):
    words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                              lod_level=1)
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    emb = fluid.layers.embedding(input=words, size=[50, 8])
    conv = fluid.nets.sequence_conv_pool(input=emb, num_filters=8,
                                         filter_size=3, act='tanh',
                                         pool_type='sqrt')
    prob = fluid.layers.fc(input=conv, size=2, act='softmax')
    cost = fluid.layers.mean(fluid.layers.cross_entropy(input=prob,
                                                        label=label))
    fluid.optimizer.Adagrad(learning_rate=0.1).minimize(cost)
    return cost, [prob.name]


def _seq_feeds(pkg, steps):
    fluid = _mods(pkg)[0]
    rng = np.random.RandomState(7)
    out = []
    for _ in range(steps):
        lens = list(rng.randint(1, 13, size=8))
        ids = rng.randint(0, 50, size=(sum(lens), 1)).astype('int64')
        out.append({'words': fluid.create_lod_tensor(ids, [lens],
                                                     fluid.CPUPlace()),
                    'label': rng.randint(0, 2, (8, 1)).astype('int64')})
    return out


_DFM = dict(num_fields=6, vocab_size=200, embed_dim=4, hidden=[16, 16])


def _deepfm_net(fluid, pkg):
    models = importlib.import_module(PKGS[pkg] + '.models.deepfm')
    feat = fluid.layers.data(name='feat_ids', shape=[_DFM['num_fields']],
                             dtype='int64')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    avg_cost, prob, _ = models.deepfm(feat, label, is_sparse=True, **_DFM)
    auc = fluid.layers.auc(fluid.layers.concat(
        [fluid.layers.scale(prob, -1.0, 1.0), prob], axis=1), label)
    # Adagrad: its lazy (sparse) and dense updates agree, so the
    # single-device step (sparse rows) and the mesh step (the replicated
    # table's dense gradient) compute the same update
    fluid.optimizer.Adagrad(learning_rate=0.01).minimize(avg_cost)
    auc_out = auc[0] if isinstance(auc, (list, tuple)) else auc
    return avg_cost, [auc_out.name]


def _deepfm_feeds(pkg, steps):
    rng = np.random.RandomState(11)
    return [{'feat_ids': rng.randint(0, _DFM['vocab_size'],
                                     (16, _DFM['num_fields'])).astype('int64'),
             'label': rng.randint(0, 2, (16, 1)).astype('int64')}
            for _ in range(steps)]


# the MoE nets: x [16, 4, 16] tokens -> moe_mlp -> fc -> mse + 0.01 aux
def _moe_net(num_experts, top_k, capacity_factor):
    def net(fluid):
        x = fluid.layers.data(name='x', shape=[4, 16], dtype='float32')
        y = fluid.layers.data(name='y', shape=[4, 1], dtype='float32')
        h, aux = fluid.layers.moe_mlp(
            x, num_experts=num_experts, hidden_size=32, act='relu',
            capacity_factor=capacity_factor, top_k=top_k,
            return_aux_loss=True)
        pred = fluid.layers.fc(input=h, size=1, num_flatten_dims=2)
        mse = fluid.layers.mean(fluid.layers.square_error_cost(
            input=pred, label=y))
        cost = fluid.layers.elementwise_add(
            mse, fluid.layers.scale(aux, scale=0.01))
        # SGD: Adam's first steps turn float noise in a near-zero gradient
        # element into a full-size update, in either package
        fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
        return cost, [aux.name, h.name]
    return net


def _moe_feeds(pkg, steps):
    rng = np.random.RandomState(13)
    w = rng.randn(16, 1).astype('float32')
    out = []
    for _ in range(steps):
        x = rng.randn(16, 4, 16).astype('float32')
        out.append({'x': x, 'y': (x @ w).astype('float32')})
    return out


# name -> (net builder, feeds, steps, builder takes pkg)
CASES = {
    'fc': (_fc_net, _fc_feeds, 4, False),
    'annotated': (_annotated_net, _ab_feeds, 4, False),
    'zero': (_zero_net, _zero_feeds, 3, False),
    'bn': (_bn_net, _bn_feeds, 3, False),
    'transformer': (_transformer_net, _transformer_feeds, 3, True),
    'seq': (_seq_net, _seq_feeds, 3, False),
    'deepfm': (_deepfm_net, _deepfm_feeds, 3, True),
    'norms': (_norms_net, _zero_feeds, 3, True),
    # experts per rank 1 (E = dp) and 2, and E = 3, which no dp of 2 or 4
    # divides (the dense path on the global tokens); top 2
    'moe_e4': (_moe_net(4, 2, 2.0), _moe_feeds, 3, False),
    'moe_e8': (_moe_net(8, 1, 2.0), _moe_feeds, 3, False),
    'moe_e3': (_moe_net(3, 2, 2.0), _moe_feeds, 3, False),
    # overflow: capacity 0.5 drops tokens
    'moe_drop': (_moe_net(4, 2, 0.5), _moe_feeds, 3, False),
}


def build(pkg, case):
    """(main, startup, loss name, extra fetch names) of a case in pkg."""
    fluid, framework, unique_name = _mods(pkg)
    net, _, _, takes_pkg = CASES[case]
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        cost, extra = net(fluid, pkg) if takes_pkg else net(fluid)
    return main, startup, cost.name, extra


def feeds(pkg, case):
    _, feed_fn, steps, _ = CASES[case]
    return feed_fn(pkg, steps)


def _np(v):
    return np.array(np.asarray(v), copy=True)


def run(pkg, case, mode, n=1, init=None):
    """Run a case: {'fetches': [[loss, extras...] per step], 'params':
    {persistable: array}, 'init': the startup's values (when init is
    None)}. The port runs on the current process group (every rank calls
    this); `n` is the JAX mesh size."""
    fluid, framework, unique_name = _mods(pkg)
    if pkg == 'port':
        from paddle_tpu_torch import parallel
        n = parallel.process_count()
    main, startup, loss, extra = build(pkg, case)
    fetch = [loss] + extra
    steps = feeds(pkg, case)
    scope = fluid.Scope() if pkg == 'port' else \
        importlib.import_module('paddle_tpu.fluid.executor').Scope()
    place = fluid.CPUPlace()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place)
        exe.run(startup)
        out = {}
        if init is None:
            out['init'] = {k: np.array(np.asarray(v), copy=True)
                           for k, v in scope.vars.items() if v is not None}
        else:
            scope.load_numpy({k: v for k, v in init.items()
                              if k in scope.vars}, place) \
                if pkg == 'port' else scope.vars.update(init)
        fetches = []
        if mode in ('pe', 'reduce'):
            kw = {}
            if pkg == 'jax':
                kw['num_devices'] = n
            if mode == 'reduce':
                bs = fluid.BuildStrategy()
                bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
                kw['build_strategy'] = bs
            pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss,
                                        main_program=main, scope=scope, **kw)
            for f in steps:
                fetches.append([_np(v) for v in pe.run(fetch, feed=f)])
        else:
            if mode in ('mesh', 'bundle'):
                main.set_mesh({'dp': n})
            elif mode in ('dist', 'fsdp'):
                cfg = fluid.DistributeTranspilerConfig()
                cfg.shard_parameters = mode == 'fsdp'
                fluid.DistributeTranspiler(cfg).transpile(
                    trainer_id=0, trainers=n, program=main)
            if mode == 'bundle':
                outs = exe.run_bundle(main, feeds=steps, fetch_list=fetch)
                for j in range(len(steps)):
                    fetches.append([_np(o[j]) for o in outs])
            else:
                for f in steps:
                    fetches.append([_np(v) for v in exe.run(
                        main, feed=f, fetch_list=fetch)])
        if pkg == 'port':
            from paddle_tpu_torch import parallel
            state = parallel.full_state(main, scope) \
                if parallel.process_count() > 1 or mode != 'single' \
                else {v.name: scope.vars[v.name] for v in main.list_vars()
                      if v.persistable and v.name in scope.vars}
            params = {k: v.detach().cpu().numpy() for k, v in state.items()}
        else:
            params = {v.name: np.asarray(scope.vars[v.name])
                      for v in main.list_vars()
                      if v.persistable and v.name in scope.vars}
    out['fetches'] = fetches
    out['params'] = params
    return out


# -- the ranks ----------------------------------------------------------------

def _rank_main(rank, world, store_path, work, jobs):
    """One gloo rank: runs every job, then writes {job: result or
    ('error', message)} to <work>/rank<r>.pkl."""
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from paddle_tpu_torch import parallel
    parallel.init_distributed(num_processes=world, process_id=rank,
                              backend='gloo',
                              store=dist.FileStore(store_path, world))
    results = {}
    for job in jobs:
        fn = globals()[job[0]]
        try:
            results[tuple(job)] = ('ok', fn(work, *job[1:]))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            results[tuple(job)] = ('error', '%s: %s\n%s' % (
                type(e).__name__, e, traceback.format_exc()))
    with open(os.path.join(work, 'rank%d.pkl' % rank), 'wb') as fh:
        pickle.dump(results, fh)
    dist.barrier()
    dist.destroy_process_group()


def job_case(work, case, mode):
    with open(os.path.join(work, 'init_%s.pkl' % case), 'rb') as fh:
        init = pickle.load(fh)
    return run('port', case, mode, init=init)


def job_not_divisible(work):
    """A batch the data axis does not divide raises."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import parallel
    main, startup, loss, _ = build('port', 'annotated')
    main.set_mesh({'dp': parallel.process_count()})
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    try:
        exe.run(main, feed={'x': np.zeros((13, 16), 'float32'),
                            'y': np.zeros((13, 1), 'float32')},
                fetch_list=[loss], scope=scope)
    except ValueError as e:
        return str(e)
    return None


def job_local_sgd(work):
    """parallel.LocalSGD over 3 local steps and one sync
    (test_distribute.py:249-330's simulation), and sync_steps=1."""
    import torch
    from paddle_tpu_torch import parallel
    n = parallel.process_count()
    bl, d, lr = 4, 6, 0.1
    rng = np.random.RandomState(0)
    w0 = rng.rand(d).astype('float32')
    xs = rng.rand(3, n * bl, d).astype('float32')
    ys = rng.rand(3, n * bl).astype('float32')

    def step_fn(params, batch):
        x, y = batch
        w = params['w'].detach().requires_grad_()
        loss = ((x @ w - y) ** 2).mean()
        g, = torch.autograd.grad(loss, [w])
        return {'w': (w - lr * g).detach()}, loss.detach()

    mesh = parallel.make_mesh({'dp': n})
    ls = parallel.LocalSGD(step_fn, mesh, axis='dp', sync_steps=3)
    params = ls.replicate({'w': w0})
    for i in range(3):
        params, aux = ls.step(params, ls.shard_batch((xs[i], ys[i])))
    pre = params['w'].numpy().copy()
    synced = ls.collapse(params)['w']
    ls1 = parallel.LocalSGD(step_fn, mesh, axis='dp', sync_steps=1)
    p1 = ls1.replicate({'w': w0})
    for i in range(3):
        p1, _ = ls1.step(p1, ls1.shard_batch((xs[i], ys[i])))
        p1 = ls1.sync(p1)
    return {'pre': pre, 'synced': synced, 'sync1': p1['w'].numpy(),
            'aux_shape': tuple(aux.shape)}


def job_trainer(work):
    """Trainer(parallel=True) for one epoch of 4 batches of 16."""
    import paddle_tpu_torch.fluid as fluid
    return trainer_run(fluid, parallel=True)


def trainer_run(fluid, parallel):
    rng = np.random.RandomState(2)
    data = [(rng.rand(13).astype('float32'), rng.rand(1).astype('float32'))
            for _ in range(64)]

    def reader():
        for i in range(0, 64, 16):
            yield data[i:i + 16]

    def train_func():
        x = fluid.layers.data(name='x', shape=[13], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Constant(0.05)),
            bias_attr=fluid.ParamAttr(
                initializer=fluid.initializer.Constant(0.0)))
        return fluid.layers.mean(fluid.layers.square_error_cost(
            input=pred, label=y))

    losses = []

    def handler(ev):
        if isinstance(ev, fluid.EndStepEvent):
            losses.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))

    kw = {'parallel': True} if parallel else {}
    t = fluid.Trainer(train_func=train_func,
                      optimizer_func=lambda: fluid.optimizer.SGD(0.1),
                      place=fluid.CPUPlace(), **kw)
    t.train(num_epochs=1, event_handler=handler, reader=reader,
            feed_order=['x', 'y'])
    return losses


def spawn_ranks(work, world, jobs, timeout=120):
    """Run `jobs` on `world` spawned gloo ranks (a FileStore under `work`,
    no ports). Joins every rank within `timeout` seconds; on expiry kills
    the ranks and raises. Returns [per-rank results]."""
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    store = os.path.join(work, 'store')
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, work, jobs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        alive = [p for p in procs if p.is_alive()]
        if alive:
            raise TimeoutError('%d of %d ranks still running after %ds'
                               % (len(alive), world, timeout))
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError('ranks exited with %r' % bad)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(work, 'rank%d.pkl' % r), 'rb') as fh:
            out.append(pickle.load(fh))
    return out


def job_moe_case(work, case, mode):
    """A MoE case, counting the rule's calls of the mesh path
    (parallel.moe.moe_apply)."""
    from paddle_tpu_torch.fluid.ops_impl import moe_ops
    real, calls = moe_ops.moe_apply, [0]

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    moe_ops.moe_apply = counted
    try:
        out = job_case(work, case, mode)
    finally:
        moe_ops.moe_apply = real
    out['mesh_calls'] = calls[0]
    return out


def moe_apply_inputs(n_exp, top_k, cap_factor, seed):
    """Stacked expert weights, tokens and logits of the functional
    moe_apply cases (64 tokens of width 4, expert outputs of width 6)."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(n_exp, 4, 6) * 0.5).astype('float32')
    x = rng.randn(64, 4).astype('float32')
    logits = rng.randn(64, n_exp).astype('float32')
    return w, x, logits


def job_moe_apply(work, n_exp, top_k, cap_factor, seed):
    """parallel.moe_apply on this rank's 64/N tokens over a mesh whose
    axis is the world; returns this rank's outputs."""
    import torch
    from paddle_tpu_torch import parallel
    n = parallel.process_count()
    mesh = parallel.make_mesh({'ep': n})
    w, x, logits = moe_apply_inputs(n_exp, top_k, cap_factor, seed)
    r, b = mesh.coords['ep'], 64 // n
    out = parallel.moe_apply(
        lambda p, t: t @ p['w'], {'w': torch.from_numpy(w)},
        torch.from_numpy(x[r * b:(r + 1) * b]),
        torch.from_numpy(logits[r * b:(r + 1) * b]), mesh, axis='ep',
        capacity_factor=cap_factor, top_k=top_k)
    return out.numpy()


def job_helpers(work):
    """parallel's collectives (values and gradients) and its sharding
    helpers on this rank, as numpy."""
    import torch
    from paddle_tpu_torch import parallel
    n, r = parallel.process_count(), parallel.process_index()
    mesh = parallel.make_mesh({'dp': n})
    x = (torch.arange(8, dtype=torch.float32) + 10 * r).reshape(4, 2)
    out = {}
    for name, fn in (
            ('psum', lambda t: parallel.psum(t, 'dp')),
            ('all_gather', lambda t: parallel.all_gather(t, 'dp')),
            ('all_gather_stacked',
             lambda t: parallel.all_gather(t, 'dp', axis=1, tiled=False)),
            ('reduce_scatter', lambda t: parallel.reduce_scatter(
                t.repeat(n, 1), 'dp', mesh=mesh)),
            ('ppermute', lambda t: parallel.ppermute(
                t, 'dp', [(i, (i + 1) % n) for i in range(n)]))):
        t = x.clone().requires_grad_()
        y = fn(t)
        # a rank-dependent cotangent
        cot = torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape) * (r + 1)
        g, = torch.autograd.grad((y * cot).sum(), [t])
        out[name] = (y.detach().numpy(), g.numpy())
    w = np.arange(8 * 2048, dtype=np.float32).reshape(8, 2048)
    b = np.arange(6, dtype=np.float32)
    out['shard_batch'] = parallel.shard_batch(mesh, w).numpy()
    out['replicate'] = parallel.replicate(mesh, b).numpy()
    zero = parallel.shard_optimizer_states({'w': w, 'b': b}, mesh)
    fsdp = parallel.fsdp_shard_params({'w': w.T.copy(), 'b': b}, mesh)
    rules = parallel.shard_params_by_rules(
        {'fc.w': w, 'fc.b': b}, mesh, [(r'\.w$', parallel.P(None, 'dp'))])
    for tag, d in (('zero', zero), ('fsdp', fsdp), ('rules', rules)):
        for k, v in d.items():
            out['%s_%s' % (tag, k)] = (v.numpy(), tuple(v.sharding.spec))
    out['global_batch'] = isinstance(
        parallel.global_batch(parallel.data_sharding(mesh), w[:2]),
        parallel.LocalRows)
    return out


def job_bn_test_clone(work):
    """The bn case's for_test clone on the mesh after training."""
    with open(os.path.join(work, 'init_bn.pkl'), 'rb') as fh:
        init = pickle.load(fh)
    return bn_test_clone('port', init)


def bn_test_clone(pkg, init=None):
    """Train the bn case 3 steps, then run its for_test clone (batch norm
    from the running statistics) on the first batch; the port on the
    world's dp mesh, the JAX package on one device. Returns the
    probabilities."""
    fluid = _mods(pkg)[0]
    main, startup, loss, extra = build(pkg, 'bn')
    test = main.clone(for_test=True)
    scope = fluid.Scope() if pkg == 'port' else \
        importlib.import_module('paddle_tpu.fluid.executor').Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        if pkg == 'port':
            from paddle_tpu_torch import parallel
            n = parallel.process_count()
            main.set_mesh({'dp': n})
            test.set_mesh({'dp': n})
            scope.load_numpy({k: v for k, v in init.items()
                              if k in scope.vars}, fluid.CPUPlace())
        else:
            init = {k: np.array(np.asarray(v), copy=True)
                    for k, v in scope.vars.items() if v is not None}
        for f in feeds(pkg, 'bn'):
            exe.run(main, feed=f, fetch_list=[loss])
        out = exe.run(test, feed=feeds(pkg, 'bn')[0], fetch_list=[extra[1]])
    return np.array(np.asarray(out[0]), copy=True), init
