"""High-level Trainer API.

Parity: reference python/paddle/fluid/trainer.py (Trainer:169,
CheckpointConfig:100, the Begin/End Epoch/Step events, build_feed_var_list:608)
and the JAX package's fluid/trainer.py — the train_func/optimizer_func loop
used by every book chapter, on one card.

Checkpoint/resume keeps the reference's crash-recovery semantics: periodic
persistable snapshots + (epoch, step) trainer args, auto-resumed when a
Trainer is constructed over a checkpoint dir, cleaned on successful finish.
The serials are the JAX package's dense format (io.save_checkpoint), so a
run preempted in either package resumes in the other.

On the card every step is the executor's captured step
(fluid/step_artifact.py): the scope's persistables are the graph's static
tensors, updated in place by each replay. A checkpoint reads them on the
stream the steps run on, so it sees every step launched before it; a load
rebinds them, and the captured step copies the loaded values in before its
next replay.

train_stream is the JAX Trainer's online loop over an unbounded stream
with drifting ids (paddle_tpu_torch.streaming): raw ids translate to rows
of the fixed tables on the input stage, evicted rows are zeroed in place
at the step boundary, and a DeltaPublisher pushes the touched rows into
live serving replicas. The feed's shape never changes as the vocabulary
drifts, so on the card one captured step serves the whole stream. The
vocab rides every serial's meta in the JAX format.

parallel=True trains through ParallelExecutor (a dp mesh over the ranks
of the process group) and transpiler_fn(train_program) may annotate the
program (a DistributeTranspiler, set_mesh), whose mesh the test program
shares (fluid/mesh_step.py). Not ported yet, and raising
NotImplementedError when asked for (ROADMAP.md Queue A, "Parallel"):
heartbeat, and the sharded checkpoint format the JAX Trainer takes for
mesh-annotated programs (a serial here holds the ranks' values as the
scope holds them).
"""
import collections
import contextlib
import os
import re
import shutil
import signal
import threading
import time
import warnings

import numpy as np

from .. import obs
from . import core
from . import framework
from . import io
from . import optimizer as opt_module
from . import parallel_executor
from . import unique_name
from .data_feeder import DataFeeder
from .executor import Executor, FetchHandle, Scope, scope_guard
from .step_artifact import _feed_signature

__all__ = [
    'Trainer', 'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
    'EndStepEvent', 'CheckpointConfig',
]


class BeginEpochEvent(object):
    """reference trainer.py:40."""

    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent(object):
    """reference trainer.py:52."""

    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent(object):
    """reference trainer.py:64. Set self.fetch_metrics=False in the handler
    to skip fetching the train_func outputs this step."""

    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent(object):
    """reference trainer.py:83."""

    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig(object):
    """reference trainer.py:100, with every argument of the JAX
    CheckpointConfig. commit_timeout and async_save configure the sharded
    checkpoint format, which the port does not have yet: they are stored
    and, as on the JAX package's dense path, ignored.

    wallclock_interval_s: unbounded-stream cadence (Trainer.train_stream):
    ALSO checkpoint whenever this many seconds have passed since the last
    save, regardless of the step interval — an online trainer consuming a
    slow stream must bound recovery by wall clock, not step count.
    Epoch-based train() ignores it."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10, commit_timeout=60.0,
                 async_save=False, wallclock_interval_s=None):
        assert epoch_interval >= 1
        assert step_interval >= 1
        self.checkpoint_dir = (checkpoint_dir if checkpoint_dir is not None
                               else os.getcwd())
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.commit_timeout = float(commit_timeout)
        self.async_save = bool(async_save)
        self.wallclock_interval_s = (float(wallclock_interval_s)
                                     if wallclock_interval_s is not None
                                     else None)
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None


def check_and_get_place(place):
    """reference trainer.py:143. None means the card, CUDAPlace(0), and
    raises RuntimeError where there is none: pass CPUPlace() to run on the
    CPU (the JAX package falls back to its CPU there; the port does not)."""
    if place is None:
        place = core.CUDAPlace(0)
        place.torch_device()   # raises without a card
    return place


def build_feed_var_list(program, feed_order=None):
    """reference trainer.py:608; feed_order None follows the program's
    data-var definition order."""
    if not isinstance(program, framework.Program):
        raise TypeError("The 'program' should be an object of Program")
    block = program.global_block()
    if feed_order is None:
        return [v for v in block.vars.values()
                if getattr(v, 'is_data', False)]
    if isinstance(feed_order, list):
        return [block.var(name) for name in feed_order]
    if not isinstance(feed_order, dict):
        raise TypeError("The 'feed_order' should be either None, list or dict.")
    if sorted(feed_order.values()) != list(range(len(feed_order))):
        raise ValueError("The values of 'feed_order' should be a permutation "
                         "of [0, len(feed_order))")
    return [block.var(name)
            for name, _ in sorted(feed_order.items(), key=lambda kv: kv[1])]


def _not_ported(what, item):
    raise NotImplementedError(
        '%s waits for the port\'s "%s" slice (ROADMAP.md Queue A)'
        % (what, item))


class Trainer(object):
    """reference trainer.py:169.

    Hot-loop pipelining, as in the JAX Trainer:
      bundle_steps=K (K>1) runs K reader batches per Executor.run_bundle
      call (K replays of the captured step, one host round trip).
      Begin/EndStepEvents still fire per step (End events carry that
      step's own metrics sliced from the bundle); BeginStepEvent.
      fetch_metrics is honored per BUNDLE (the first step's decision).
      Periodic checkpoints are taken at bundle boundaries when any step of
      the bundle crossed a step_interval mark, for the bundle's last step.
      sync='async' (unbundled) fetches metrics as lazy FetchHandles and
      keeps up to `async_window` steps in flight.
      double_buffer=True runs the DataFeeder assembly, and for unbundled
      loops the feed's coercion into pinned host memory
      (Executor._place_feed), of batch N+1 on a prefetch thread while step
      N runs; the copy to the card stays in the step. Values are bitwise
      the synchronous path's."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None,
                 transpiler_fn=None, bundle_steps=1, sync='auto',
                 async_window=2, heartbeat=None, double_buffer=False):
        if bundle_steps < 1:
            raise ValueError('bundle_steps must be >= 1, got %r'
                             % (bundle_steps,))
        if sync not in ('auto', 'block', 'async'):
            raise ValueError("sync must be 'auto', 'block' or 'async', "
                             "got %r" % (sync,))
        if parallel and (bundle_steps > 1 or sync == 'async'):
            raise ValueError(
                'bundle_steps/sync="async" pipeline the single-program '
                'Executor hot loop; parallel=True (ParallelExecutor) '
                'does not compose with them — express dp via '
                'transpiler_fn instead')
        if bundle_steps > 1 and sync == 'async':
            raise ValueError(
                'bundle_steps=%d already amortizes the host round-trip '
                'over the bundle, and the bundled loop slices per-step '
                'metrics for its EndStepEvents (a blocking read); '
                "sync='async' applies to the unbundled loop — pick one"
                % bundle_steps)
        if heartbeat is not None:
            _not_ported('Trainer(heartbeat=)', 'Parallel')
        self.bundle_steps = int(bundle_steps)
        self.sync = sync
        self.async_window = max(1, int(async_window))
        self.double_buffer = bool(double_buffer)
        # input-overlap accounting: total seconds the train loop WAITED
        # for its next fed batch, and the batches counted
        self.input_stage_s = 0.0
        self.batches_fed = 0
        self.__stop = False
        # preemption (SIGTERM/SIGINT while train() runs): the handler only
        # sets _preempt_requested; the loop finishes the in-flight step,
        # flushes an emergency checkpoint, and returns cleanly with
        # self.preempted = True. A fresh Trainer over the same checkpoint
        # dir resumes at the exact next step.
        self._preempt_requested = False
        self._preempt_signum = None
        self.preempted = False
        self.trainer_id = 0
        self._steps_run = 0
        # train_stream's vocabs while it runs (folded into every serial's
        # meta), the vocab state a resumed serial carried (applied once,
        # by the next train_stream) and the artifact its touched rows are
        # read from
        self._stream_vocabs = None
        self._stream_resume_vocab = None
        self._stream_art = None
        self._stream_art_key = None
        self.checkpoint_cfg = checkpoint_config
        if self.checkpoint_cfg:
            assert isinstance(self.checkpoint_cfg, CheckpointConfig)
        self.parallel = parallel
        self.parallel_executor = None

        self.scope = Scope()
        self.startup_program = framework.Program()
        self.train_program = framework.Program()

        with self._prog_and_scope_guard():
            with unique_name.guard():
                outs = train_func()
                self.train_func_outputs = (outs if isinstance(outs, list)
                                           else [outs])
                self.test_program = self.train_program.clone(for_test=True)
                loss = self.train_func_outputs[0]
                optimizer = optimizer_func()
                if not isinstance(optimizer, opt_module.Optimizer):
                    raise TypeError(
                        "The optimizer should be an instance of Optimizer")
                optimizer.minimize(loss)
                if transpiler_fn is not None:
                    self._apply_transpiler(transpiler_fn)

        self.place = check_and_get_place(place)
        self.exe = Executor(self.place)
        with self._prog_and_scope_guard():
            self.exe.run(self.startup_program)

        self._serial = 0
        if self.checkpoint_cfg:
            self._maybe_resume_from_checkpoint()

        if param_path and os.path.isdir(param_path):
            with self._prog_and_scope_guard():
                io.load_params(self.exe, param_path,
                               main_program=self.train_program)

    def _apply_transpiler(self, transpiler_fn):
        """transpiler_fn(train_program) (the JAX :254-281); the test
        program, cloned before it ran, takes the same mesh."""
        if self.parallel:
            raise ValueError(
                'parallel=True builds its own dp-only mesh and '
                'would silently drop the transpiler_fn '
                'annotations; compose dp via '
                'fluid.DistributeTranspiler inside '
                'transpiler_fn instead')
        transpiler_fn(self.train_program)
        dc = getattr(self.train_program, '_dist_config', None)
        if dc is not None:
            self.test_program._dist_config = dict(dc)
        ma = self.train_program._mesh_axes
        if ma is not None and self.test_program._mesh_axes is None:
            self.test_program.set_mesh(
                list(ma), data_axis=self.train_program._mesh_data_axis)

    def _get_or_create_parallel_executor(self):
        """The ParallelExecutor of parallel=True (the JAX :1135): on the
        Trainer's place, over the world's ranks."""
        if self.parallel_executor is None:
            self.parallel_executor = parallel_executor.ParallelExecutor(
                use_cuda=isinstance(self.place, core.CUDAPlace),
                loss_name=self.train_func_outputs[0].name,
                main_program=self.train_program, scope=self.scope)
        return self.parallel_executor

    # -- checkpoint/resume ------------------------------------------------

    def _maybe_resume_from_checkpoint(self):
        cfg = self.checkpoint_cfg
        if not os.path.isdir(cfg.checkpoint_dir):
            return
        # Newest first; a serial with a torn meta.json / missing or
        # CRC-mismatched params file (crash mid-save, bit rot) falls back
        # to the previous intact one — LOUDLY, because silently replaying
        # steps from an older snapshot is a surprise worth explaining.
        for serial in io.list_checkpoint_serials(cfg.checkpoint_dir)[::-1]:
            try:
                with self._prog_and_scope_guard():
                    with obs.span('trainer.checkpoint.load', serial=serial):
                        meta = io.load_checkpoint(
                            self.exe, cfg.checkpoint_dir, serial=serial,
                            main_program=self.train_program)
            except (RuntimeError, OSError, ValueError, KeyError) as e:
                obs.counter('trainer.resume.fallbacks').inc()
                obs.event('trainer.resume.fallback', serial=serial,
                          error='%s: %s' % (type(e).__name__, e))
                warnings.warn(
                    'checkpoint serial %d in %r failed to load (%s) — '
                    'falling back to the previous serial'
                    % (serial, cfg.checkpoint_dir, e), RuntimeWarning)
                continue
            args = meta.get('trainer_args') or {}
            cfg.load_serial = meta.get('step', 0)
            cfg.epoch_id = int(args.get('epoch_id', 0))
            cfg.step_id = int(args.get('step_id', 0))
            self._serial = int(meta.get('step', 0))
            self._stream_resume_vocab = args.get('streaming_vocab')
            return

    def _vocab_meta(self):
        """JSON-able {feed name: VocabTable.state_dict()} of the active
        streaming vocabs (None outside train_stream) — folded into every
        checkpoint's meta so exact-step resume holds under vocab drift:
        the restored map reproduces the id->row assignment the restored
        table rows were trained under (the JAX :524)."""
        if not self._stream_vocabs:
            return None
        return {str(k): vt.state_dict()
                for k, vt in self._stream_vocabs.items()}

    def _write_serial(self, epoch_id, step_id, **extra):
        """One dense serial of the scope's persistables, recording the
        (epoch, step) the scope holds, and under train_stream the vocab
        (`streaming_vocab`, as the JAX Trainer writes it). Returns its
        directory."""
        cfg = self.checkpoint_cfg
        args = {'epoch_id': epoch_id, 'step_id': step_id}
        args.update(extra)
        vm = self._vocab_meta()
        if vm is not None:
            args['streaming_vocab'] = vm
        with self._prog_and_scope_guard():
            return io.save_checkpoint(
                self.exe, cfg.checkpoint_dir, trainer_id=self.trainer_id,
                main_program=self.train_program, step=self._serial,
                trainer_args=args,
                max_num_checkpoints=cfg.max_num_checkpoints)

    def _save_checkpoint(self, epoch_id, step_id, force=False):
        """force=True skips the interval modulo gate — the bundled loop
        applies its own range-crossing gate (a bundle boundary rarely
        lands exactly ON an interval multiple) and records the bundle's
        LAST step, the state the scope actually holds."""
        cfg = self.checkpoint_cfg
        if force or (epoch_id % cfg.epoch_interval == 0
                     and step_id % cfg.step_interval == 0):
            self._serial += 1
            with obs.span('trainer.checkpoint.save', serial=self._serial,
                          epoch=epoch_id, step=step_id):
                self._write_serial(epoch_id, step_id)

    def _save_emergency_checkpoint(self, epoch_id, step_id):
        """Preemption flush: unconditional (interval-ignoring) snapshot
        recording the exact (epoch, step) just completed, so a successor
        Trainer resumes at step_id + 1; its meta's trainer_args say
        preempted: true."""
        if not self.checkpoint_cfg:
            return None
        self._serial += 1
        with obs.span('trainer.checkpoint.emergency_flush',
                      serial=self._serial, epoch=epoch_id, step=step_id):
            return self._write_serial(epoch_id, step_id, preempted=True)

    # -- preemption -------------------------------------------------------

    def _on_preempt_signal(self, signum, frame):
        # absolutely minimal: flag only. The loop (not the signal frame)
        # owns checkpointing — no torch or CUDA call runs here.
        self._preempt_requested = True
        self._preempt_signum = signum

    @contextlib.contextmanager
    def _preemption_handlers(self):
        """Install SIGTERM/SIGINT handlers for the duration of train(),
        restoring the previous handlers after. Signals can only be bound
        from the main thread; elsewhere (tests driving trainers from
        worker threads) preemption still works via request_preemption()."""
        installed = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    installed[sig] = signal.signal(
                        sig, self._on_preempt_signal)
                except (ValueError, OSError):
                    pass
        try:
            yield
        finally:
            for sig, prev in installed.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass

    def request_preemption(self):
        """Programmatic preemption (what the SIGTERM handler does): finish
        the in-flight step, flush an emergency checkpoint, return from
        train() cleanly with self.preempted = True."""
        self._preempt_requested = True

    def _finish_preemption(self, last_done):
        """Flush the emergency checkpoint for the last COMPLETED step (if
        any completed this run — otherwise prior checkpoints already
        reflect the state) and mark the trainer preempted."""
        cfg = self.checkpoint_cfg
        saved = False
        if last_done is not None and cfg:
            self._save_emergency_checkpoint(*last_done)
            saved = True
        self.preempted = True
        obs.counter('trainer.preemptions').inc()
        obs.event('trainer.preempted',
                  signum=self._preempt_signum or 'requested',
                  epoch=last_done[0] if last_done else None,
                  step=last_done[1] if last_done else None,
                  emergency_checkpoint=saved)
        where = ('at epoch %d step %d' % last_done if last_done is not None
                 else 'before any step completed')
        if saved:
            detail = 'emergency checkpoint flushed'
        elif cfg:
            detail = ('no emergency checkpoint needed (prior serials '
                      'already reflect the state)')
        else:
            detail = ('emergency checkpoint SKIPPED (no CheckpointConfig '
                      '— progress is lost)')
        warnings.warn(
            'preemption (%s) %s: %s; train() returning cleanly'
            % (self._preempt_signum or 'requested', where, detail),
            RuntimeWarning)

    def _clean_checkpoint(self):
        # Remove only the serial subdirs we created (checkpoint_<n>): the
        # configured dir may be (and defaults to) the user's cwd.
        d = self.checkpoint_cfg.checkpoint_dir
        if not os.path.isdir(d):
            return
        for sub in os.listdir(d):
            if re.fullmatch(r'checkpoint_\d+', sub):
                shutil.rmtree(os.path.join(d, sub), ignore_errors=True)

    # -- public API -------------------------------------------------------

    def stop(self):
        """reference trainer.py:373 — stop training at the next step."""
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        """reference trainer.py:379. While the loop runs, SIGTERM/SIGINT
        mean PREEMPTION, not crash: the in-flight step completes, an
        emergency checkpoint flushes, and train() returns cleanly with
        self.preempted = True (resume by constructing a new Trainer over
        the same checkpoint dir)."""
        self.preempted = False
        self._preempt_requested = False
        with self._preemption_handlers():
            exe = self.exe
            if self.parallel:
                with self._prog_and_scope_guard():
                    exe = self._get_or_create_parallel_executor()
            self._train_loop(exe, num_epochs, event_handler, reader,
                             feed_order)

    def train_stream(self, reader, event_handler=None, feed_order=None,
                     vocabs=None, publisher=None, max_steps=None):
        """Online training over an UNBOUNDED stream (the JAX :803).
        `reader` is an ordinary batch-reader factory with NO epoch length:
        the loop runs until the stream ends, `stop()` is called,
        `max_steps` batches have run this call, or preemption lands
        (emergency checkpoint + clean return, exactly like train()).

        vocabs: {id feed name: streaming.VocabTable} — each named feed
        is translated raw-id -> row on the input stage (the prefetch
        worker when double_buffer=True), rows referenced by the in-flight
        batch are pinned until its step completes, and evicted rows are
        zeroed (table + optimizer moments, streaming.RowResetter: in
        place, on the stream the steps run on) at the step boundary
        BEFORE their new owner trains. Translation is pure host-side
        indexing: the step's signature never changes as the vocab
        drifts (on the card one capture serves the whole stream), and
        with an identity map the trained state is bitwise the
        un-streamed loop's. The vocab serializes into every checkpoint's
        meta and a resumed Trainer restores it here, once. A tiered
        vocab (embedding.TieredVocabTable) owns its boundary instead:
        evictions SPILL the rows to its host arena and warm re-admissions
        RESTORE them, in place in the same tensors, and the rows it
        changed reach the publisher; its arena recycles released slots
        after each committed checkpoint.

        publisher: a streaming.DeltaPublisher — after each step the
        touched-row set (StepArtifact.touched_rows: host-side, off the
        step path) is collected, and the publisher's cadence pushes
        those rows' live values into the serving replicas
        (Router.push_deltas). Publisher failures are warned and retried
        next cadence — freshness degrades, training never dies for a
        serving-side hiccup.

        Checkpoints follow CheckpointConfig's step_interval AND
        wallclock_interval_s (whichever fires first); epoch_id is
        recorded as 0 and serials are NOT cleaned on return — a stream
        has no "finished" state, the next Trainer resumes. There is no
        reader fast-forward on resume: a live stream is not replayable;
        the restored (vocab, table, moments) state carries the
        continuity. Returns the number of steps run this call.

        As in the JAX Trainer, bundle_steps > 1, sync='async' and
        parallel=True are refused."""
        if self.parallel:
            raise ValueError('train_stream drives the single-program '
                             'Executor loop; parallel=True does not '
                             'compose with it (use GSPMD annotations)')
        if self.bundle_steps > 1 or self.sync == 'async':
            raise ValueError(
                'train_stream paces checkpoints, vocab leases, and '
                'delta publishing per STEP; bundle_steps>1 / '
                "sync='async' pipeline across steps — pick one "
                '(double_buffer=True overlaps the input side instead)')
        from ..streaming.vocab import RowResetter, table_state_names
        if event_handler is None:
            event_handler = lambda ev: None  # noqa: E731
        vocabs = dict(vocabs or {})
        self._stream_vocabs = vocabs
        cfg = self.checkpoint_cfg
        resumed = bool(cfg and cfg.load_serial)
        if vocabs and resumed and self._stream_resume_vocab:
            for fname, state in self._stream_resume_vocab.items():
                if fname in vocabs:
                    vocabs[fname].load_state_dict(state)
            # one-shot: a SECOND train_stream() call on this Trainer
            # continues the LIVE (drifted) vocab — re-applying the
            # checkpoint-time map would silently mis-map ids to rows
            self._stream_resume_vocab = None
        resetter = RowResetter()
        reset_names = {}
        for fname, vt in vocabs.items():
            if vt.table:
                reset_names[fname] = table_state_names(
                    self.train_program, vt.table)
                if hasattr(vt, 'validate_program'):
                    # tiered tables refuse a dim-sharded table TYPED
                    # (a spill would tear rows across hosts) — before
                    # any step runs, not on the first eviction
                    vt.validate_program(self.train_program)

        leases = {}   # step_id -> [Lease] (writer: input stage;
        #               reader: the loop after that step completes)

        def translate(step_id, fed):
            ls = []
            for fname, vt in vocabs.items():
                v = fed.get(fname)
                if v is None:
                    continue
                if not hasattr(v, 'dtype'):
                    raise TypeError(
                        'train_stream vocab feed %r is not a dense '
                        'array (got %r) — streaming ids are dense id '
                        'batches' % (fname, type(v).__name__))
                mapped, lease = vt.translate(v)
                fed[fname] = mapped.astype(v.dtype, copy=False)
                ls.append(lease)
            if ls:
                leases[step_id] = ls
            return fed

        def apply_resets():
            # zero evicted rows (table + moments) BEFORE the step that
            # trains their new owners — stale moments would bleed the
            # previous occupant's history into the new id. In place, under
            # the executor's lock and on the stream the steps run on: on
            # the card these are the captured step's static tensors.
            # A tiered table owns its boundary instead (spill and
            # restore, in place too) and reports the rows it mutated so
            # the delta publisher keeps serving replicas converged across
            # a spill/restore cycle.
            changed = None
            for fname, vt in vocabs.items():
                names = reset_names.get(fname)
                if not names:
                    continue
                if hasattr(vt, 'apply_step_boundary'):
                    ch = vt.apply_step_boundary(
                        self.scope._chain_get, self.scope._chain_set,
                        names, lock=self.exe._lock)
                    if ch:
                        changed = changed or {}
                        for t, rows in ch.items():
                            prev = changed.get(t)
                            if prev is None:
                                changed[t] = rows
                            else:
                                changed[t] = sorted(
                                    {int(r) for r in prev}
                                    | {int(r) for r in rows})
                    continue
                rows = vt.drain_resets()
                if rows:
                    resetter.reset([self.scope._chain_get(n)
                                    for n in names], rows,
                                   lock=self.exe._lock)
            return changed

        steps_run = 0
        self.preempted = False
        self._preempt_requested = False
        last_done = None
        last_ckpt_t = time.monotonic()
        start_step = cfg.step_id + 1 if resumed else 0
        warned_dense = set()
        it = None
        try:
            with self._preemption_handlers():
                with self._prog_and_scope_guard():
                    feed_vars = build_feed_var_list(self.train_program,
                                                    feed_order)
                    feeder = DataFeeder(feed_list=feed_vars,
                                        place=self.place,
                                        program=self.train_program)
                    fetch = [v.name for v in self.train_func_outputs]
                    it = self._iter_staged(reader, feeder, post=translate)
                    for rel_id, fed in it:
                        step_id = start_step + rel_id
                        if self.__stop or (max_steps is not None
                                           and steps_run >= max_steps):
                            return steps_run
                        if self._preempt_requested:
                            self._finish_preemption(last_done)
                            return steps_run
                        tier_changed = apply_resets()
                        begin = BeginStepEvent(0, step_id)
                        event_handler(begin)
                        want = fetch if begin.fetch_metrics else []
                        self._steps_run += 1
                        with obs.span('trainer.step',
                                      step_num=self._steps_run,
                                      epoch=0, step=step_id, stream=True):
                            metrics = self.exe.run(
                                program=self.train_program, feed=fed,
                                fetch_list=want)
                        last_done = (0, step_id)
                        steps_run += 1
                        # the step is on the stream: a row evicted after
                        # this release is zeroed behind it there
                        for lease in leases.pop(rel_id, []):
                            lease.release()
                        if publisher is not None:
                            self._stream_publish(publisher, fed, want,
                                                 warned_dense, vocabs,
                                                 extra_rows=tier_changed)
                        if cfg:
                            due = (step_id > 0 and step_id
                                   % cfg.step_interval == 0)
                            wall = cfg.wallclock_interval_s
                            if not due and wall is not None:
                                due = (time.monotonic() - last_ckpt_t
                                       >= wall)
                            if due:
                                self._save_checkpoint(0, step_id,
                                                      force=True)
                                last_ckpt_t = time.monotonic()
                                for vt in vocabs.values():
                                    if hasattr(vt, 'mark_checkpoint'):
                                        # a committed serial no longer
                                        # references slots released
                                        # before it: recycle the
                                        # arena's limbo list
                                        vt.mark_checkpoint()
                        event_handler(EndStepEvent(0, step_id, metrics))
                        if self._preempt_requested:
                            self._finish_preemption(last_done)
                            return steps_run
                    return steps_run
        finally:
            if it is not None:
                it.close()   # unblock the prefetch worker on early exit
            for ls in leases.values():
                for lease in ls:
                    lease.release()
            leases.clear()
            self._stream_vocabs = None
            self._stream_art = None

    def _stream_publish(self, publisher, fed, fetch, warned_dense, vocabs,
                        extra_rows=None):
        """Collect this step's touched rows (host-side seam) and run the
        publisher's cadence (the JAX :1031). `extra_rows` ({table: rows})
        carries rows the TIER boundary mutated outside the batch — zeroed
        on spill, scattered on restore — so serving replicas converge on
        them too. Serving-side failures warn and retry next cadence."""
        # resolve the artifact ONCE per fetch set, not per step: the
        # sparse plan does not depend on the batch, and _prepare would
        # coerce the whole feed again just to read metadata
        art = self._stream_art
        if art is None or self._stream_art_key != tuple(fetch):
            try:
                art = self.exe.step_artifact(self.train_program, fed,
                                             fetch, scope=self.scope)
            except Exception as e:
                warnings.warn('train_stream: could not resolve the step '
                              'artifact for touched-row collection '
                              '(%s: %s)' % (type(e).__name__, e),
                              RuntimeWarning)
                return
            self._stream_art = art
            self._stream_art_key = tuple(fetch)
        for fname, vt in vocabs.items():
            t = vt.table
            if t and t not in art.sparse_plan and t not in warned_dense:
                warned_dense.add(t)
                warnings.warn(
                    'train_stream: table %r (vocab feed %r) is NOT on '
                    'the sparse update path — its update writes every '
                    'row each step, so touched-row deltas under-report '
                    'and row eviction is unsafe. Build the lookup with '
                    'is_sparse=True' % (t, fname), RuntimeWarning)
        touched = art.touched_rows(fed)
        if extra_rows:
            touched = dict(touched or {})
            for t, rows in extra_rows.items():
                merged = {int(r) for r in rows}
                prev = touched.get(t)
                if prev is not None:
                    merged.update(
                        int(r) for r in np.asarray(prev).reshape(-1))
                touched[t] = np.asarray(sorted(merged), np.int64)
        if touched:
            publisher.collect(touched)
        try:
            publisher.maybe_publish(lambda name: self.scope._chain_get(name))
        except Exception as e:
            obs.counter('streaming.push_failures').inc()
            warnings.warn(
                'train_stream: delta push failed (%s: %s) — deltas are '
                'retained and retried at the next cadence'
                % (type(e).__name__, e), RuntimeWarning)

    def test(self, reader, feed_order=None):
        """reference trainer.py:409 — mean of train_func outputs over the
        test reader, on the for_test clone."""
        with scope_guard(self.scope):
            feed_vars = build_feed_var_list(self.test_program, feed_order)
            feeder = DataFeeder(feed_list=feed_vars, place=self.place,
                                program=self.test_program)
            fetch = [v.name for v in self.train_func_outputs]
            accumulated = [0.0] * len(fetch)
            count = 0
            for data in reader():
                outs = self.exe.run(program=self.test_program,
                                    feed=feeder.feed(data), fetch_list=fetch)
                accumulated = [a + float(np.asarray(o).reshape(-1)[0])
                               for a, o in zip(accumulated, outs)]
                count += 1
            return [a / max(count, 1) for a in accumulated]

    def save_params(self, param_path):
        """reference trainer.py:421."""
        with self._prog_and_scope_guard():
            io.save_params(self.exe, dirname=param_path,
                           main_program=self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        """Persist the pruned inference graph + params (reference
        trainer.py save_inference_model variant)."""
        with self._prog_and_scope_guard():
            io.save_inference_model(
                param_path, feeded_var_names,
                [self.train_func_outputs[i] for i in target_var_indexes],
                self.exe, main_program=self.train_program)

    # -- internals --------------------------------------------------------

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with framework.program_guard(main_program=self.train_program,
                                     startup_program=self.startup_program):
            with scope_guard(self.scope):
                yield

    def _bundle_feed_sig(self, fed):
        """Shape/dtype signature of one fed batch after the executor's
        coercion — bundles may only group batches that share it (one
        captured step)."""
        vals = self.exe._feed_values(self.train_program, fed)
        return tuple(sorted(_feed_signature(n, v) for n, v in vals.items()))

    @staticmethod
    def _drain_async_window(window, n_keep=0):
        """Sync the oldest in-flight steps until at most n_keep remain.
        Each block records executor.host_stall."""
        while len(window) > n_keep:
            for h in window.popleft():
                if isinstance(h, FetchHandle):
                    h.block()

    def _iter_staged(self, reader, feeder, skip_until=-1, post=None):
        """Yield (step_id, fed_batch) for one epoch's reader pass.

        double_buffer=False: the DataFeeder assembly runs inline, timed as
        a `trainer.input_stage` span.

        double_buffer=True: assembly — and, for unbundled loops, the
        feed's coercion into pinned host memory (Executor._place_feed) —
        runs on a reader.pipeline.prefetch worker thread, staging batch
        N+1 while step N runs. The span then measures only the time the
        loop BLOCKED on the queue. The worker never touches the card: the
        copy to the card stays in the step, under the executor's lock on
        the stream the step runs on, so staging cannot race a capture or
        a replay's feed buffers. Bundled loops keep host arrays
        (run_bundle stacks them in one copy per name).

        skip_until: last step id already completed before a crash
        (resume fast-forward) — those reader items are consumed and
        yielded as (step_id, None) WITHOUT feed assembly or
        input_stage accounting.

        post(step_id, fed) -> fed: per-batch feed rewrite hook, run on the
        SAME thread as the assembly (the prefetch worker when
        double-buffered, before staging), as in the JAX Trainer, where the
        streaming-ids loop translates raw ids through it."""

        def record(step_id, dt, staged):
            obs.span_record('trainer.input_stage', dt, step=step_id,
                            staged=staged)
            self.input_stage_s += dt
            self.batches_fed += 1

        if not self.double_buffer:
            def plain():
                for step_id, data in enumerate(reader()):
                    if step_id <= skip_until:
                        yield step_id, None
                        continue
                    t0 = time.perf_counter()
                    fed = feeder.feed(data)
                    if post is not None:
                        fed = post(step_id, fed)
                    record(step_id, time.perf_counter() - t0, False)
                    yield step_id, fed
            return plain()

        from ..reader import pipeline as rpipe
        exe, prog = self.exe, self.train_program
        # a mesh program's feed is cut to the rank's rows in the step
        place_in_worker = (not self.parallel and self.bundle_steps == 1
                           and getattr(prog, '_dist_config', None) is None
                           and prog._mesh_axes is None)

        def tagged():
            return enumerate(reader())

        def stage(pair):
            step_id, data = pair
            if step_id <= skip_until:
                return step_id, None
            fed = feeder.feed(data)
            if post is not None:
                fed = post(step_id, fed)
            if place_in_worker:
                fed = exe._place_feed(prog, fed)
            return step_id, fed

        staged = rpipe.prefetch(tagged, depth=2, transform=stage)

        def overlapped():
            it = staged()
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        step_id, fed = next(it)
                    except StopIteration:
                        return
                    if fed is not None:
                        record(step_id, time.perf_counter() - t0, True)
                    yield step_id, fed
            finally:
                it.close()   # unblock the prefetch worker on early exit

        return overlapped()

    def _train_loop(self, exe, num_epochs, event_handler, reader, feed_order):
        with self._prog_and_scope_guard():
            feed_vars = build_feed_var_list(self.train_program, feed_order)
            feeder = DataFeeder(feed_list=feed_vars, place=self.place,
                                program=self.train_program)
            fetch = [v.name for v in self.train_func_outputs]
            cfg = self.checkpoint_cfg
            start_epoch = cfg.epoch_id if cfg and cfg.load_serial else 0
            is_pe = isinstance(exe, parallel_executor.ParallelExecutor)
            if self.bundle_steps > 1 and not is_pe:
                self._train_loop_bundled(exe, num_epochs, event_handler,
                                         reader, feeder, fetch)
                return
            use_async = self.sync == 'async' and not is_pe
            window = collections.deque()   # in-flight async fetch handles
            # (epoch, step) of the last COMPLETED step this run — what an
            # emergency checkpoint must record when preemption is noticed
            # while the reader blocks / between steps
            last_done = None
            for epoch_id in range(start_epoch, num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                skip = (cfg.step_id if cfg and cfg.load_serial
                        and epoch_id == cfg.epoch_id else -1)
                for step_id, fed in self._iter_staged(reader, feeder,
                                                      skip_until=skip):
                    if self.__stop:
                        self._drain_async_window(window)
                        if cfg:
                            self._clean_checkpoint()
                        return
                    if self._preempt_requested:
                        # signal landed while the reader was producing
                        # this batch: flush NOW from the consistent
                        # between-step state instead of one more step
                        self._drain_async_window(window)
                        self._finish_preemption(last_done)
                        return
                    if fed is None:
                        continue  # already done before the crash
                    begin = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin)
                    want = fetch if begin.fetch_metrics else []
                    self._steps_run += 1
                    with obs.span('trainer.step', step_num=self._steps_run,
                                  epoch=epoch_id, step=step_id):
                        if is_pe:
                            metrics = exe.run(want, feed=fed)
                        else:
                            metrics = exe.run(program=self.train_program,
                                              feed=fed, fetch_list=want,
                                              sync='async' if use_async
                                              else 'auto')
                    last_done = (epoch_id, step_id)
                    if use_async:
                        # bounded dispatch window: the handler below may
                        # read (sync) its step's metrics or not — either
                        # way at most async_window steps stay un-synced
                        window.append(metrics)
                        self._drain_async_window(window,
                                                 n_keep=self.async_window)
                    if self._preempt_requested:
                        # the step above was launched; the flush reads
                        # the scope after it on the step's stream. No
                        # _clean_checkpoint: the whole point is resuming.
                        self._drain_async_window(window)
                        self._finish_preemption(last_done)
                        event_handler(EndStepEvent(epoch_id, step_id,
                                                   metrics))
                        return
                    if cfg:
                        self._save_checkpoint(epoch_id, step_id)
                    event_handler(EndStepEvent(epoch_id, step_id, metrics))
                event_handler(EndEpochEvent(epoch_id))
                if self._preempt_requested:
                    # between epochs: same flush, no extra step
                    self._drain_async_window(window)
                    self._finish_preemption(last_done)
                    return
            self._drain_async_window(window)
            if cfg:
                self._clean_checkpoint()

    def _train_loop_bundled(self, exe, num_epochs, event_handler, reader,
                            feeder, fetch):
        """K-step bundled hot loop: buffer K reader batches, run them as
        ONE Executor.run_bundle call, then fire the K EndStepEvents with
        per-step metric slices. Stop/preemption are honored at bundle
        boundaries (a partial buffer is flushed first, so no consumed batch
        is silently dropped); periodic checkpoints are taken after a bundle
        for its LAST step — the scope only ever holds bundle-end state."""
        K = self.bundle_steps
        cfg = self.checkpoint_cfg
        start_epoch = cfg.epoch_id if cfg and cfg.load_serial else 0
        last_done = None

        def bundle_checkpoint(first_step, done):
            """Periodic-checkpoint gate for a just-flushed bundle: save
            when ANY step in [first_step, last_step] crossed a
            step_interval mark — the boundary itself rarely lands on a
            multiple (K=8, interval=10 never does). Records the bundle's
            last step: that is the state the scope holds."""
            if not cfg or done is None:
                return
            epoch_id, last_step = done
            if epoch_id % cfg.epoch_interval:
                return
            if any(s % cfg.step_interval == 0
                   for s in range(first_step, last_step + 1)):
                self._save_checkpoint(epoch_id, last_step, force=True)

        def run_bundle_buf(buf, epoch_id):
            """Execute buffered (step_id, feed, want) entries; returns the
            last (epoch, step) done."""
            if not buf:
                return None
            want = buf[0][2]   # fetch_metrics decided per bundle
            feeds = [b[1] for b in buf]
            self._steps_run += len(buf)
            with obs.span('trainer.step', step_num=self._steps_run,
                          epoch=epoch_id, step=buf[-1][0],
                          bundle_steps=len(buf)):
                stacked = exe.run_bundle(program=self.train_program,
                                         feeds=feeds, fetch_list=want)
            for j, (step_id, _f, _w) in enumerate(buf):
                if want:
                    metrics = [m[j] if isinstance(m, list)
                               else np.asarray(m)[j] for m in stacked]
                else:
                    metrics = []
                event_handler(EndStepEvent(epoch_id, step_id, metrics))
            return (epoch_id, buf[-1][0])

        for epoch_id in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            buf = []   # (step_id, feed_dict, want) awaiting one dispatch
            buf_sig = None
            skip = (cfg.step_id if cfg and cfg.load_serial
                    and epoch_id == cfg.epoch_id else -1)
            for step_id, fed in self._iter_staged(reader, feeder,
                                                  skip_until=skip):
                if self.__stop:
                    done = run_bundle_buf(buf, epoch_id)
                    last_done = done or last_done
                    if cfg:
                        self._clean_checkpoint()
                    return
                if self._preempt_requested:
                    done = run_bundle_buf(buf, epoch_id)
                    last_done = done or last_done
                    self._finish_preemption(last_done)
                    return
                if fed is None:
                    continue  # already done before the crash
                begin = BeginStepEvent(epoch_id, step_id)
                event_handler(begin)
                sig = self._bundle_feed_sig(fed)
                if buf and sig != buf_sig:
                    # batch shape changed mid-stream (classically: the
                    # reader's short last batch) — a bundle runs one
                    # step signature, so flush what is buffered and start
                    # a new bundle
                    first = buf[0][0]
                    done = run_bundle_buf(buf, epoch_id)
                    last_done = done or last_done
                    buf = []
                    if not self._preempt_requested:
                        bundle_checkpoint(first, done)
                buf_sig = sig
                # fetch set is per BUNDLE: the first buffered step's
                # fetch_metrics decision wins
                want = (buf[0][2] if buf
                        else (fetch if begin.fetch_metrics else []))
                buf.append((step_id, fed, want))
                if len(buf) == K:
                    first = buf[0][0]
                    done = run_bundle_buf(buf, epoch_id)
                    last_done = done or last_done
                    buf = []
                    if self._preempt_requested:
                        self._finish_preemption(last_done)
                        return
                    bundle_checkpoint(first, done)
            if buf:   # partial bundle at epoch end
                first = buf[0][0]
                done = run_bundle_buf(buf, epoch_id)
                last_done = done or last_done
                if not self._preempt_requested:
                    bundle_checkpoint(first, done)
            event_handler(EndEpochEvent(epoch_id))
            if self._preempt_requested:
                self._finish_preemption(last_done)
                return
        if cfg:
            self._clean_checkpoint()
