"""Run-log analysis: load/validate JSONL event records and print the
diagnosis summary tools/obs_report.py serves (step-time percentiles,
compile breakdown, cache hit ratio, anomaly skips, retries, reader
degradation, checkpoint timeline, the streaming and tier sections) — a run
is explainable without a profiler trace.

Parity: the JAX package's obs/report.py, copied as it is. It reads events
by name, so it keeps the sections of paths the port has not ported yet
(they print nothing when no such event is in the log), and for the same
JSONL `summarize` returns the same text in both packages.

stdlib-only (see metrics.py for why).
"""
import json
import os

__all__ = ['validate_record', 'load_events', 'collect_events',
           'summarize', 'latest_run', 'percentile_exact']

_KINDS = ('meta', 'event', 'span')


def validate_record(obj):
    """None when `obj` is a well-formed event record, else a short reason
    string (the --check contract)."""
    if not isinstance(obj, dict):
        return 'record is not a JSON object'
    ts = obj.get('ts')
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        return 'missing/non-numeric "ts"'
    name = obj.get('name')
    if not isinstance(name, str) or not name:
        return 'missing/empty "name"'
    kind = obj.get('kind')
    if kind not in _KINDS:
        return 'bad "kind" %r (want one of %s)' % (kind, '/'.join(_KINDS))
    if 'fields' in obj and not isinstance(obj['fields'], dict):
        return '"fields" is not an object'
    if kind == 'span':
        dur = obj.get('dur_s')
        if not isinstance(dur, (int, float)) or isinstance(dur, bool):
            return 'span record missing numeric "dur_s"'
    sp = obj.get('span')
    if sp is not None and not isinstance(sp, int):
        return '"span" is neither null nor an integer id'
    return None


def load_events(path):
    """Parse one JSONL file -> (events, errors) where errors is a list of
    (line_number, reason, raw_line) for malformed records. Blank lines are
    ignored; nothing raises on bad input — that is what errors is for."""
    events, errors = [], []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError as e:
                errors.append((i, 'not JSON: %s' % e, line[:120]))
                continue
            reason = validate_record(obj)
            if reason is not None:
                errors.append((i, reason, line[:120]))
                continue
            events.append(obj)
    return events, errors


def latest_run(obs_dir):
    """Newest run-*.jsonl under obs_dir, or None."""
    cands = [os.path.join(obs_dir, d) for d in os.listdir(obs_dir)
             if d.endswith('.jsonl')] if os.path.isdir(obs_dir) else []
    return max(cands, key=os.path.getmtime) if cands else None


def collect_events(path, merge_dir=False):
    """Load events from a .jsonl file, or from a directory (newest run
    only unless merge_dir=True, which concatenates every run file).
    Returns (events, errors, files_read)."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, d) for d in os.listdir(path)
                       if d.endswith('.jsonl'))
        if not merge_dir:
            latest = latest_run(path)
            files = [latest] if latest else []
    else:
        files = [path]
    events, errors = [], []
    for f in files:
        ev, er = load_events(f)
        events.extend(ev)
        errors.extend((('%s:%d' % (os.path.basename(f), ln)), why, raw)
                      for ln, why, raw in er)
    return events, errors, files


def percentile_exact(values, p):
    """Exact percentile of a small list (nearest-rank with interpolation);
    None on empty input."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    idx = (p / 100.0) * (len(vs) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (idx - lo)


def _spans(events, name):
    return [e for e in events if e.get('kind') == 'span'
            and e.get('name') == name]


def _events(events, name):
    return [e for e in events if e.get('kind') == 'event'
            and e.get('name') == name]


def _fmt_s(v):
    if v is None:
        return '-'
    if v >= 1.0:
        return '%.3fs' % v
    return '%.1fms' % (v * 1e3)


def summarize(events):
    """Human-readable summary string for one run's event list."""
    lines = ['================ obs report ================']
    meta = [e for e in events if e.get('kind') == 'meta'
            and e.get('name') == 'run_start']
    if meta:
        f = meta[0].get('fields', {})
        lines.append('run started %s (pid %s); %d records'
                     % (f.get('time', '?'), f.get('pid', '?'), len(events)))
    else:
        lines.append('%d records (no run_start meta — partial log?)'
                     % len(events))

    # -- steps ----------------------------------------------------------
    steps = _spans(events, 'executor.step')
    compiled_steps = [s for s in steps
                      if s.get('fields', {}).get('compiled')]
    steady = [s['dur_s'] for s in steps
              if not s.get('fields', {}).get('compiled')]
    lines.append('')
    lines.append('-- steps --')
    if steps:
        lines.append('executor steps: %d total, %d carried a compile'
                     % (len(steps), len(compiled_steps)))
        if steady:
            lines.append(
                'steady-state step time: p50 %s  p95 %s  max %s  (n=%d)'
                % (_fmt_s(percentile_exact(steady, 50)),
                   _fmt_s(percentile_exact(steady, 95)),
                   _fmt_s(max(steady)), len(steady)))
        alldur = [s['dur_s'] for s in steps]
        lines.append('all-step time:          p50 %s  p95 %s  max %s'
                     % (_fmt_s(percentile_exact(alldur, 50)),
                        _fmt_s(percentile_exact(alldur, 95)),
                        _fmt_s(max(alldur))))
    else:
        lines.append('no executor.step spans recorded')

    # -- compile / lowering breakdown -----------------------------------
    lowering = _spans(events, 'executor.lowering')
    compiles = _spans(events, 'executor.compile')
    lines.append('')
    lines.append('-- compile --')
    if lowering or compiles:
        per_key = {}
        for s in lowering:
            k = s.get('fields', {}).get('key', '?')
            per_key.setdefault(k, [0.0, 0.0])[0] += s['dur_s']
        for s in compiles:
            k = s.get('fields', {}).get('key', '?')
            per_key.setdefault(k, [0.0, 0.0])[1] += s['dur_s']
        tot_low = sum(v[0] for v in per_key.values())
        tot_cmp = sum(v[1] for v in per_key.values())
        lines.append('lowering %s + compile(+first step) %s over %d '
                     'cache key(s)'
                     % (_fmt_s(tot_low), _fmt_s(tot_cmp), len(per_key)))
        for k, (lo, cm) in sorted(per_key.items(),
                                  key=lambda kv: -(kv[1][0] + kv[1][1])):
            lines.append('  key %-10s lowering %-9s compile %s'
                         % (k, _fmt_s(lo), _fmt_s(cm)))
        steady_total = sum(steady) if steady else 0.0
        denom = steady_total + tot_low + tot_cmp
        if denom > 0:
            lines.append('compile share of instrumented wall time: %.1f%%'
                         % (100.0 * (tot_low + tot_cmp) / denom))
    else:
        lines.append('no lowering/compile spans (every lookup hit the '
                     'cache, or the run predates instrumentation)')

    # -- cache ----------------------------------------------------------
    hits = sum(1 for s in steps if s.get('fields', {}).get('cache') == 'hit')
    misses = sum(1 for s in steps
                 if s.get('fields', {}).get('cache') == 'miss')
    lines.append('')
    lines.append('-- compile cache --')
    if hits + misses:
        lines.append('lookups: %d hits / %d misses (hit ratio %.1f%%)'
                     % (hits, misses, 100.0 * hits / (hits + misses)))
    else:
        lines.append('no cache lookups recorded')
    # persistent (on-disk, cross-process) cache: a first jitted call that
    # DESERIALIZED instead of compiling emits this event and NO
    # executor.compile span — on a warm restart the compile section above
    # should be empty and this line nonzero (docs/perf.md)
    phits = _events(events, 'executor.compile.persistent_hit')
    if phits:
        lines.append('persistent cache: %d executable(s) deserialized '
                     '(zero cold compiles for those keys)' % len(phits))

    # -- bundling --------------------------------------------------------
    bundles = _spans(events, 'executor.bundle')
    if bundles:
        bsteps = sum(int(s.get('fields', {}).get('steps', 0))
                     for s in bundles)
        bdur = [s['dur_s'] for s in bundles]
        lines.append('')
        lines.append('-- bundling --')
        lines.append('%d bundle dispatch(es) covering %d steps '
                     '(p50 %s p95 %s per bundle)'
                     % (len(bundles), bsteps,
                        _fmt_s(percentile_exact(bdur, 50)),
                        _fmt_s(percentile_exact(bdur, 95))))
    stalls = _spans(events, 'executor.host_stall')
    if stalls:
        sdur = [s['dur_s'] for s in stalls]
        lines.append('async fetch: %d host stall(s), total %s '
                     '(p95 %s) — time the host actually blocked on the '
                     'device' % (len(stalls), _fmt_s(sum(sdur)),
                                 _fmt_s(percentile_exact(sdur, 95))))

    # -- step artifact ---------------------------------------------------
    # the compiled-step artifact + pipeline-overlap story (docs/perf.md):
    # one executor.artifact event per artifact build, one first-call
    # record per compiled signature (executor.compile span = online
    # compile; executor.compile.persistent_hit / .aot_hit events =
    # deserialized), trainer.input_stage spans for the input-overlap
    # ratio, and checkpoint.snapshot / checkpoint.commit /
    # trainer.checkpoint.async_wait spans for the async-checkpoint
    # latencies.
    artifacts = _events(events, 'executor.artifact')
    aot_hits = _events(events, 'executor.compile.aot_hit')
    aot_stale = _events(events, 'executor.aot.stale')
    aot_loaded = _events(events, 'executor.aot.loaded')
    aot_exported = _events(events, 'executor.aot.exported')
    input_stage = _spans(events, 'trainer.input_stage')
    snaps = _spans(events, 'checkpoint.snapshot')
    awaits = _spans(events, 'trainer.checkpoint.async_wait')
    if artifacts or aot_hits or aot_loaded or aot_exported or input_stage \
            or snaps or awaits:
        lines.append('')
        lines.append('-- step artifact --')
        if artifacts:
            # per-artifact signature count: every first-call record
            # (compile span OR persistent/aot-hit event) under the
            # artifact's cache key is one compiled entry point (the
            # unbundled step, each bundle length)
            sig_per_key = {}
            for rec in (compiles + phits + aot_hits):
                k = rec.get('fields', {}).get('key', '?')
                sig_per_key[k] = sig_per_key.get(k, 0) + 1
            per_art = [sig_per_key.get(
                e.get('fields', {}).get('key', '?'), 0)
                for e in artifacts]
            lines.append('%d artifact(s) built; signatures per artifact: '
                         '%s (total %d)'
                         % (len(artifacts),
                            '/'.join(str(n) for n in per_art) or '0',
                            sum(sig_per_key.values())))
        split = ('first calls: %d compiled online, %d persistent-hit, '
                 '%d AOT-hit' % (len(compiles), len(phits),
                                 len(aot_hits)))
        if aot_stale:
            split += ', %d STALE (AOT-claimed but compiled)' \
                % len(aot_stale)
        lines.append(split)
        for e in aot_loaded:
            f = e.get('fields', {})
            lines.append('AOT blob loaded: %s signature(s), %s cache '
                         'entr(ies) imported'
                         % (f.get('signatures', '?'),
                            f.get('cache_entries_imported', '?')))
        for e in aot_exported:
            f = e.get('fields', {})
            lines.append('AOT blob exported: %s signature(s), %s cache '
                         'entr(ies)' % (f.get('signatures', '?'),
                                        f.get('cache_entries', '?')))
        if input_stage:
            wait_s = sum(s['dur_s'] for s in input_stage)
            staged = sum(1 for s in input_stage
                         if s.get('fields', {}).get('staged'))
            step_s = sum(s['dur_s'] for s in
                         _spans(events, 'trainer.step'))
            line = ('input stage: %s over %d batch(es) (%d staged '
                    'off-thread)' % (_fmt_s(wait_s), len(input_stage),
                                     staged))
            if step_s > 0:
                line += (' — overlap ratio %.1f%% '
                         '(1 - input wait / step time)'
                         % (100.0 * (1.0 - min(1.0, wait_s / step_s))))
            lines.append(line)
        if snaps:
            sd = [s['dur_s'] for s in snaps]
            lines.append('async checkpoint snapshots: %d (p50 %s  max %s)'
                         % (len(snaps),
                            _fmt_s(percentile_exact(sd, 50)),
                            _fmt_s(max(sd))))
        commits = _spans(events, 'checkpoint.commit')
        if snaps and commits:
            cd = [s['dur_s'] for s in commits]
            lines.append('commit latency: p50 %s  max %s (%d commit '
                         'span(s))' % (_fmt_s(percentile_exact(cd, 50)),
                                       _fmt_s(max(cd)), len(commits)))
        if awaits:
            ad = [s['dur_s'] for s in awaits]
            stalls_n = sum(1 for s in awaits
                           if not s.get('fields', {}).get('ready'))
            lines.append('async-save waits at step boundary: %d (total '
                         '%s, %d not yet done when waited)'
                         % (len(awaits), _fmt_s(sum(ad)), stalls_n))

    # -- optimizer passes ------------------------------------------------
    # passes.optimize spans carry ops_before/ops_after + per-pass sums
    # (docs/passes.md): the attribution trail for op-count wins
    opt_spans = _spans(events, 'passes.optimize')
    if opt_spans:
        before = sum(int(s.get('fields', {}).get('ops_before', 0))
                     for s in opt_spans)
        after = sum(int(s.get('fields', {}).get('ops_after', 0))
                    for s in opt_spans)
        lines.append('')
        lines.append('-- optimizer passes --')
        lines.append('%d program(s) optimized: %d -> %d top-level op(s)'
                     % (len(opt_spans), before, after))
        per = {}
        for name in ('dce', 'fold', 'cse', 'amp', 'quant'):
            tot = sum(int(s.get('fields', {}).get(name, 0))
                      for s in opt_spans)
            if tot:
                per[name] = tot
        if per:
            lines.append('per pass: ' + ', '.join(
                '%s=%d' % kv for kv in sorted(per.items())))
        errs = _events(events, 'passes.error')
        if errs:
            lines.append('%d optimizer failure(s) fell back to the '
                         'unoptimized lowering' % len(errs))

    # -- analysis ---------------------------------------------------------
    # the build-time verifier gate (analysis.verify — one span per
    # (program, context) key PADDLE_TPU_VERIFY judged) and the static
    # cost model (analysis.cost — one span per cost_report() pricing;
    # docs/analysis.md#pass-6)
    ver_spans = _spans(events, 'analysis.verify')
    cost_spans = _spans(events, 'analysis.cost')
    if ver_spans or cost_spans:
        lines.append('')
        lines.append('-- analysis --')
        if ver_spans:
            nf = sum(int(s.get('fields', {}).get('findings', 0))
                     for s in ver_spans)
            ne = sum(int(s.get('fields', {}).get('errors', 0))
                     for s in ver_spans)
            lines.append('%d program(s) verified: %d finding(s), '
                         '%d error-severity' % (len(ver_spans), nf, ne))
        if cost_spans:
            res = max(int(s.get('fields', {})
                          .get('residency_per_device', 0))
                      for s in cost_spans)
            comm = max(int(s.get('fields', {})
                           .get('comm_bytes_per_step', 0))
                       for s in cost_spans)
            lines.append('cost model: %d report(s); max residency '
                         '%d bytes/device, max wire %d bytes/step'
                         % (len(cost_spans), res, comm))

    # -- kernels ----------------------------------------------------------
    # pallas kernel layer (docs/perf.md#kernel-layer): one
    # kernels.dispatch event per TRACE-time routing decision — mode
    # 'kernel' means the pallas body was baked into the compiled module,
    # 'fallback' the pure-XLA lowering. These count compiled modules,
    # not steady-state steps (which re-trace nothing).
    kdisp = _events(events, 'kernels.dispatch')
    if kdisp:
        lines.append('')
        lines.append('-- kernels --')
        per = {}
        for e in kdisp:
            f = e.get('fields', {})
            key = (str(f.get('kernel', '?')), str(f.get('mode', '?')))
            per[key] = per.get(key, 0) + 1
        n_k = sum(v for (_, m), v in per.items() if m == 'kernel')
        n_f = sum(v for (_, m), v in per.items() if m == 'fallback')
        lines.append('trace-time dispatches: %d kernel, %d fallback'
                     % (n_k, n_f))
        for (k, m), v in sorted(per.items()):
            lines.append('  %s: %d %s trace(s)' % (k, v, m))

    # -- sharding / GSPMD ------------------------------------------------
    # executor.remat_detected: XLA's SPMD partitioner fell back to
    # replicate-then-repartition during a compile (an all-gather per step
    # the program never asked for). Zero is the contract on the shipped
    # compositions (docs/parallel.md); any nonzero here is a sharding
    # regression that previously only lived in dryrun stderr tails.
    remat = _events(events, 'executor.remat_detected')
    if remat:
        n = sum(int(e.get('fields', {}).get('count', 1)) for e in remat)
        keys = sorted({str(e.get('fields', {}).get('key', '?'))
                       for e in remat})
        lines.append('')
        lines.append('-- sharding / GSPMD --')
        lines.append('involuntary rematerialization: %d detection(s) '
                     'across compile key(s) %s — a sharding transition '
                     'XLA could only satisfy by replicating the tensor'
                     % (n, ', '.join(keys)))

    # -- embedding -------------------------------------------------------
    # sharded-embedding subsystem (docs/embedding.md): one
    # embedding.lookup event per compiled lookup wire (its geometry) and
    # one embedding.update_rows event per sparse-plan compile (which
    # tables update touched-rows-only, at what per-step bound)
    lookups = _events(events, 'embedding.lookup')
    updates = _events(events, 'embedding.update_rows')
    if lookups or updates:
        lines.append('')
        lines.append('-- embedding --')
        for e in lookups:
            f = e.get('fields', {})
            lines.append('lookup wire: %s ids over axis %s=%s '
                         '(vocab %s, dim %s; %s query slots/shard, '
                         '%s row B/device per exchange)'
                         % (f.get('ids', '?'), f.get('axis', '?'),
                            f.get('axis_size', '?'), f.get('vocab', '?'),
                            f.get('dim', '?'),
                            f.get('query_capacity', '?'),
                            f.get('row_bytes_per_device', '?')))
        for e in updates:
            f = e.get('fields', {})
            lines.append('sparse updates: tables %s, <= %s rows/step '
                         'touched%s (key %s)'
                         % (','.join(f.get('tables', []) or ['?']),
                            f.get('rows_per_step', '?'),
                            ' [sharded]' if f.get('sharded') else '',
                            f.get('key', '?')))

    # -- streaming --------------------------------------------------------
    # streaming-ids online training (docs/embedding.md "streaming ids"):
    # vocab drift (admit/evict events from the VocabTable), and the
    # train->serve delta pushes with their freshness lag
    admits = _events(events, 'streaming.admit')
    evicts = _events(events, 'streaming.evict')
    pushes = _events(events, 'streaming.delta_push')
    rpushes = _events(events, 'router.delta_push')
    if admits or evicts or pushes or rpushes:
        lines.append('')
        lines.append('-- streaming --')
        n_adm = sum(int(e.get('fields', {}).get('rows', 0) or 0)
                    for e in admits)
        n_ev = sum(int(e.get('fields', {}).get('rows', 0) or 0)
                   for e in evicts)
        # the LAST drift event in file order (admits and evicts each
        # carry the post-event resident count; concatenating the lists
        # would wrongly prefer the last evict over a later admit)
        drift = [e for e in events
                 if e.get('name') in ('streaming.admit',
                                      'streaming.evict')]
        resident = drift[-1].get('fields', {}).get('resident', '?') \
            if drift else '?'
        lines.append('vocab drift: %d row(s) admitted, %d evicted '
                     '(resident now: %s)' % (n_adm, n_ev, resident))
        ok = [e for e in pushes if e.get('fields', {}).get('ok')]
        failed = len(pushes) - len(ok)
        if pushes:
            n_rows = sum(int(e.get('fields', {}).get('rows', 0) or 0)
                         for e in ok)
            last = ok[-1].get('fields', {}) if ok else {}
            lines.append('delta pushes: %d ok / %d failed, %d row(s) '
                         'pushed (last: %s ms push, %s s freshness lag)'
                         % (len(ok), failed, n_rows,
                            last.get('push_ms', '?'),
                            last.get('freshness_lag_s', '?')))
        for e in rpushes[-3:]:
            f = e.get('fields', {})
            lines.append('  router push: model %s v%s -> %s replica(s)'
                         ' (%s closed), tables %s'
                         % (f.get('model', '?'), f.get('version', '?'),
                            f.get('replicas', '?'), f.get('closed', 0),
                            ','.join(f.get('tables', []) or ['?'])))

    # -- tiers ------------------------------------------------------------
    # the host-RAM spill tier behind the HBM table (docs/embedding.md
    # #tiers): spill/restore traffic, the warm-restore prefetch leg,
    # and the two LOUD fallbacks (arena full, CRC-failed slot)
    t_spills = _events(events, 'streaming.tier.spill')
    t_restores = _events(events, 'streaming.tier.restore')
    t_prefetch = _events(events, 'streaming.tier.prefetch')
    t_full = _events(events, 'streaming.tier.arena_full')
    t_corrupt = _events(events, 'streaming.tier.corrupt')
    if t_spills or t_restores or t_prefetch or t_full or t_corrupt:
        lines.append('')
        lines.append('-- tiers --')
        n_sp = sum(int(e.get('fields', {}).get('rows', 0) or 0)
                   for e in t_spills)
        n_re = sum(int(e.get('fields', {}).get('rows', 0) or 0)
                   for e in t_restores)
        n_pf = sum(int(e.get('fields', {}).get('rows', 0) or 0)
                   for e in t_prefetch)
        lines.append('spill tier: %d row(s) spilled to host, %d '
                     'restored warm (%d prefetched on the worker)'
                     % (n_sp, n_re, n_pf))
        if t_spills:
            f = t_spills[-1].get('fields', {})
            lines.append('arena: %s/%s slots used (last spill %s ms)'
                         % (f.get('arena_used', '?'),
                            f.get('arena_slots', '?'),
                            f.get('spill_ms', '?')))
        if t_restores:
            f = t_restores[-1].get('fields', {})
            lines.append('last restore: %s row(s) in %s ms'
                         % (f.get('rows', '?'), f.get('restore_ms', '?')))
        if t_full:
            n_drop = sum(int(e.get('fields', {}).get('dropped', 0) or 0)
                         for e in t_full)
            lines.append('ARENA FULL: %d evicted id(s) fell back to '
                         'zeroing (cold re-admit) — provision slots'
                         % n_drop)
        if t_corrupt:
            lines.append('CORRUPT SLOTS: %d spilled row(s) failed CRC '
                         'and were dropped (cold re-admit)'
                         % len(t_corrupt))

    # -- anomaly guard ---------------------------------------------------
    skips = _events(events, 'anomaly.skip')
    lines.append('')
    lines.append('-- anomaly guard --')
    if skips:
        last = skips[-1].get('fields', {})
        lines.append('skipped steps: %d (last: run=%s grad_norm=%s '
                     'loss_finite=%s grads_finite=%s)'
                     % (len(skips), last.get('run', '?'),
                        last.get('grad_norm', '?'),
                        last.get('loss_finite', '?'),
                        last.get('grads_finite', '?')))
    else:
        lines.append('skipped steps: 0')

    # -- retries ---------------------------------------------------------
    retries = _events(events, 'retry.attempt')
    deadline = _events(events, 'retry.deadline_exceeded')
    exhausted = _events(events, 'retry.exhausted')
    lines.append('')
    lines.append('-- retries --')
    if retries or deadline or exhausted:
        by_site = {}
        for e in retries:
            f = e.get('fields', {})
            s = by_site.setdefault(f.get('site', '?'), [0, 0.0])
            s[0] += 1
            s[1] += float(f.get('delay_s', 0.0) or 0.0)
        for site, (n, backoff) in sorted(by_site.items()):
            lines.append('  %-32s %3d retr%s, %s backoff'
                         % (site, n, 'y' if n == 1 else 'ies',
                            _fmt_s(backoff)))
        if deadline:
            lines.append('  deadline exceeded: %d' % len(deadline))
        if exhausted:
            lines.append('  attempts exhausted: %d' % len(exhausted))
    else:
        lines.append('no retries')

    # -- reader ----------------------------------------------------------
    r_retries = _events(events, 'reader.retry')
    degrades = _events(events, 'reader.degrade')
    lines.append('')
    lines.append('-- reader --')
    if r_retries or degrades:
        lines.append('source re-opens: %d; degraded-to-skip streams: %d'
                     % (len(r_retries), len(degrades)))
        for e in degrades:
            f = e.get('fields', {})
            lines.append('  degrade after %s sample(s): %s'
                         % (f.get('emitted', '?'),
                            str(f.get('error', ''))[:80]))
    else:
        lines.append('no reader faults')

    # -- checkpoints ------------------------------------------------------
    ck = [e for e in events
          if e.get('name', '').startswith(('trainer.checkpoint.',
                                           'checkpoint.',
                                           'trainer.resume.',
                                           'trainer.preempted'))]
    lines.append('')
    lines.append('-- checkpoint timeline --')
    if ck:
        t0 = min(e['ts'] for e in events)
        for e in sorted(ck, key=lambda e: e['ts']):
            f = e.get('fields', {})
            extra = ' '.join('%s=%s' % (k, f[k]) for k in sorted(f)
                             if k not in ('error',))
            err = (' ERROR: %s' % str(f['error'])[:60]) if 'error' in f \
                else ''
            dur = (' [%s]' % _fmt_s(e['dur_s'])) if 'dur_s' in e else ''
            lines.append('  +%8.3fs %-34s%s %s%s'
                         % (e['ts'] - t0, e['name'], dur, extra, err))
    else:
        lines.append('no checkpoint activity')

    # -- elastic ----------------------------------------------------------
    # elastic pod training (docs/robustness.md#elastic): sharded-
    # checkpoint commits, reshard-on-restore, topology-change resumes,
    # heartbeat staleness and host-loss verdicts — the decisions that
    # keep a pod job restartable, one line each
    # commits counted from the checkpoint.committed EVENT (fires only
    # after the rename) — the checkpoint.commit span also covers
    # staged-role peers and timed-out attempts, which are not commits
    el_commits = _events(events, 'checkpoint.committed')
    el_reshard = _spans(events, 'checkpoint.reshard')
    el_resume = _events(events, 'elastic.resume')
    el_lost = _events(events, 'elastic.host_lost')
    el_stale = _events(events, 'parallel.heartbeat.stale')
    el_skip = _events(events, 'checkpoint.uncommitted_skipped')
    el_cto = _events(events, 'checkpoint.commit.timeout')
    if el_commits or el_reshard or el_resume or el_lost or el_stale \
            or el_skip or el_cto:
        lines.append('')
        lines.append('-- elastic --')
        if el_commits:
            steps = [e.get('fields', {}).get('step') for e in el_commits]
            lines.append('checkpoint commits: %d (last step %s)'
                         % (len(el_commits), steps[-1]))
        for e in el_cto:
            f = e.get('fields', {})
            lines.append('commit TIMED OUT: step %s waiting for peer '
                         'process(es) %s — left uncommitted'
                         % (f.get('step', '?'), f.get('missing', '?')))
        for e in el_skip:
            lines.append('uncommitted (torn) staging dir(s) skipped on '
                         'restore: %s' % e.get('fields', {}).get('dirs'))
        for s in el_reshard:
            f = s.get('fields', {})
            lines.append('reshard-on-restore: %s array(s), mesh %s -> %s'
                         % (f.get('arrays', '?'), f.get('from_mesh', '?'),
                            f.get('to_mesh', '?')))
        for e in el_resume:
            f = e.get('fields', {})
            lines.append('elastic resume: serial %s at epoch %s step %s, '
                         'mesh %s -> %s'
                         % (f.get('serial', '?'), f.get('epoch', '?'),
                            f.get('step', '?'), f.get('from_mesh', '?'),
                            f.get('to_mesh', '?')))
        if el_stale:
            peers = sorted({e.get('fields', {}).get('peer')
                            for e in el_stale})
            lines.append('stale heartbeats: %d detection(s), peer(s) %s'
                         % (len(el_stale), peers))
        for e in el_lost:
            f = e.get('fields', {})
            lines.append('HOST LOST: peer(s) %s at epoch %s step %s'
                         % (f.get('stale', '?'), f.get('epoch', '?'),
                            f.get('step', '?')))

    # -- serving ----------------------------------------------------------
    sv_batches = _spans(events, 'serving.batch')
    sv_warm = _spans(events, 'serving.warmup')
    sv_rejects = _events(events, 'serving.reject')
    sv_sheds = _events(events, 'serving.shed')
    sv_errors = _events(events, 'serving.batch.error')
    sv_down = _events(events, 'serving.shutdown')
    if sv_batches or sv_warm or sv_rejects or sv_sheds or sv_errors \
            or sv_down:
        lines.append('')
        lines.append('-- serving --')
        if sv_warm:
            per_bucket = ', '.join(
                'b%s %s' % (s.get('fields', {}).get('bucket', '?'),
                            _fmt_s(s['dur_s']))
                for s in sorted(sv_warm, key=lambda s: s.get(
                    'fields', {}).get('bucket', 0)))
            lines.append('warmup: %d bucket(s) pre-compiled (%s)'
                         % (len(sv_warm), per_bucket))
        if sv_batches:
            sizes = [s.get('fields', {}).get('batch_size', 0)
                     for s in sv_batches]
            pads = [s.get('fields', {}).get('padded', 0)
                    for s in sv_batches]
            waits = [s.get('fields', {}).get('wait_max_s')
                     for s in sv_batches]
            waits = [w for w in waits if isinstance(w, (int, float))]
            execs = [s['dur_s'] for s in sv_batches]
            rows = sum(sizes)
            lines.append('batches: %d (%d row(s); batch size p50 %s max %s; '
                         'padding overhead %.1f%%)'
                         % (len(sv_batches), rows,
                            percentile_exact(sizes, 50), max(sizes),
                            100.0 * sum(pads) / max(rows + sum(pads), 1)))
            lines.append('exec latency: p50 %s  p95 %s  max %s'
                         % (_fmt_s(percentile_exact(execs, 50)),
                            _fmt_s(percentile_exact(execs, 95)),
                            _fmt_s(max(execs))))
            if waits:
                lines.append('queue wait (batch max): p50 %s  max %s'
                             % (_fmt_s(percentile_exact(waits, 50)),
                                _fmt_s(max(waits))))
        if sv_rejects or sv_sheds:
            lines.append('overload: %d rejected, %d shed past deadline'
                         % (len(sv_rejects), len(sv_sheds)))
        for e in sv_errors:
            f = e.get('fields', {})
            lines.append('  batch ERROR (%s request(s)): %s'
                         % (f.get('requests', '?'),
                            str(f.get('error', ''))[:80]))
        for e in sv_down:
            f = e.get('fields', {})
            lines.append('shutdown: drained=%s clean=%s completed=%s '
                         'shed=%s' % (f.get('drained', '?'),
                                      f.get('clean', '?'),
                                      f.get('completed', '?'),
                                      f.get('shed', '?')))

    # -- continuous-batching decode + router ------------------------------
    dc_joins = _events(events, 'decode.join')
    dc_rel = _events(events, 'decode.release')
    dc_poison = _events(events, 'decode.poisoned')
    dc_shed = _events(events, 'decode.shed')
    dc_rej = _events(events, 'decode.reject')
    dc_pferr = _events(events, 'decode.prefill.error')
    dc_warm = _spans(events, 'decode.warmup')
    dc_down = _events(events, 'decode.shutdown')
    rt_swap = _events(events, 'router.swap')
    rt_over = _events(events, 'router.overloaded')
    if dc_joins or dc_rel or dc_poison or dc_shed or dc_rej or dc_down \
            or dc_warm or dc_pferr:
        lines.append('')
        lines.append('-- decode --')
        if dc_warm:
            kinds = {}
            for s in dc_warm:
                k = s.get('fields', {}).get('kind', 'join')
                kinds[k] = kinds.get(k, 0) + 1
            lines.append('warmup: %s signature(s) pre-compiled'
                         % ', '.join('%d %s' % (c, k)
                                     for k, c in sorted(kinds.items())))
        toks = [e.get('fields', {}).get('steps', 0) for e in dc_rel]
        lines.append('slot lifecycle: joins: %d  released: %d  '
                     'poisoned: %d' % (len(dc_joins), len(dc_rel),
                                       len(dc_poison)))
        if toks:
            lines.append('tokens per released request: p50 %s  max %s  '
                         '(total %d)'
                         % (percentile_exact(toks, 50), max(toks),
                            sum(toks)))
        # paged state memory: page-pool occupancy from the per-join
        # pages_free samples, prefix-cache counters + speculative
        # accept rate from the shutdown summary (docs/serving.md)
        pg_free = [e['fields']['pages_free'] for e in dc_joins
                   if 'pages_free' in e.get('fields', {})]
        pg_total = next((e['fields']['pages_total'] for e in dc_down
                         if 'pages_total' in e.get('fields', {})), None)
        if pg_free:
            line = ('page pool: min free %d (peak occupancy)'
                    % min(pg_free))
            if pg_total is not None:
                line += ' of %d total' % pg_total
            lines.append(line)
        dc_evict = _events(events, 'decode.prefix.evict')
        pf_hits = sum(1 for e in dc_joins
                      if e.get('fields', {}).get('prefix_hit') is True)
        pf_miss = sum(1 for e in dc_joins
                      if e.get('fields', {}).get('prefix_hit') is False)
        if pf_hits or pf_miss or dc_evict:
            lines.append('prefix cache: %d hit(s), %d miss(es), %d '
                         'evicted (hit rate %s)'
                         % (pf_hits, pf_miss, len(dc_evict),
                            '%.2f' % (pf_hits / (pf_hits + pf_miss))
                            if pf_hits + pf_miss else 'n/a'))
        for e in dc_down:
            rate = e.get('fields', {}).get('spec_accept_rate')
            if rate is not None:
                lines.append('speculative decode: accept rate %.2f'
                             % rate)
        if dc_shed or dc_rej:
            by_reason = {}
            for e in dc_rej:
                r = e.get('fields', {}).get('reason', 'queue')
                by_reason[r] = by_reason.get(r, 0) + 1
            detail = ''
            if by_reason.get('pages'):
                detail = ' (%d blocked on the page pool)' \
                    % by_reason['pages']
            lines.append('overload: %d rejected%s, %d shed past deadline'
                         % (len(dc_rej), detail, len(dc_shed)))
        for e in dc_pferr:
            f = e.get('fields', {})
            lines.append('  prefill ERROR (%s request(s)): %s'
                         % (f.get('requests', '?'),
                            str(f.get('error', ''))[:80]))
        for e in dc_down:
            f = e.get('fields', {})
            lines.append('shutdown: drained=%s clean=%s completed=%s '
                         'tokens=%s' % (f.get('drained', '?'),
                                        f.get('clean', '?'),
                                        f.get('completed', '?'),
                                        f.get('tokens', '?')))
    # -- pod serving: registry, host loss, heal, autoscale -----------------
    pd_reg = _events(events, 'serving.replica.register')
    pd_drain = _events(events, 'serving.replica.drain')
    pd_lost = _events(events, 'serving.replica.lost')
    pd_resh = _events(events, 'serving.replica.reshard')
    pd_heal = _events(events, 'serving.pod.heal_requested')
    pd_hfail = (_events(events, 'serving.pod.heal_failed')
                + _events(events, 'serving.pod.heal_unroutable'))
    pd_scale = _events(events, 'serving.autoscale')
    pd_hlost = _events(events, 'router.host_lost')
    if pd_reg or pd_lost or pd_resh or pd_drain or pd_scale:
        lines.append('')
        lines.append('-- pod serving --')
        hosts = sorted({e.get('fields', {}).get('host')
                        for e in pd_reg
                        if e.get('fields', {}).get('host') is not None})
        lines.append('replicas: %d registered across %d host(s), '
                     '%d drained, %d lost'
                     % (len(pd_reg), len(hosts), len(pd_drain),
                        len(pd_lost)))
        for e in pd_hlost:
            f = e.get('fields', {})
            lines.append('host LOST: h%s — %s replica(s) detached, %s '
                         'future(s) re-routed, %s heal(s) requested'
                         % (f.get('host', '?'), f.get('replicas', '?'),
                            f.get('rerouted', '?'), f.get('heals', '?')))
        for e in pd_resh:
            f = e.get('fields', {})
            line = ('reshard: model=%s -> h%s (%s)'
                    % (f.get('model', '?'), f.get('host', '?'),
                       f.get('key', '?')))
            if f.get('heal_s') is not None:
                line += ' healed in %s' % _fmt_s(f['heal_s'])
            lines.append(line)
        if pd_heal or pd_hfail:
            lines.append('heals: %d requested, %d failed/unroutable'
                         % (len(pd_heal), len(pd_hfail)))
        if pd_scale:
            ups = sum(1 for e in pd_scale
                      if e.get('fields', {}).get('direction') == 'up')
            lines.append('autoscale: %d up, %d down'
                         % (ups, len(pd_scale) - ups))

    # -- rpc transport + per-token streams ---------------------------------
    tr_conn = _events(events, 'serving.transport.connect')
    tr_reco = _events(events, 'serving.transport.reconnect')
    tr_err = _events(events, 'serving.transport.error')
    tr_rej = _events(events, 'serving.transport.reject')
    st_open = _events(events, 'serving.stream.open')
    st_first = _events(events, 'serving.stream.first_token')
    st_res = _events(events, 'serving.stream.resume')
    st_fail = _events(events, 'serving.stream.failover')
    st_close = _events(events, 'serving.stream.close')
    if tr_conn or tr_reco or tr_err or st_open or st_close:
        lines.append('')
        lines.append('-- transport / streams --')
        if tr_conn or tr_reco or tr_err or tr_rej:
            lines.append('rpc wire: %d connect(s), %d reconnect(s), '
                         '%d wire error(s), %d admission reject(s)'
                         % (len(tr_conn), len(tr_reco), len(tr_err),
                            len(tr_rej)))
        if st_open or st_close:
            failed = [e for e in st_close
                      if e.get('fields', {}).get('error')]
            lines.append('streams: %d opened, %d closed (%d failed)'
                         % (len(st_open), len(st_close), len(failed)))
        if st_first:
            ttfts = sorted(e['fields']['ttft_s'] for e in st_first
                           if e.get('fields', {}).get('ttft_s')
                           is not None)
            if ttfts:
                lines.append('ttft: min=%s p50=%s max=%s over %d '
                             'stream(s)'
                             % (_fmt_s(ttfts[0]),
                                _fmt_s(ttfts[len(ttfts) // 2]),
                                _fmt_s(ttfts[-1]), len(ttfts)))
        if st_res or st_fail:
            replayed = sum(int(e.get('fields', {}).get('replayed') or 0)
                           for e in st_res)
            lines.append('failover: %d stream(s) lost a host, %d '
                         'resumed token-exact (%d token(s) replayed)'
                         % (len(st_fail) + len(st_res), len(st_res),
                            replayed))
            for e in st_fail:
                f = e.get('fields', {})
                if not f.get('resumed', True):
                    lines.append('  NOT resumed (ckpt_every=0): sid=%s '
                                 'at t=%s' % (f.get('sid', '-'),
                                              f.get('seen_t', '?')))

    if rt_swap or rt_over:
        lines.append('')
        lines.append('-- router --')
        for e in rt_swap:
            f = e.get('fields', {})
            lines.append('swap: model=%s -> version %s (%s replica(s))'
                         % (f.get('model', '?'), f.get('version', '?'),
                            f.get('replicas', '?')))
        if rt_over:
            by_model = {}
            for e in rt_over:
                m = e.get('fields', {}).get('model', '?')
                by_model[m] = by_model.get(m, 0) + 1
            lines.append('overloaded: %s'
                         % ', '.join('%s x%d' % kv
                                     for kv in sorted(by_model.items())))

    # -- bench ------------------------------------------------------------
    bench = _events(events, 'bench.metric') \
        + _events(events, 'bench.sweep.cmd')
    if bench:
        lines.append('')
        lines.append('-- bench --')
        for e in bench:
            f = e.get('fields', {})
            if e['name'] == 'bench.metric':
                lines.append('  %-52s %s %s'
                             % (f.get('metric', '?'), f.get('value', '-'),
                                f.get('unit', '')))
            else:
                lines.append('  sweep cmd rc=%s %s: %s'
                             % (f.get('rc', '?'),
                                _fmt_s(f.get('dur_s')),
                                str(f.get('cmd', ''))[:70]))
    lines.append('============================================')
    return '\n'.join(lines)
