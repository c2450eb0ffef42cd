"""Delta publishing: touched-row snapshots pushed into live serving.

Parity: the JAX package's streaming/publish.py (DeltaPublisher :45). The
trainer's scope and a Router's replicas are separate state, and the
freshness loop closes with ROW DELTAS: the sparse update path already
knows exactly which table rows a step wrote (`StepArtifact.touched_rows`,
resolved host-side from the feed), so :class:`DeltaPublisher` accumulates
that touched set off the step path, snapshots the rows' current values at
its cadence — on the card one `index_select` of the touched rows and one
copy of them to the host, never a whole table — and pushes them into
every live replica through `Router.push_deltas`, each replica writing
them in place into the weights its captured graphs read
(`ServingEngine.push_rows`), instead of a full-artifact `swap()`.

Failure posture: the pending (touched) set clears ONLY on a successful
push. A push that fails — every replica refusing, an IO error — leaves
the set intact, so the next cadence retries the SAME rows (plus whatever
accumulated since); freshness degrades, correctness never does. The JAX
publisher's heartbeat gate (a host-loss check before any replica is
touched) waits for the port's parallel slice.

Measured: `streaming.delta_push` events carry rows/tables/push_ms and
the freshness lag (now minus the OLDEST unpushed touch — the staleness
a scoring request could have observed), with `streaming.freshness_lag_s`
as a gauge, and each publish is a `streaming.publish` span (the JAX
package's trace span; obs/trace is not ported).
"""
import threading
import time

import numpy as np
import torch

from .. import obs

__all__ = ['DeltaPublisher']

_G_LAG = obs.gauge('streaming.freshness_lag_s')
_C_PUSHES = obs.counter('streaming.delta_pushes')
_C_PUSH_ROWS = obs.counter('streaming.delta_rows')
_G_PUSH_BYTES = obs.gauge('streaming.delta_push_bytes')


class DeltaPublisher(object):
    """Accumulate touched rows per table; push their live values.

    router/model_id: the serving side (`Router.push_deltas`). Pass
        `router=engine_like` with a `push_rows` method and
        `model_id=None` to push straight into one engine (tests,
        single-replica deployments).
    interval_steps / min_interval_s: the cadence — a publish fires when
        BOTH at least `interval_steps` collected steps and
        `min_interval_s` seconds have passed since the last push.
    name_map: training table name -> serving persistable name (tables
        keep their names through clone/save_inference_model, so the
        default identity map is usually right).
    heartbeat: the JAX publisher's host-loss gate; it needs the port's
        parallel slice, and anything but None raises NotImplementedError.
    quant: None (fp32 rows, the default) or 'int8' — push each row as
        int8 + one f32 per-row scale (embedding.quant_rows), cutting
        value bytes per row from 4*D to D+4. A router
        with `push_quantized_rows`/`push_quantized_deltas` receives the
        codec form (rows, q, scale) and dequantizes replica-side;
        otherwise the publisher dequantizes locally and pushes fp32
        through the normal methods — the replica then holds exactly the
        values a quantized wire would have delivered (the documented
        rounding: <= max|row|/254 per element). `last_push_bytes` and
        the `streaming.delta_push_bytes` gauge record the VALUE payload
        either way.
    """

    def __init__(self, router, model_id=None, interval_steps=1,
                 min_interval_s=0.0, name_map=None, heartbeat=None,
                 quant=None):
        if quant not in (None, 'int8'):
            raise ValueError("quant must be None or 'int8', got %r"
                             % (quant,))
        self._router = router
        self._model_id = model_id
        self.interval_steps = int(interval_steps)
        self.min_interval_s = float(min_interval_s)
        self._name_map = dict(name_map or {})
        if heartbeat is not None:
            raise NotImplementedError(
                'DeltaPublisher(heartbeat=) waits for the port\'s '
                '"Parallel" slice (ROADMAP.md Queue A)')
        self.quant = quant
        self._lock = threading.Lock()
        self._pending = {}        # table -> set of touched rows
        self._oldest_touch = None  # monotonic time of oldest unpushed touch
        self._steps_since = 0
        self._last_push_t = None
        # cumulative stats
        self.pushes = 0
        self.failed_pushes = 0
        self.rows_pushed = 0
        self.last_lag_s = None
        self.last_push_ms = None
        self.last_push_bytes = None

    def collect(self, touched, step=None):
        """Record one step's touched rows: {table: int row ids} — the
        shape `StepArtifact.touched_rows(feed)` returns. Cheap host
        set-union; never touches the device."""
        now = time.monotonic()
        with self._lock:
            for table, rows in touched.items():
                rows = np.asarray(rows).reshape(-1)
                if not rows.size:
                    continue
                s = self._pending.get(table)
                if s is None:
                    s = self._pending[table] = set()
                s.update(int(r) for r in rows)
                if self._oldest_touch is None:
                    self._oldest_touch = now
            self._steps_since += 1

    def pending_rows(self):
        with self._lock:
            return {t: len(s) for t, s in self._pending.items()}

    def due(self):
        """Is the cadence satisfied? (Something pending, enough steps,
        enough wall clock.)"""
        with self._lock:
            if not self._pending:
                return False
            if self._steps_since < self.interval_steps:
                return False
            if self._last_push_t is not None and self.min_interval_s > 0 \
                    and time.monotonic() - self._last_push_t \
                    < self.min_interval_s:
                return False
            return True

    def maybe_publish(self, read_table):
        """publish() when due; returns rows pushed (0 when not due)."""
        if not self.due():
            return 0
        return self.publish(read_table)

    def publish(self, read_table):
        """Snapshot every pending table's touched rows through
        `read_table(name)` (the trainer passes a scope reader: a tensor,
        whose touched rows alone are gathered on its device and copied to
        the host; or an array) and push them into the live replicas.
        Clears the pending set on success only. Returns rows pushed."""
        with obs.span('streaming.publish') as sp:
            total = self._publish(read_table)
            sp.fields['rows'] = total
        return total

    def _publish(self, read_table):
        with self._lock:
            snapshot = {t: np.asarray(sorted(s), np.int64)
                        for t, s in self._pending.items()}
            oldest = self._oldest_touch
        if not snapshot:
            return 0
        deltas = {}
        total = 0
        push_bytes = 0
        quantized_wire = False
        if self.quant == 'int8':
            from ..embedding import quant_rows as qr
            # codec-aware router: ship (rows, q, scale); otherwise
            # dequantize here and push fp32 carrying the SAME values a
            # quantized wire delivers (rounding documented on `quant`)
            quantized_wire = hasattr(
                self._router, 'push_quantized_deltas'
                if self._model_id is not None else 'push_quantized_rows')
        for table, rows in snapshot.items():
            vals = _take_rows(read_table(table), rows)
            name = self._name_map.get(table, table)
            if self.quant == 'int8':
                q, scale = qr.quantize_rows(vals)
                push_bytes += qr.row_bytes(q, scale)
                if quantized_wire:
                    deltas[name] = (rows, q, scale)
                else:
                    deltas[name] = (rows, qr.dequantize_rows(q, scale))
            else:
                deltas[name] = (rows, vals)
                push_bytes += int(vals.nbytes)
            total += int(rows.size)
        t0 = time.monotonic()
        try:
            if self._model_id is not None:
                if quantized_wire:
                    self._router.push_quantized_deltas(self._model_id,
                                                       deltas)
                else:
                    self._router.push_deltas(self._model_id, deltas)
            elif quantized_wire:
                self._router.push_quantized_rows(deltas)
            else:
                self._router.push_rows(deltas)
        except Exception:
            # pending set stays intact: the next cadence retries these
            # rows (freshness degrades, correctness never does)
            self.failed_pushes += 1
            obs.event('streaming.delta_push', ok=False, rows=total,
                      tables=sorted(snapshot))
            raise
        now = time.monotonic()
        push_ms = (now - t0) * 1000.0
        lag_s = (now - oldest) if oldest is not None else 0.0
        with self._lock:
            # drop exactly what was pushed; rows touched DURING the push
            # stay pending for the next cadence
            for table, rows in snapshot.items():
                s = self._pending.get(table)
                if s is not None:
                    s.difference_update(int(r) for r in rows)
                    if not s:
                        self._pending.pop(table)
            self._oldest_touch = time.monotonic() if self._pending else None
            self._steps_since = 0
            self._last_push_t = now
        self.pushes += 1
        self.rows_pushed += total
        self.last_lag_s = lag_s
        self.last_push_ms = push_ms
        self.last_push_bytes = push_bytes
        _C_PUSHES.inc()
        _C_PUSH_ROWS.inc(total)
        _G_LAG.set(lag_s)
        _G_PUSH_BYTES.set(push_bytes)
        obs.event('streaming.delta_push', ok=True, rows=total,
                  tables=sorted(snapshot), push_ms=round(push_ms, 3),
                  push_bytes=push_bytes, quant=self.quant or 'fp32',
                  freshness_lag_s=round(lag_s, 4))
        return total

    def stats(self):
        with self._lock:
            pending = sum(len(s) for s in self._pending.values())
        return {'pushes': self.pushes,
                'failed_pushes': self.failed_pushes,
                'rows_pushed': self.rows_pushed,
                'pending_rows': pending,
                'last_freshness_lag_s': self.last_lag_s,
                'last_push_ms': self.last_push_ms,
                'last_push_bytes': self.last_push_bytes,
                'quant': self.quant or 'fp32'}


def _take_rows(w, rows):
    """rows [n] of table `w` on the host: a tensor gathers them on its own
    device (after the step that wrote them, on the caller's stream) and
    copies only those to the host; anything else is read as an array."""
    if not isinstance(w, torch.Tensor):
        return np.asarray(w)[rows]
    from ..fluid.executor import numpy_of
    with torch.no_grad():
        idx = torch.from_numpy(rows).to(w.device)
        return numpy_of(w.detach().index_select(0, idx).cpu())
