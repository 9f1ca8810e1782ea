"""DataServiceServer: serve a :class:`~repro.service.DataService` over a
Unix socket + per-session shared-memory rings (DESIGN.md §11).

Thread layout::

    accept thread    -- one per server: accepts connections, spawns handlers
    handler threads  -- one per client connection: JSON-lines RPC dispatch
    pump thread      -- THE producer: runs ``DataService.co_epoch`` with the
                        transport hooks (ready/admit/idle/on_done) and writes
                        batch frames into session rings
    monitor thread   -- reaps dead clients (EOF is caught by the handler;
                        this catches *frozen* ones: no heartbeat AND no ring
                        drain within ``heartbeat_timeout``)

Only the pump thread touches session streams and ring tails, so the
single-producer side of every ring is honoured by construction. Handler
threads touch the service only through its own lock-protected API
(``open_session`` / ``close_session`` / ``suspend``).

Liveness: a client is alive while it either heartbeats (any RPC counts) or
drains its ring (head advance counts — a trainer blocked in a long step
sends no RPCs but keeps consuming). A dead client's session is closed
through the ordinary ``close_session`` path, so its outstanding planned
claims are unwound and the survivors' streams are untouched — the same
guarantee the elastic tests pin for in-process kills.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from pathlib import Path

from repro_torch.obs import MetricsRegistry
from repro_torch.obs import tracer as trace

from ..service import SERVICE_MANIFEST, DataService
from .ring import (
    FRAME_BATCH,
    FRAME_EOE,
    FRAME_ERROR,
    STATE_CLOSED,
    STATE_SUSPENDED,
    BatchRing,
    encode_step_frame,
    frame_budget,
)
from .wire import JsonChannel, ServiceSuspended, error_response

__all__ = ["DataServiceServer", "service_metrics"]


class _PumpAbort(Exception):
    """Raised inside the pump to unwind co_epoch at a step boundary
    (server stop or suspend request)."""


class _Endpoint:
    """One connected client session: its ring, pending epochs, liveness."""

    def __init__(self, job_id, session, ring: BatchRing, budget: int, chan):
        self.job_id = job_id
        self.session = session
        self.ring = ring
        self.budget = budget
        self.chan = chan
        self.pending: "set[int]" = set()   # epochs begun but not EOE'd
        self.last_alive = time.monotonic()
        self._last_head = ring.head

    def touch(self) -> None:
        self.last_alive = time.monotonic()

    def alive_within(self, timeout: float) -> bool:
        head = self.ring.head
        if head != self._last_head:  # draining the ring counts as liveness
            self._last_head = head
            self.touch()
        return time.monotonic() - self.last_alive <= timeout


class DataServiceServer:
    """Out-of-process front end for one :class:`DataService`."""

    def __init__(
        self,
        service: DataService,
        socket_path: "str | Path",
        *,
        heartbeat_timeout: float = 15.0,
        poll_interval: float = 0.002,
    ):
        self.service = service
        self.socket_path = Path(socket_path)
        self.heartbeat_timeout = heartbeat_timeout
        self.poll_interval = poll_interval
        self._lock = threading.RLock()
        self._endpoints: "dict[object, _Endpoint]" = {}
        self._retired: "list[BatchRing]" = []  # closed rings; mmap freed at stop
        self._threads: "list[threading.Thread]" = []
        self._stop = threading.Event()
        self._suspended = False
        # Pending suspend request: (out_dir, done_event, result_box).
        self._suspend_req: "tuple[Path, threading.Event, list] | None" = None
        self._listener: "socket.socket | None" = None
        self._ring_seq = 0
        self.metrics = service_metrics(service)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "DataServiceServer":
        self.socket_path.parent.mkdir(parents=True, exist_ok=True)
        self.socket_path.unlink(missing_ok=True)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(str(self.socket_path))
        self._listener.listen(64)
        # A blocked accept() does not wake when another thread closes the
        # fd (Linux); poll with a timeout so stop() can join this thread.
        self._listener.settimeout(0.2)
        for target in (self._accept_loop, self._pump_loop, self._monitor_loop):
            t = threading.Thread(target=target, daemon=True, name=target.__name__)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        """Stop serving: abort any running pump at its next step boundary,
        close every session, mark rings closed, release the socket."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()  # unblocks accept()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=30.0)
        with self._lock:
            endpoints = list(self._endpoints.values())
            self._endpoints = {}
        for ep in endpoints:
            self._detach(ep, state=STATE_CLOSED)
        for ring in self._retired:
            ring.close()
        self._retired.clear()
        self.service.close()
        self.socket_path.unlink(missing_ok=True)

    def __enter__(self) -> "DataServiceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def serve_forever(self) -> None:
        """Block until :meth:`stop` (used by the ``--serve`` launcher)."""
        if self._listener is None:
            self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        finally:
            self.stop()

    # -------------------------------------------------------------- endpoints
    def _detach(self, ep: _Endpoint, *, state: int, close_chan: bool = True) -> None:
        """Tear an endpoint down: mark+unlink its ring (the client's mmap
        stays valid until it closes), retire the server-side map, close the
        session through the ordinary claim-unwinding path."""
        ep.ring.mark_state(state)
        ep.ring.unlink()
        self._retired.append(ep.ring)  # pump may still hold it this round
        ep.pending.clear()
        self.service.close_session(ep.job_id)
        if close_chan and ep.chan is not None:
            ep.chan.close()

    def _reap(self, job_id, why: str, *, close_chan: bool = True) -> None:
        with self._lock:
            ep = self._endpoints.pop(job_id, None)
        if ep is None:
            return
        self._detach(ep, state=STATE_CLOSED, close_chan=close_chan)

    def _endpoint_for(self, session) -> "_Endpoint | None":
        return self._endpoints.get(session.job_id)

    # ------------------------------------------------------------ pump thread
    def _check_abort(self) -> None:
        if self._stop.is_set() or self._suspend_req is not None:
            raise _PumpAbort

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            if self._suspend_req is not None:
                self._do_suspend()
                continue
            if self._suspended:
                time.sleep(self.poll_interval)
                continue
            with self._lock:
                epochs = sorted(
                    {e for ep in self._endpoints.values() for e in ep.pending}
                )
            if not epochs:
                time.sleep(self.poll_interval)
                continue
            try:
                self._run_pump(epochs[0])
            except _PumpAbort:
                continue  # loop re-checks stop/suspend
            except Exception as exc:  # server-side failure: tell the clients
                self._broadcast_error(exc)

    def _run_pump(self, epoch: int) -> None:
        svc = self.service

        def admit():
            with self._lock:
                return [
                    ep.session for ep in self._endpoints.values()
                    if epoch in ep.pending
                ]

        def ready(session) -> bool:
            ep = self._endpoint_for(session)
            return ep is not None and ep.ring.writable(ep.budget)

        def idle():
            self._check_abort()
            time.sleep(self.poll_interval)

        def on_done(session):
            ep = self._endpoint_for(session)
            if ep is not None:
                # ready() held when this session's stream raised
                # StopIteration, so one budget is free — the tiny EOE
                # sentinel always fits.
                ep.ring.write(FRAME_EOE, [json.dumps({"epoch": epoch}).encode()])
                ep.pending.discard(epoch)

        pump = svc.co_epoch(
            epoch, ready=ready, admit=admit, idle=idle, on_done=on_done, raw=True
        )
        try:
            for session, item in pump:
                ep = self._endpoint_for(session)
                if ep is not None:
                    ep.ring.write(
                        FRAME_BATCH,
                        encode_step_frame(
                            item, session.loader.seq_len, session.loader.pad_id
                        ),
                    )
                self._check_abort()
        finally:
            pump.close()

    def _broadcast_error(self, exc: BaseException) -> None:
        msg = json.dumps({"error": f"{type(exc).__name__}: {exc}"}).encode()
        with self._lock:
            endpoints = list(self._endpoints.values())
            self._endpoints = {}
        for ep in endpoints:
            ep.ring.try_write(FRAME_ERROR, [msg])
            self._detach(ep, state=STATE_CLOSED)

    def _do_suspend(self) -> None:
        out_dir, done, box = self._suspend_req
        try:
            # The pump aborted (or never ran) before we got here, so no
            # session stream is mid-flight — exactly what suspend() needs.
            path = self.service.suspend(out_dir)
            box.append({"ok": True, "dir": str(path)})
            self._suspended = True
            with self._lock:
                endpoints = list(self._endpoints.values())
                self._endpoints = {}
            for ep in endpoints:
                ep.ring.mark_state(STATE_SUSPENDED)
                ep.ring.unlink()
                self._retired.append(ep.ring)
                ep.pending.clear()
        except Exception as exc:
            box.append(error_response(exc))
        finally:
            self._suspend_req = None
            done.set()

    # --------------------------------------------------------- monitor thread
    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                endpoints = list(self._endpoints.items())
            for job_id, ep in endpoints:
                if not ep.alive_within(self.heartbeat_timeout):
                    self._reap(job_id, "heartbeat timeout")
            time.sleep(min(0.05, self.heartbeat_timeout / 4))

    # ---------------------------------------------------------- accept thread
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            conn.settimeout(None)  # accepted sockets inherit the timeout
            chan = JsonChannel(conn)
            t = threading.Thread(
                target=self._handle_conn, args=(chan,), daemon=True
            )
            t.start()

    def _handle_conn(self, chan: JsonChannel) -> None:
        """One client connection: dispatch RPCs until EOF, then reap any
        session it opened (a SIGKILL'd client closes its socket — the fast
        path for dead-client detection)."""
        job_id = None
        try:
            while not self._stop.is_set():
                msg = chan.recv()
                if msg is None:
                    break  # EOF: client gone
                try:
                    resp, job_id = self._dispatch(msg, chan, job_id)
                except Exception as exc:
                    resp = error_response(exc)
                try:
                    chan.send(resp)
                except OSError:
                    break
        except (OSError, ValueError):
            pass  # torn connection mid-message
        finally:
            if job_id is not None:
                self._reap(job_id, "connection closed")
            chan.close()

    # ----------------------------------------------------------- op dispatch
    def _dispatch(self, msg: dict, chan: JsonChannel, job_id):
        op = msg.get("op")
        with self._lock:
            ep = self._endpoints.get(job_id)
        if ep is not None:
            ep.touch()
        if op == "open_session":
            return self._op_open_session(msg, chan)
        if op == "heartbeat":
            return {"ok": True}, job_id
        if op == "begin_epoch":
            if self._suspended:
                raise _suspended_error()
            if ep is None:
                raise KeyError(f"no session on this connection (job {job_id!r})")
            ep.pending.add(int(msg["epoch"]))
            return {"ok": True}, job_id
        if op == "steps_per_epoch":
            if ep is None:
                raise KeyError(f"no session on this connection (job {job_id!r})")
            n = ep.session.steps_per_epoch(int(msg.get("epoch", 0)))
            return {"ok": True, "steps": n}, job_id
        if op == "plan_epoch":
            plans = self.service.plan_epoch(int(msg["epoch"]))
            return {"ok": True, "planned": len(plans)}, job_id
        if op == "stats":
            return {"ok": True, "stats": self.service.stats_report()}, job_id
        if op == "admission":
            return {
                "ok": True, "admission": self.service.admission_report(),
            }, job_id
        if op == "metrics":
            return self._op_metrics(), job_id
        if op == "trace_dump":
            return self._op_trace_dump(msg), job_id
        if op == "close_session":
            if job_id is not None:
                # Leave the channel open: the ok-response still has to go
                # out on it; the client closes its end right after.
                self._reap(job_id, "client close", close_chan=False)
            return {"ok": True}, None
        if op == "suspend":
            return self._op_suspend(msg), job_id
        if op == "shutdown":
            self._stop.set()
            return {"ok": True}, job_id
        raise ValueError(f"unknown transport op {op!r}")

    def _op_open_session(self, msg: dict, chan: JsonChannel):
        from ...core.spec import SessionSpec

        if self._suspended:
            raise _suspended_error()
        job_id = msg["job_id"]
        resume_from = msg.get("resume_from")
        svc = self.service
        with self._lock:
            if job_id in self._endpoints:
                raise ValueError(
                    f"job {job_id!r} already has a connected client"
                )
        existing = svc._sessions.get(job_id)
        if existing is not None and not existing.closed:
            # A pre-resumed session (DataService.resume stood the whole
            # service back up): the reconnecting client just attaches.
            if msg.get("spec") is not None:
                raise ValueError(
                    f"job {job_id!r} already has a server-side session "
                    "(resumed); reconnect without a spec to attach"
                )
            session = existing
        elif resume_from is not None:
            session = svc.open_session(
                job_id, resume_from=_resolve_resume_dir(resume_from, job_id)
            )
        else:
            spec = SessionSpec.from_json(msg.get("spec") or {})
            session = svc.open_session(job_id, spec)
        spec = session.spec
        budget = frame_budget(spec.global_batch, spec.seq_len, spec.num_nodes)
        capacity = budget * (max(2, spec.queue_depth) + 1)
        with self._lock:
            self._ring_seq += 1
            ring_path = self.socket_path.with_name(
                f"{self.socket_path.name}.ring{self._ring_seq:04d}"
            )
        ring = BatchRing.create(ring_path, capacity)
        ep = _Endpoint(job_id, session, ring, budget, chan)
        with self._lock:
            self._endpoints[job_id] = ep
        rp = session.loader.resume_point
        store_spec = getattr(svc.store, "spec", None)
        return {
            "ok": True,
            "ring": str(ring_path),
            "budget": budget,
            "spec": spec.to_json(),
            # The served store's StoreSpec (DESIGN.md §15), so remote
            # trainers resolve the codec/bands without guessing.
            "store": store_spec.to_json() if store_spec is not None else None,
            "resume_point": list(rp) if rp is not None else None,
        }, job_id

    def _op_metrics(self) -> dict:
        """Live scrape: flat snapshot + Prometheus text. Per-job providers
        are (re-)registered on every scrape, so jobs opened after the
        server started are always covered."""
        for j, st in self.service.residency.per_job_stats.items():
            self.metrics.register_stats(
                "service", lambda st=st: st, labels={"job": str(j)}
            )
        return {
            "ok": True,
            "metrics": self.metrics.collect(),
            "text": self.metrics.exposition(),
        }

    def _op_trace_dump(self, msg: dict) -> dict:
        """Export the server process's trace ring. With ``path`` the Chrome
        JSON is written server-side (the trace can be large); otherwise it
        is returned inline."""
        tracer = trace.get()
        if tracer is None:
            return {"ok": True, "trace": None, "events": 0}
        path = msg.get("path")
        if path is not None:
            tracer.dump(path)
            return {"ok": True, "path": str(path), "events": len(tracer)}
        return {
            "ok": True, "trace": tracer.to_chrome(), "events": len(tracer)
        }

    def _op_suspend(self, msg: dict) -> dict:
        out_dir = Path(msg["dir"])
        done = threading.Event()
        box: list = []
        with self._lock:
            if self._suspend_req is not None:
                raise RuntimeError("a suspend is already in progress")
            self._suspend_req = (out_dir, done, box)
        # The pump thread performs the suspend (it owns the streams); this
        # handler just waits for it.
        if not done.wait(timeout=120.0):
            raise RuntimeError("suspend timed out waiting for the pump")
        return box[0]


def service_metrics(service: DataService) -> MetricsRegistry:
    """A registry wired to a :class:`DataService`'s live stats objects:
    the aggregate ServiceStats, the storage BackendStats, and the shared
    residency's cache gauges (per-job stats join at scrape time — see
    ``DataServiceServer._op_metrics``)."""
    reg = MetricsRegistry()
    reg.register_stats("service", service.aggregate_stats)
    reg.register_stats("backend", lambda: service.store.backend_stats)
    reg.register_stats("residency", lambda: {
        "cache_bytes": service.residency.cache_bytes,
        "peak_cache_bytes": service.residency.peak_cache_bytes,
        "evictions": service.residency.evictions,
        "cache_bypass": service.residency.cache_bypass,
        "open_sessions": len(service.sessions),
    })
    return reg


def _suspended_error() -> ServiceSuspended:
    return ServiceSuspended(
        "data service is suspended (checkpointed); start a resumed server "
        "and reconnect"
    )


def _resolve_resume_dir(path, job_id) -> Path:
    """Accept either a session suspend dir or the whole-service suspend dir
    (in which case the job's subdir is resolved via the manifest)."""
    path = Path(path)
    manifest = path / SERVICE_MANIFEST
    if manifest.exists():
        mf = json.loads(manifest.read_text())
        for job in mf["jobs"]:
            if job["job_id"] == job_id:
                return path / job["dir"]
        raise KeyError(
            f"job {job_id!r} not found in {manifest} "
            f"(jobs: {[j['job_id'] for j in mf['jobs']]})"
        )
    return path
