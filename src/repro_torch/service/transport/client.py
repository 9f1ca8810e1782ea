"""RedoxClient: the trainer-side drop-in for a RedoxLoader (DESIGN.md §11).

A trainer in a *separate OS process* swaps::

    loader = RedoxLoader.from_spec(spec, store)
    for batch in loader.epoch_async(epoch): ...

for::

    client = RedoxClient(socket_path, spec, job_id="job0")
    for batch in client.epoch(epoch): ...

and receives the exact same ``GlobalBatch`` stream — tokens arrive through
the session's shared-memory ring (one copy out, zero pickling), control
through the JSON socket. A background thread heartbeats so a frozen
trainer is eventually reaped server-side; a SIGKILL'd one is reaped
immediately via socket EOF.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

from ...core.spec import SessionSpec, StoreSpec
from .ring import (
    FRAME_BATCH,
    FRAME_EOE,
    FRAME_ERROR,
    STATE_SUSPENDED,
    BatchRing,
    RingClosed,
    decode_batch_frame,
)
from .wire import (
    ServiceSuspended,
    SessionClosed,
    TransportError,
    connect_unix,
    raise_for,
)

__all__ = ["RedoxClient"]


class RedoxClient:
    """One job's remote data session over a :class:`DataServiceServer`.

    ``spec=None`` attaches to a server-side session that already exists
    under ``job_id`` (the reconnect-after-resume flow); ``resume_from``
    asks the server to restore the session from suspend files first (the
    path may be a whole-service suspend dir — the server resolves this
    job's subdir through the service manifest).
    """

    def __init__(
        self,
        socket_path: "str | Path",
        spec: "SessionSpec | None" = None,
        *,
        job_id="job0",
        resume_from: "str | Path | None" = None,
        heartbeat_interval: float = 2.0,
        frame_timeout: float = 120.0,
        connect_timeout: float = 10.0,
    ):
        self.socket_path = Path(socket_path)
        self.job_id = job_id
        self.frame_timeout = frame_timeout
        self._chan = connect_unix(self.socket_path, timeout=connect_timeout)
        self._rpc_lock = threading.Lock()
        self._closed = threading.Event()
        msg = {"op": "open_session", "job_id": job_id}
        if spec is not None:
            msg["spec"] = spec.to_json()
        if resume_from is not None:
            msg["resume_from"] = str(resume_from)
        resp = self._rpc(msg)
        self.spec = SessionSpec.from_json(resp["spec"])
        store = resp.get("store")
        #: The served store's frozen StoreSpec — codec, level, bands — so
        #: the trainer knows the byte representation without guessing
        #: (None when talking to a store double or an older server).
        self.store_spec = StoreSpec.from_json(store) if store else None
        rp = resp.get("resume_point")
        #: (epoch, next_step) the server will continue from, if resumed.
        self.resume_point = tuple(rp) if rp else None
        self._ring = BatchRing.attach(resp["ring"])
        self._beat = threading.Thread(
            target=self._heartbeat_loop,
            args=(heartbeat_interval,),
            daemon=True,
        )
        if heartbeat_interval > 0:
            self._beat.start()

    # ------------------------------------------------------------------- rpc
    def _rpc(self, msg: dict) -> dict:
        with self._rpc_lock:
            if self._closed.is_set():
                raise SessionClosed(f"client for job {self.job_id!r} is closed")
            try:
                self._chan.send(msg)
                resp = self._chan.recv()
            except OSError as exc:
                raise TransportError(f"data server connection lost: {exc}") from exc
        if resp is None:
            raise TransportError("data server closed the connection")
        if not resp.get("ok"):
            raise_for(resp)
        return resp

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._closed.wait(interval):
            try:
                self._rpc({"op": "heartbeat"})
            except (TransportError, SessionClosed):
                return

    # ---------------------------------------------------------------- epochs
    def steps_per_epoch(self, epoch: int = 0) -> int:
        return self._rpc({"op": "steps_per_epoch", "epoch": epoch})["steps"]

    def epoch(self, epoch: int):
        """Yield this job's GlobalBatches for ``epoch``, exactly as the
        in-process loader would produce them.

        If the service suspends mid-epoch, every batch the server produced
        before the suspend point is still drained from the ring, then
        :class:`ServiceSuspended` is raised — so the trainer's consumed
        stream matches the server-side suspend cursor exactly.
        """
        self._rpc({"op": "begin_epoch", "epoch": epoch})
        while True:
            try:
                kind, payload = self._ring.read(timeout=self.frame_timeout)
            except RingClosed as exc:
                if exc.state == STATE_SUSPENDED:
                    raise ServiceSuspended(
                        f"data service suspended during epoch {epoch}"
                    ) from None
                raise SessionClosed(
                    f"server closed session {self.job_id!r} during epoch {epoch}"
                ) from None
            if kind == FRAME_BATCH:
                yield decode_batch_frame(payload)
            elif kind == FRAME_EOE:
                eoe = json.loads(payload)
                assert eoe.get("epoch") == epoch, (
                    f"out-of-order end-of-epoch: got {eoe} during epoch {epoch}"
                )
                return
            elif kind == FRAME_ERROR:
                raise TransportError(json.loads(payload)["error"])
            else:
                raise TransportError(f"unknown frame kind {kind}")

    # The in-process loader's async spelling; remotely every epoch is
    # already pipelined through the ring, so they are the same thing.
    epoch_async = epoch

    def epoch_device(self, epoch: int, stager=None, *, device=None):
        """Device-resident batches over the ring (DESIGN.md §12): frames
        are decoded and double-buffered onto the device by a
        :class:`~repro_torch.core.device.DeviceStager` while the trainer's
        previous step computes.

        Ring frames ship pre-assembled grids, so this is the staging half
        only — the CUDA gather needs the host-side slot packs and is
        reserved for in-process loaders (``RedoxLoader.epoch_device``).
        Without ``stager`` one is made on ``device``: the CUDA card by
        default (an error without one), or ``device="cpu"``.
        """
        from ...core.device import DeviceStager  # deferred: pulls in torch

        if stager is None:
            stager = DeviceStager(device=device, use_kernel=False)
        return stager.stream(self.epoch(epoch))

    # ------------------------------------------------------------- lifecycle
    def suspend(self, out_dir: "str | Path") -> Path:
        """Ask the service to checkpoint its whole data plane (all jobs)."""
        resp = self._rpc({"op": "suspend", "dir": str(out_dir)})
        return Path(resp["dir"])

    def stats(self) -> dict:
        return self._rpc({"op": "stats"})["stats"]

    def admission(self) -> "dict | None":
        """The server's admission-control view (None when admission is off).
        An over-budget ``open_session`` raises
        :class:`repro.service.AdmissionRejected` typed on this side."""
        return self._rpc({"op": "admission"})["admission"]

    def metrics(self) -> dict:
        """Scrape the live server: ``{"metrics": flat snapshot,
        "text": Prometheus exposition}`` (see ``repro.obs.MetricsRegistry``)."""
        resp = self._rpc({"op": "metrics"})
        return {"metrics": resp["metrics"], "text": resp["text"]}

    def trace_dump(self, path: "str | Path | None" = None):
        """Export the server process's trace. With ``path`` the server
        writes the Chrome JSON to that (server-local) file and the number
        of events is returned; without it the trace object itself comes
        back inline (None when server-side tracing is off)."""
        msg: dict = {"op": "trace_dump"}
        if path is not None:
            msg["path"] = str(path)
        resp = self._rpc(msg)
        return resp.get("path", resp.get("trace")), resp["events"]

    def close(self) -> None:
        if self._closed.is_set():
            return
        try:
            self._rpc({"op": "close_session"})
        except (TransportError, SessionClosed):
            pass  # server already gone
        self._closed.set()
        self._chan.close()
        self._ring.close()

    def __enter__(self) -> "RedoxClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
