"""JSON-lines control plane over a Unix domain socket (DESIGN.md §11).

Control traffic is tiny and rare (session lifecycle, epoch boundaries,
heartbeats) so it rides newline-delimited JSON: one request object per
line, one response object per line, strictly request/response (the client
holds a lock, so at most one RPC is in flight per connection). Batch
payloads never touch the socket — they flow through the per-session
shared-memory ring (:mod:`.ring`).

Requests look like ``{"op": "begin_epoch", "epoch": 3}``; responses are
``{"ok": true, ...}`` or ``{"ok": false, "error": "...", "kind": "..."}``
where ``kind`` names the exception class the client should raise.
"""

from __future__ import annotations

import json
import socket
import time

__all__ = [
    "JsonChannel",
    "TransportError",
    "ServiceSuspended",
    "SessionClosed",
    "connect_unix",
    "error_response",
    "raise_for",
]


class TransportError(RuntimeError):
    """Control-plane failure: server gone, protocol error, or a server-side
    exception relayed over the wire."""


class ServiceSuspended(TransportError):
    """The data service suspended itself (checkpointed); reconnect to a
    resumed server with ``RedoxClient(..., resume_from=...)``."""


class SessionClosed(TransportError):
    """The server closed this session (explicit close, or the client was
    declared dead and reaped)."""


def _admission_rejected():
    # Deferred: wire.py is imported while repro.service's own __init__ is
    # still executing; by the time an error is folded or raised the service
    # module is fully loaded.
    from ..service import AdmissionRejected

    return AdmissionRejected


_KINDS = {
    "TransportError": TransportError,
    "ServiceSuspended": ServiceSuspended,
    "SessionClosed": SessionClosed,
    "AdmissionRejected": _admission_rejected,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "TypeError": TypeError,
    "RuntimeError": RuntimeError,
}


def _kind_class(kind):
    cls = _KINDS.get(kind, TransportError)
    return cls() if not isinstance(cls, type) else cls


def error_response(exc: BaseException) -> dict:
    """Server side: fold an exception into a wire error object."""
    kind = type(exc).__name__
    if kind not in _KINDS:
        kind = "TransportError"
    return {"ok": False, "error": str(exc), "kind": kind}


def raise_for(resp: dict):
    """Client side: raise the exception a ``{"ok": false}`` response names."""
    raise _kind_class(resp.get("kind"))(
        resp.get("error", "unknown server error")
    )


class JsonChannel:
    """One connected socket speaking newline-delimited JSON."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._rfile = sock.makefile("rb")

    def send(self, obj: dict) -> None:
        self.sock.sendall(json.dumps(obj).encode() + b"\n")

    def recv(self) -> "dict | None":
        """Next message, or None on EOF (peer gone)."""
        line = self._rfile.readline()
        if not line:
            return None
        return json.loads(line)

    def close(self) -> None:
        # Shutdown first: it unblocks a thread mid-recv on this channel
        # (closing the buffered reader while another thread holds its lock
        # in readinto() would deadlock).
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for closer in (self.sock.close, self._rfile.close):
            try:
                closer()
            except (OSError, ValueError):
                pass


def connect_unix(path, *, timeout: float = 10.0, poll: float = 0.05) -> JsonChannel:
    """Connect to the server's UDS, retrying until ``timeout`` — covers the
    two-terminal quickstart where the trainer starts before the server has
    bound its socket."""
    deadline = time.monotonic() + timeout
    while True:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(str(path))
            return JsonChannel(sock)
        except (FileNotFoundError, ConnectionRefusedError):
            sock.close()
            if time.monotonic() > deadline:
                raise TransportError(
                    f"no data server listening on {path} after {timeout}s"
                ) from None
            time.sleep(poll)
