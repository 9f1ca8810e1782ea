"""Out-of-process transport for the multi-job data service (DESIGN.md §11).

Control plane: newline-delimited JSON over a Unix domain socket
(:mod:`.wire`). Data plane: one mmap-backed shared-memory ring per session
(:mod:`.ring`) — batch tokens are copied once into the ring by the server
and reconstructed as ndarray views by the client, never pickled.
:class:`DataServiceServer` fronts a :class:`~repro.service.DataService`;
:class:`RedoxClient` is the trainer-side drop-in loader.
"""

from .client import RedoxClient
from .ring import BatchRing, RingClosed, decode_batch_frame, encode_step_frame, frame_budget
from .server import DataServiceServer
from .wire import ServiceSuspended, SessionClosed, TransportError

__all__ = [
    "BatchRing",
    "DataServiceServer",
    "RedoxClient",
    "RingClosed",
    "ServiceSuspended",
    "SessionClosed",
    "TransportError",
    "decode_batch_frame",
    "encode_step_frame",
    "frame_budget",
]
