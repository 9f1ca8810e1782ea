"""Multi-job data service: one shared chunk cache serving N training jobs.

See :mod:`repro.service.service` for the architecture. Quick tour::

    store = ChunkStore.open(root)
    svc = DataService(store, co_refill=True)
    for j in range(3):
        svc.open_session(f"job{j}", SessionSpec(seed=j, batch_per_node=16))
    for job_id, batch in svc.co_epoch(epoch=0):
        ...  # each job's stream is its own uniform exactly-once shuffle
    print(svc.stats_report()["aggregate"])  # shared_hits, dup_loads_avoided

Out-of-process serving (:mod:`repro.service.transport`)::

    DataServiceServer(svc, sock_path).start()      # server process
    client = RedoxClient(sock_path, spec, job_id="job0")   # trainer process
    for batch in client.epoch(0): ...              # byte-identical stream
"""

from .residency import SharedResidency, session_still_needs
from .service import (
    AdmissionControl,
    AdmissionRejected,
    DataService,
    JobSession,
)
from .transport import (
    DataServiceServer,
    RedoxClient,
    ServiceSuspended,
    SessionClosed,
    TransportError,
)

__all__ = [
    "AdmissionControl",
    "AdmissionRejected",
    "DataService",
    "DataServiceServer",
    "JobSession",
    "RedoxClient",
    "ServiceSuspended",
    "SessionClosed",
    "SharedResidency",
    "TransportError",
    "session_still_needs",
]
