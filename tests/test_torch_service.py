"""The port's multi-job data service against the reference's.

Each package builds the same synthetic chunk store from the same seeds
(the data-plane tests hold the two builds byte for byte) and serves two
jobs from its own twin. Every comparison is exact, with only the
wall-time fields left out: each job's stream out of
``DataService.co_epoch``, ``stats_report()`` (storage bytes, demand,
shared hits, evictions), admission control's decisions, and a suspend
mid-epoch followed by a resume. The transport and autotune tests import
this module's twin stores and stream keys.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.service as ref_service
import repro_torch.core as port_core
import repro_torch.service as port_service

pytestmark = pytest.mark.torch_port

NUM_DOCS = 80
VOCAB = 97


def build_twins(root: Path, *, num_docs: int = NUM_DOCS, vocab: int = VOCAB) -> tuple:
    """The same store built by the reference under ``root/ref/chunks`` and
    by the port under ``root/port/chunks``; returns the two roots."""
    from repro.data import SyntheticTokenDataset as RefDataset
    from repro_torch.data import SyntheticTokenDataset

    roots = []
    for cls, side in ((RefDataset, "ref"), (SyntheticTokenDataset, "port")):
        ds = cls(num_docs, vocab, mean_len=40, seed=3)
        store = ds.build_store(root / side / "chunks", 4, num_slots=16, seed=1)
        roots.append(Path(store.root))
        store.close()
    return tuple(roots)


def timeless(obj):
    """``obj`` as plain comparable values, every wall-time field (a key
    ending in ``_s``: ``read_wait_s``, ``decode_s``, ``stage_s`` ...) left
    out; arrays become (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {str(k): timeless(v) for k, v in obj.items() if not str(k).endswith("_s")}
    if isinstance(obj, (list, tuple)):
        return [timeless(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    if hasattr(obj, "numpy"):  # a torch tensor
        return timeless(obj.numpy())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def batch_key(batch):
    """Everything deterministic about a GlobalBatch."""
    return timeless(dict(batch))


SIDES = {"ref": (ref_core, ref_service), "port": (port_core, port_service)}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    ref, port = build_twins(tmp_path_factory.mktemp("service"))
    return {"ref": ref, "port": port}


def open_service(side, root, engines=("replay", "replay"), **kw):
    core, service = SIDES[side]
    store = core.ChunkStore.open(root)
    svc = service.DataService(store, **kw)
    for j, engine in enumerate(engines):
        svc.open_session(f"job{j}", core.SessionSpec(
            seed=2 + 10 * j, num_nodes=2, batch_per_node=4, seq_len=32, engine=engine))
    return store, svc


def pump(side, root, **kw):
    store, svc = open_service(side, root, **kw)
    stream = [(job, batch_key(b)) for job, b in svc.co_epoch(0)]
    report = timeless(svc.stats_report())
    svc.close()
    store.close()
    return stream, report


@pytest.mark.parametrize("eviction", ["belady", "lru"])
@pytest.mark.parametrize("co_refill", [False, True])
@pytest.mark.parametrize("engine", ["replay", "step", "per_access"])
def test_co_epoch_and_stats_match_reference(twins, engine, co_refill, eviction):
    store = ref_core.ChunkStore.open(twins["ref"])
    cap = int(np.asarray(store.plan.chunk_bytes).sum()) // 3
    store.close()
    kw = dict(engines=(engine, engine), co_refill=co_refill, eviction=eviction,
              cache_limit_bytes=cap)
    ref_stream, ref_report = pump("ref", twins["ref"], **kw)
    port_stream, port_report = pump("port", twins["port"], **kw)
    assert {job for job, _ in ref_stream} == {"job0", "job1"}
    assert port_stream == ref_stream
    assert port_report == ref_report
    agg = port_report["aggregate"]
    assert agg["physical_bytes"] > 0
    assert sum(port_report["bytes_per_job"].values()) == agg["physical_bytes"] + agg["shared_bytes"]


def test_uncapped_co_refill_shares_bytes_like_reference(twins):
    ref_stream, ref_report = pump("ref", twins["ref"], co_refill=True)
    port_stream, port_report = pump("port", twins["port"], co_refill=True)
    assert port_stream == ref_stream and port_report == ref_report
    assert port_report["aggregate"]["shared_hits"] > 0
    assert port_report["aggregate"]["co_refill_hits"] > 0


def admission_run(side, root):
    """Admit one job under 1.5x its rate, refuse a second, admit it once
    the first closes; return the reports and the refusal."""
    core, service = SIDES[side]
    store = core.ChunkStore.open(root)
    probe = service.DataService(store)
    steps = probe.open_session("p", core.SessionSpec(seed=0, batch_per_node=8,
                                                     seq_len=32)).steps_per_epoch(0)
    probe.close()
    rate = float(np.asarray(store.plan.chunk_bytes).sum()) / (steps * 0.01)
    svc = service.DataService(store, admission=service.AdmissionControl(
        bandwidth_bytes_per_s=rate * 1.5, compute_per_step_s=0.01))
    svc.open_session("j0", core.SessionSpec(seed=0, batch_per_node=8, seq_len=32))
    reports = [svc.admission_report()]
    with pytest.raises(service.AdmissionRejected) as refused:
        svc.open_session("j1", core.SessionSpec(seed=1, batch_per_node=8, seq_len=32))
    svc.close_session("j0")
    svc.open_session("j1", core.SessionSpec(seed=1, batch_per_node=8, seq_len=32))
    reports.append(svc.admission_report())
    svc.close()
    store.close()
    return reports, refused.value


def test_admission_control_matches_reference(twins):
    ref_reports, ref_err = admission_run("ref", twins["ref"])
    port_reports, port_err = admission_run("port", twins["port"])
    assert port_reports == ref_reports
    assert str(port_err) == str(ref_err) and "storage" in str(port_err)
    assert type(port_err) is port_service.AdmissionRejected
    assert not isinstance(port_err, ref_service.AdmissionRejected)


def test_queued_admission_times_out_typed(twins):
    store = port_core.ChunkStore.open(twins["port"])
    svc = port_service.DataService(store, admission=port_service.AdmissionControl(
        bandwidth_bytes_per_s=1.0, compute_per_step_s=0.01, mode="queue",
        queue_timeout_s=0.2))
    with pytest.raises(port_service.AdmissionRejected, match="queued"):
        svc.open_session("j0", port_core.SessionSpec(seed=0, batch_per_node=8, seq_len=32))
    svc.close()
    store.close()


@pytest.mark.parametrize("engines", [("replay", "replay"), ("step", "replay"),
                                     ("per_access", "step")])
def test_suspend_and_resume_continue_the_reference_stream(twins, tmp_path, engines):
    want, _ = pump("ref", twins["ref"], engines=engines)
    store, svc = open_service("port", twins["port"], engines=engines)
    got = []
    stream = svc.co_epoch(0)
    for job, b in stream:
        got.append((job, batch_key(b)))
        if len(got) == 5:  # mid-round: job0 is one step ahead of job1
            break
    stream.close()
    svc.suspend(tmp_path / "ck")
    svc.close()
    store.close()

    store = port_core.ChunkStore.open(twins["port"])
    svc = port_service.DataService.resume(tmp_path / "ck", store)
    got += [(job, batch_key(b)) for job, b in svc.co_epoch(0)]
    assert not svc.residency.has_claims() and svc.residency.cache_bytes == 0
    svc.close()
    store.close()
    assert got == want


def test_independent_sessions_match_reference(twins):
    """JobSession.epoch consumed job by job, sharing bytes through the
    residency, as the reference's."""
    out = {}
    for side in ("ref", "port"):
        store, svc = open_service(side, twins[side])
        out[side] = ([batch_key(b) for s in svc.sessions for b in s.epoch(0)],
                     timeless(svc.stats_report()))
        svc.close()
        store.close()
    assert out["port"] == out["ref"]
    assert out["port"][1]["aggregate"]["shared_hits"] > 0
