"""The port's out-of-process transport against the reference's.

Everything runs over the real transport: Unix sockets and mmap'd rings
under the test's tmpdir. Every comparison is exact (wall-time fields left
out):

* frames: both packages encode the same raw pump step to the same bytes,
  and each decodes the other's frames;
* the wire: port server + port client, reference server + port client and
  port server + reference client each give the reference in-process
  loader's stream, in a thread and in a subprocess trainer;
* a reference server's errors reach the port client as the port's types;
* the client's device half, and the port trainer through a port server.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_service import batch_key, build_twins

import repro.core as ref_core
import repro.service as ref_service
import repro.service.transport.ring as ref_ring
import repro_torch.core as port_core
import repro_torch.service as port_service
import repro_torch.service.transport.ring as port_ring

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"ref": (ref_core, ref_service), "port": (port_core, port_service)}
SPEC = {"seed": 5, "num_nodes": 2, "batch_per_node": 4, "seq_len": 32}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    ref, port = build_twins(tmp_path_factory.mktemp("transport"))
    return {"ref": ref, "port": port}


def reference_stream(root, epochs=1, **spec):
    """The reference in-process loader's stream on the reference twin."""
    store = ref_core.ChunkStore.open(root)
    loader = ref_core.RedoxLoader.from_spec(ref_core.SessionSpec(**{**SPEC, **spec}), store)
    out = [batch_key(b) for e in range(epochs) for b in loader.epoch(e)]
    store.close()
    return out


class Served:
    """One package's DataServiceServer over its twin store, in this process."""

    def __init__(self, side, twins, sock, **service_kw):
        core, service = SIDES[side]
        self.store = core.ChunkStore.open(twins[side])
        self.server = service.DataServiceServer(
            service.DataService(self.store, **service_kw), sock, poll_interval=0.001,
            heartbeat_timeout=30.0).start()
        self.sock = sock

    def close(self):
        self.server.stop()
        self.store.close()


# ------------------------------------------------------------------ frames
def raw_steps(side, root):
    """(raw pump step, assembled batch, seq_len, pad_id) for every step of
    two jobs, from ``side``'s service."""
    core, service = SIDES[side]
    store = core.ChunkStore.open(root)
    svc = service.DataService(store)
    for j in range(2):
        svc.open_session(f"job{j}", core.SessionSpec(**{**SPEC, "seed": 5 + j}))
    out = [(item, batch_key(s.loader._assemble(*item)), s.loader.seq_len, s.loader.pad_id)
           for s, item in svc.co_epoch(0, raw=True)]
    svc.close()
    store.close()
    return out


@pytest.mark.parametrize("side", ["ref", "port"])
def test_frames_cross_both_ways(twins, side):
    steps = raw_steps(side, twins[side])
    assert len(steps) > 4
    for item, want, seq_len, pad_id in steps:
        frames = {}
        for name, ring in (("ref", ref_ring), ("port", port_ring)):
            frames[name] = b"".join(p.tobytes() if isinstance(p, np.ndarray) else p
                                    for p in ring.encode_step_frame(item, seq_len, pad_id))
        assert frames["port"] == frames["ref"]
        for decoder in (ref_ring, port_ring):
            assert batch_key(decoder.decode_batch_frame(frames["ref"])) == want


# -------------------------------------------------------------- the wire
@pytest.mark.parametrize("server_side,client_side", [("port", "port"), ("ref", "port"),
                                                     ("port", "ref")])
@pytest.mark.parametrize("engine", ["replay", "step", "per_access"])
def test_client_streams_equal_reference_loader(twins, tmp_path, server_side, client_side,
                                               engine):
    served = Served(server_side, twins, tmp_path / "svc.sock")
    try:
        core, service = SIDES[client_side]
        spec = core.SessionSpec(**SPEC, engine=engine)
        with service.RedoxClient(served.sock, spec, job_id=f"job-{engine}") as client:
            got = [batch_key(b) for e in range(2) for b in client.epoch(e)]
            assert client.steps_per_epoch(0) == len(got) // 2
    finally:
        served.close()
    assert got == reference_stream(twins["ref"], epochs=2, engine=engine)


def test_two_port_clients_share_one_reference_cache(twins, tmp_path):
    """Two port clients of a reference server in threads: each stream is
    the reference loader's, and the server's cache served shared hits."""
    import threading

    served = Served("ref", twins, tmp_path / "svc.sock")
    spec = port_core.SessionSpec(**SPEC)
    out = {}
    try:
        clients = [port_service.RedoxClient(served.sock, spec, job_id=f"job{j}")
                   for j in range(2)]

        def run(j):
            out[j] = [batch_key(b) for b in clients[j].epoch(0)]

        threads = [threading.Thread(target=run, args=(j,)) for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = clients[0].stats()
        for c in clients:
            c.close()
    finally:
        served.close()
    want = reference_stream(twins["ref"])
    assert out == {0: want, 1: want}
    assert stats["aggregate"]["shared_hits"] > 0


CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro_torch.core import SessionSpec
    from repro_torch.service.transport import RedoxClient

    sock, spec = sys.argv[1], SessionSpec.from_json(json.loads(sys.argv[2]))
    with RedoxClient(sock, spec, job_id="child", connect_timeout=30.0) as client:
        for e in range(2):
            for b in client.epoch(e):
                print(json.dumps({
                    "epoch": e, "step": int(b["step"]),
                    "returned": np.asarray(b["returned"]).tolist(),
                    "tokens": np.asarray(b["tokens"]).tolist(),
                    "mask": np.asarray(b["loss_mask"]).sum(axis=1).tolist()}))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro", "torch"))
    assert not leaked, leaked
""")


@pytest.mark.parametrize("engine", ["replay", "step", "per_access"])
def test_subprocess_port_trainer_against_reference_server(twins, tmp_path, engine):
    served = Served("ref", twins, tmp_path / "svc.sock")
    spec = port_core.SessionSpec(**SPEC, engine=engine)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        out = subprocess.run([sys.executable, "-c", CHILD, str(served.sock),
                              json.dumps(spec.to_json())],
                             capture_output=True, text=True, env=env, timeout=120)
    finally:
        served.close()
    assert out.returncode == 0, out.stderr[-3000:]
    store = ref_core.ChunkStore.open(twins["ref"])
    loader = ref_core.RedoxLoader.from_spec(ref_core.SessionSpec(**SPEC, engine=engine), store)
    want = [{"epoch": e, "step": int(b["step"]), "returned": np.asarray(b["returned"]).tolist(),
             "tokens": b["tokens"].tolist(), "mask": b["loss_mask"].sum(axis=1).tolist()}
            for e in range(2) for b in loader.epoch(e)]
    store.close()
    assert [json.loads(line) for line in out.stdout.splitlines()] == want


# ------------------------------------------------------------- errors
def test_reference_server_errors_arrive_typed(twins, tmp_path):
    served = Served("ref", twins, tmp_path / "svc.sock", admission=ref_service.AdmissionControl(
        bandwidth_bytes_per_s=1.0, compute_per_step_s=0.01))
    (tmp_path / "ck").mkdir()
    (tmp_path / "ck" / "service_manifest.json").write_text(
        json.dumps({"jobs": [{"job_id": "job0", "dir": "job0"}]}))
    try:
        with pytest.raises(port_service.AdmissionRejected, match="storage") as refused:
            port_service.RedoxClient(served.sock, port_core.SessionSpec(**SPEC))
        assert type(refused.value) is port_service.AdmissionRejected
        with pytest.raises(KeyError, match="ghost"):
            port_service.RedoxClient(served.sock, job_id="ghost", resume_from=tmp_path / "ck")
    finally:
        served.close()


def test_port_wire_maps_every_reference_kind():
    from repro.service.transport import wire as ref_wire
    from repro_torch.service.transport import wire

    cases = {ref_service.AdmissionRejected("a"): port_service.AdmissionRejected,
             ref_service.ServiceSuspended("b"): port_service.ServiceSuspended,
             ref_service.SessionClosed("c"): port_service.SessionClosed,
             ref_service.TransportError("d"): port_service.TransportError,
             ValueError("e"): ValueError, KeyError("f"): KeyError, TypeError("g"): TypeError,
             RuntimeError("h"): RuntimeError, ZeroDivisionError("i"): port_service.TransportError}
    for exc, want in cases.items():
        resp = ref_wire.error_response(exc)
        assert wire.error_response(exc) == resp
        with pytest.raises(Exception) as got:
            wire.raise_for(resp)
        assert type(got.value) is want and got.value.args == (str(exc),)


# ------------------------------------------------- the client's device half
def test_epoch_device_on_cpu_equals_epoch(twins, tmp_path):
    served = Served("port", twins, tmp_path / "svc.sock")
    spec = port_core.SessionSpec(**SPEC)
    try:
        with port_service.RedoxClient(served.sock, spec, job_id="host") as client:
            host = [batch_key(b) for b in client.epoch(0)]
        with port_service.RedoxClient(served.sock, spec, job_id="dev") as client:
            staged = list(client.epoch_device(0, device="cpu"))
    finally:
        served.close()
    assert all(isinstance(b["tokens"], torch.Tensor) for b in staged)
    assert [batch_key(b) for b in staged] == host == reference_stream(twins["ref"])


def test_epoch_device_without_a_card_raises(twins, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    served = Served("port", twins, tmp_path / "svc.sock")
    try:
        with port_service.RedoxClient(served.sock, port_core.SessionSpec(**SPEC)) as client:
            with pytest.raises(RuntimeError, match="CUDA"):
                client.epoch_device(0)
            # no fallback: the session is untouched and still serves epoch 0
            assert [batch_key(b) for b in client.epoch(0)] == reference_stream(twins["ref"])
    finally:
        served.close()


# ------------------------------------------------------------- the trainer
def test_trainer_through_port_server_equals_in_process_run(tmp_path):
    """The trainer on its own store, then through a port server over that
    same store: the same batches and the same losses."""
    from repro_torch.launch.train import parse_args, train

    argv = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps", "3", "--num-docs", "64",
            "--seq-len", "32", "--batch", "4", "--device-path", "stage"]
    local_feeds, served_feeds = [], []
    local = train(parse_args(argv + ["--workdir", str(tmp_path / "a")]),
                  on_batch=lambda step, feed: local_feeds.append(batch_key(feed)))
    store = port_core.ChunkStore.open(tmp_path / "a" / "chunks")
    server = port_service.DataServiceServer(port_service.DataService(store),
                                            tmp_path / "svc.sock", poll_interval=0.001).start()
    try:
        served = train(parse_args(argv + ["--workdir", str(tmp_path / "b"),
                                          "--data-server", str(tmp_path / "svc.sock")]),
                       on_batch=lambda step, feed: served_feeds.append(batch_key(feed)))
        want = [batch_key({k: b[k] for k in ("tokens", "targets", "loss_mask")})
                for b in port_core.RedoxLoader.from_spec(served["spec"], store).epoch(0)]
    finally:
        server.stop()
        store.close()
    assert served["spec"] == local["spec"].replace(
        sampler_seed=local["spec"].effective_sampler_seed)
    assert served_feeds == local_feeds == want[:3]
    assert served["losses"] == local["losses"]
    assert not (tmp_path / "b" / "chunks").exists()  # no local data plane
