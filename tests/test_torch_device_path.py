"""The port's DeviceStager on the CPU: the contract of tests/test_device_path.py.

The device path is a pure transport: ``epoch_device`` / ``stream`` yield
byte-identical tokens/targets/loss_mask to the host epoch, annotate (not
corrupt) the per-step IO accounting, and never strand staged buffers,
whatever the consumer does.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import Cluster, EpochSampler, RedoxLoader
from repro_torch.core.device import DeviceStager, HostPack, pack_records
from repro_torch.data import SyntheticTokenDataset

pytestmark = pytest.mark.torch_port


def build_loader(tmp_path, *, nodes=1, batch_per_node=8, seq_len=32, **kw):
    ds = SyntheticTokenDataset(96, vocab_size=97, mean_len=48, seed=3)
    store = ds.build_store(tmp_path / "chunks", 4, num_slots=16, seed=1)
    cluster = Cluster(store.plan, nodes, store=store, seed=2)
    sampler = EpochSampler(96, nodes, seed=4)
    return store, RedoxLoader(
        cluster, sampler, batch_per_node=batch_per_node, seq_len=seq_len, **kw
    )


def grids(b):
    return tuple(np.asarray(b[k]) for k in ("tokens", "targets", "loss_mask"))


def test_pack_dedup_and_padding():
    recs = [np.arange(5, dtype=np.int32), np.arange(9, dtype=np.int32),
            np.arange(5, dtype=np.int32)]
    returned = np.asarray([40, 7, 40])  # rows 0 and 2 share a file
    slots, lens, idx = pack_records(recs, returned, seq_len=16,
                                    row_pad=DeviceStager.row_pad)
    assert slots.shape == (2, 24)  # 2 unique files, 17 -> pad to 24
    np.testing.assert_array_equal(idx, [1, 0, 1])
    assert lens[0] == 9 and lens[1] == 5


def test_pack_views_equal_pack_records():
    """The one staged buffer holds idx | lens | pad | slot rows; its three
    views equal pack_records' arrays, the slot rows on a 16-byte boundary."""
    rng = np.random.default_rng(0)
    recs = [rng.integers(1, 97, n).astype(np.int32) for n in (5, 40, 17, 33, 1)]
    returned = np.asarray([3, 9, 3, 4, 8])
    packed = pack_records(recs, returned, seq_len=32, row_pad=DeviceStager.row_pad)
    stager = DeviceStager(device="cpu")
    views = stager._put_pack(HostPack(slot_tokens=packed[0], lens=packed[1], idx=packed[2]))
    for view, arr in zip(views, packed):
        assert view.dtype == torch.int32 and view.is_contiguous()
        np.testing.assert_array_equal(view.numpy(), arr)
    slot, lens, idx = views
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1
    assert idx.storage_offset() == 0 and lens.storage_offset() == idx.numel()
    assert slot.storage_offset() % 4 == 0 and slot.data_ptr() % 16 == 0
    assert slot.storage_offset() - (idx.numel() + lens.numel()) < 4


@pytest.mark.parametrize("device_path,copies", [("gather", 1), ("grid", 3)])
def test_one_copy_per_staged_batch(tmp_path, monkeypatch, device_path, copies):
    """A staged pack is one host->device copy (the gather's three inputs in
    one buffer); an assembled batch stays three."""
    made = []
    real = DeviceStager._copy

    def counted(self, host):
        made.append(host.numel())
        return real(self, host)

    monkeypatch.setattr(DeviceStager, "_copy", counted)
    store, loader = build_loader(tmp_path, nodes=2, batch_per_node=4)
    host = [grids(b) for b in loader.epoch(0)]
    stager = DeviceStager(device="cpu")
    if device_path == "gather":
        staged = [grids(b) for b in loader.epoch_device(0, stager)]
    else:
        staged = [grids(b) for b in stager.stream(loader.epoch_async(0))]
    assert len(staged) == len(host) == stager.stats.steps > 0
    assert len(made) == copies * stager.stats.steps
    for h, d in zip(host, staged):
        for a, b in zip(h, d):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nodes,batch_per_node", [(1, 8), (2, 4)])
def test_epoch_device_matches_host_epoch_bytes(tmp_path, nodes, batch_per_node):
    store, loader = build_loader(tmp_path, nodes=nodes, batch_per_node=batch_per_node)
    host = [grids(b) + (int(b["step"]),) for b in loader.epoch(0)]
    stager = DeviceStager(device="cpu")
    dev = []
    for b in loader.epoch_device(0, stager):
        assert all(isinstance(b[k], torch.Tensor) for k in ("tokens", "targets"))
        assert "_ready" not in b
        dev.append(grids(b) + (int(b["step"]),))
    assert len(host) == len(dev) > 0
    for h, d in zip(host, dev):
        assert h[3] == d[3]  # step
        for a, b in zip(h[:3], d[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert stager.stats.kernel_steps == len(dev)  # gather path taken every step
    assert stager.stats.bytes_to_device > 0
    assert stager.live_buffers == 0


def test_grid_stream_matches_host_epoch(tmp_path):
    """Pre-assembled batches (the stage path): no gather."""
    store, loader = build_loader(tmp_path)
    host = [grids(b) for b in loader.epoch(0)]
    stager = DeviceStager(device="cpu")
    dev = [grids(b) for b in stager.stream(loader.epoch_async(0))]
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        for a, b in zip(h, d):
            np.testing.assert_array_equal(a, b)
    assert stager.stats.kernel_steps == 0
    assert stager.stats.steps == len(host)


def test_io_accounting_annotated_not_corrupted(tmp_path):
    store, loader = build_loader(tmp_path)
    stager = DeviceStager(device="cpu")
    staged = list(loader.epoch_device(0, stager))
    for b in staged:
        assert b["stage_s"] >= 0.0 and b["stage_wait_s"] >= 0.0
        io = b["io_by_node"]
        assert sum(s.stage_s for s in io.values()) == pytest.approx(b["stage_s"])
    assert stager.stats.loss_tokens == sum(int(b["loss_mask"].sum()) for b in staged) > 0
    for b in loader.epoch(1):
        for s in b["io_by_node"].values():
            assert s.stage_s == 0.0 and s.stage_wait_s == 0.0


def test_use_kernel_false_rejects_packs():
    stager = DeviceStager(device="cpu", use_kernel=False)
    with pytest.raises(ValueError, match="cannot stage HostPacks"):
        stager.stage(HostPack(slot_tokens=np.zeros((1, 8), np.int32)))


def test_bad_index_raises_before_the_copy():
    stager = DeviceStager(device="cpu")
    pack = HostPack(slot_tokens=np.zeros((2, 8), np.int32),
                    lens=np.ones(2, np.int32), idx=np.asarray([0, 5], np.int32),
                    seq_len=4, pad_id=0, step=0)
    with pytest.raises(IndexError, match="out of range"):
        stager.stage(pack)
    assert stager.stats.steps == 0 and stager.stats.bytes_to_device == 0


def test_stream_is_one_at_a_time(tmp_path):
    store, loader = build_loader(tmp_path)
    stager = DeviceStager(device="cpu")
    gen = stager.stream(loader.epoch_async(0))
    next(gen)
    with pytest.raises(RuntimeError, match="one-at-a-time"):
        next(stager.stream(iter([])))
    with pytest.raises(RuntimeError, match="stream is active"):
        stager.close()
    gen.close()
    stager.close()  # fine once torn down


def test_abandoned_consumer_releases_buffers(tmp_path):
    store, loader = build_loader(tmp_path, queue_depth=1)
    stager = DeviceStager(device="cpu", depth=1)
    gen = loader.epoch_device(0, stager)
    next(gen)
    deadline = time.monotonic() + 5.0
    while stager.live_buffers == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert stager.live_buffers > 0
    gen.close()
    loader._worker.join(timeout=5.0)
    assert not loader._worker.is_alive(), "protocol worker leaked"
    stager._thread.join(timeout=5.0)
    assert not stager._thread.is_alive(), "staging thread leaked"
    assert stager.live_buffers == 0, "staged buffers stranded"
    assert stager.stats.buffers_released >= 1


def test_worker_error_propagates_through_stager(tmp_path):
    store, loader = build_loader(tmp_path)
    calls = {"n": 0}
    real = store.read_chunk

    def flaky(chunk):
        calls["n"] += 1
        if calls["n"] > 3:
            raise OSError("injected storage failure")
        return real(chunk)

    store.read_chunk = flaky
    stager = DeviceStager(device="cpu")
    with pytest.raises(OSError, match="injected storage failure"):
        for _ in loader.epoch_device(0, stager):
            pass
    assert stager.live_buffers == 0
