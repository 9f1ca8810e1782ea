"""The port's copied data plane against the JAX package's: same bytes on
disk, same streams, same packs. Tolerance: exact (byte for byte)."""

from pathlib import Path

import numpy as np
import pytest

from repro.core import RedoxLoader as RefLoader
from repro.core import SessionSpec as RefSpec
from repro.data import SyntheticTokenDataset as RefDataset
from repro_torch.core import RedoxLoader, SessionSpec
from repro_torch.core.device import pack_records
from repro_torch.data import SyntheticTokenDataset

pytestmark = pytest.mark.torch_port

KEYS = ("tokens", "targets", "loss_mask", "returned")


def _build(cls, root, **kw):
    ds = cls(96, vocab_size=97, mean_len=48, seed=3)
    return ds.build_store(root, 4, num_slots=16, seed=1, **kw)


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("codec,bands", [(None, None), ("zlib", 2)])
def test_stores_are_byte_identical_on_disk(tmp_path, codec, bands):
    ref = _build(RefDataset, tmp_path / "ref", codec=codec, bands=bands)
    mine = _build(SyntheticTokenDataset, tmp_path / "port", codec=codec, bands=bands)
    ref.close()
    mine.close()
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert a.keys() == b.keys() and len(a) > 3
    for name in a:
        assert a[name] == b[name], name


@pytest.mark.parametrize("engine", ["replay", "step", "per_access"])
def test_loader_streams_identical(tmp_path, engine):
    spec_kw = dict(seed=5, sampler_seed=7, num_nodes=2, batch_per_node=4,
                   seq_len=32, engine=engine)
    ref_store = _build(RefDataset, tmp_path / "ref")
    port_store = _build(SyntheticTokenDataset, tmp_path / "port")
    ref = list(RefLoader.from_spec(RefSpec(**spec_kw), ref_store).epoch(0))
    mine = list(RedoxLoader.from_spec(SessionSpec(**spec_kw), port_store).epoch(0))
    assert len(ref) == len(mine) > 0
    for r, m in zip(ref, mine):
        assert int(r["step"]) == int(m["step"])
        for k in KEYS:
            assert np.asarray(r[k]).dtype == np.asarray(m[k]).dtype
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(m[k]))


def test_pack_records_identical_at_row_pad_8():
    # repro.core.device imports jax; it is the oracle here.
    from repro.core.device import pack_records as ref_pack

    rng = np.random.default_rng(0)
    for trial in range(5):
        n = int(rng.integers(1, 12))
        recs = [rng.integers(0, 500, int(rng.integers(1, 60))).astype(np.int32)
                for _ in range(n)]
        returned = rng.integers(0, 6, n) if trial % 2 else None
        seq_len = int(rng.integers(4, 40))
        want = ref_pack(recs, returned, seq_len=seq_len, pad_id=3, row_pad=8)
        got = pack_records(recs, returned, seq_len=seq_len, pad_id=3, row_pad=8)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
