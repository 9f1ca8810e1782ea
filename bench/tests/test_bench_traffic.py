"""The traffic generator: the same inputs from the same seed, the recipe's
length distribution, and the recipe's Markov chain."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench.traffic.generator import BUCKETS, TokenDataset, loss_tokens, quantile_lengths

ROOT = Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (ROOT / "bench" / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_records(name):
    mix = _mix(name)
    a, b = TokenDataset(mix, 504, 2**31 + 9), TokenDataset(mix, 504, 2**31 + 9)
    assert np.array_equal(a.lengths, b.lengths)
    assert all(a[i] == b[i] for i in range(len(a)))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_lengths_in_another_order(name):
    mix = _mix(name)
    a, b = TokenDataset(mix, 32000, 3), TokenDataset(mix, 32000, 4)
    assert np.array_equal(np.sort(a.lengths), np.sort(b.lengths))
    assert not np.array_equal(a.lengths, b.lengths)
    assert a[0] != b[0]
    # whole epochs train the same tokens whatever the seed
    assert loss_tokens(a.lengths, mix["seq_len"]).sum() == loss_tokens(b.lengths,
                                                                      mix["seq_len"]).sum()


@pytest.mark.parametrize("mean_len", [256, 1024])
def test_lengths_follow_the_launchers_recipe(mean_len):
    from repro_torch.data import SyntheticTokenDataset

    n = 20000
    drawn = np.sort(SyntheticTokenDataset(n, 504, mean_len=mean_len, seed=5).lengths)
    ours = quantile_lengths(n, mean_len, 32, 4 * mean_len)
    assert abs(ours.mean() / drawn.mean() - 1) < 0.02
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        i = int(q * n)
        assert abs(ours[i] / drawn[i] - 1) < 0.04, q
    assert ours.max() == drawn.max() == 4 * mean_len


def test_chain_follows_the_recipe():
    vocab = 504
    data = TokenDataset(_mix("frames2k"), vocab, 11)
    width = vocab // BUCKETS
    for i in range(len(data)):
        rec = data.record(i).astype(np.int64)
        assert len(rec) == data.lengths[i] and rec.min() >= 0 and rec.max() < vocab
        center = ((rec[:-1] // width) % BUCKETS * 37 + 11) % vocab
        assert np.all((rec[1:] - center) % vocab < width)


def test_loss_tokens_clip_to_the_row():
    assert loss_tokens(np.array([33, 2049, 5000]), 2048).tolist() == [32, 2048, 2048]


@pytest.mark.parametrize("name", MIXES)
def test_mixes_keep_the_launchers_chunks(name):
    # launch/train.py builds its store with chunks of 16 records
    assert _mix(name)["chunk_size"] == 16


def test_frames512_binds_memory_and_remote_memory(tmp_path):
    """The data-scale mix: Redox's memory holds a quarter of the chunks, and
    the remote-memory budget caps what an owner ships ahead, on a node's
    fullest moment of an epoch."""
    from repro_torch.core import ChunkStore, RedoxLoader, SessionSpec
    from repro_torch.core.chunking import ChunkingPlan

    mix = _mix("frames512")
    data = TokenDataset(mix, 504, 2**31 + 17)
    plan = ChunkingPlan.create(data.sizes_bytes, mix["chunk_size"],
                               memory_bytes=int(data.sizes_bytes.sum() * mix["memory_share"]),
                               seed=1)
    assert plan.num_groups * 4 == plan.num_chunks == 64

    def peaks(remote):
        store = ChunkStore.build(tmp_path / f"c{remote}", plan, data, backend="vfs")
        spec = SessionSpec(policy=mix["policy"], seed=2, sampler_seed=3,
                           num_nodes=mix["nodes"], batch_per_node=mix["batch"] // mix["nodes"],
                           seq_len=mix["seq_len"], engine=mix["engine"],
                           remote_memory_limit_bytes=remote)
        loader = RedoxLoader.from_spec(spec, store)
        assert sum(1 for _ in loader.epoch(0)) == mix["records"] // mix["batch"]
        out = [n.stats.peak_remote_bytes for n in loader.cluster.nodes]
        store.close()
        return out

    budget = mix["remote_memory_bytes"]
    assert min(peaks(1 << 40)) > 1.5 * budget
    assert max(peaks(budget)) <= budget
