"""The port's tracer (``repro_torch.obs``): spans, device spans, one clock
with ``torch.profiler``, attribution, and the benchmark's readers of the
program's spans.

On the CPU: the disabled path is the shared no-op span and loads no torch;
the ring counts what it drops; the Chrome export and ``realtime_ns`` put
the tracer's times on CLOCK_REALTIME, the profiler's clock, which a
``record_function`` range around the same sleep confirms; a device span
off the card is a host span, and through stand-in CUDA events its
interval maps through the two anchors, drift included, and records
nothing while the stream captures; ``attribution`` counts device
intervals; the launcher traces its feeds and steps without synchronising;
``bench/metrics/data.stall_share.py`` and ``step.replay_ms.py`` on
hand-made spans. On the card: a replay's ``train.step`` interval against
the profiler's device operations, and nothing recorded during capture.
"""

import importlib.util
import json
import statistics
import subprocess
import sys
import time
import tracemalloc
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.obs import attribution, trace, tracing
from repro_torch.obs.tracer import _NULL_SPAN
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.train_step import GraphTrain, build_train_step, fresh_train_state

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
TRACER = ROOT / "src" / "repro_torch" / "obs" / "tracer.py"


def _reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reader_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ------------------------------------------------------------------ tracer
def test_disabled_path_is_the_shared_noop_and_loads_no_torch():
    assert trace.get() is None
    assert trace.span("a", "read", chunk=1) is trace.span("b", "stage") is _NULL_SPAN
    tracemalloc.start()
    try:
        with trace.span("warm", "decode", step=0) as s:
            s.note(loss_tokens=1)
        before = tracemalloc.get_traced_memory()[0]
        for i in range(10_000):
            with trace.span("loader.pack", "decode", step=i) as s:
                s.note(loss_tokens=i)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024, f"the disabled path kept {grown} bytes"
    with tracing() as t:
        pass
    assert len(t) == 0 and t.dropped == 0
    # The module alone loads no torch: off, nor on for a span off the card.
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('tracer', {str(TRACER)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "assert m.get() is None\n"
        "with m.span('loader.pack', 'decode') as s: s.note(loss_tokens=3)\n"
        "with m.tracing() as t:\n"
        "    with t.device_span('train.step', 'compute', 'cpu', step=1): pass\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
        "assert len(t) == 1\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)


def test_ring_overflow_counts_dropped():
    with tracing(capacity=4) as t:
        for i in range(10):
            with trace.span(f"e{i}", "read"):
                pass
    assert len(t) == 4 and t.dropped == 6
    assert [e[0] for e in t.events()] == ["e6", "e7", "e8", "e9"]
    assert t.to_chrome()["otherData"]["dropped_events"] == 6


def test_host_tally_changes_read_per_name(monkeypatch):
    """A host tally is made once with its keys at 0 and shared by name;
    ``tallies_since`` gives each tally's change over a copy, keys added
    since counted from 0, and the copy does not follow later adds."""
    monkeypatch.setattr(trace, "_TALLIES", {})
    a = trace.host_tally("x.calls", "n", "flops")
    assert a == {"n": 0, "flops": 0} and trace.host_tally("x.calls") is a
    before = trace.tallies()
    a["n"] += 2
    a["flops"] += 10
    b = trace.host_tally("y.rows", "rows")
    b["rows"] += 3
    assert trace.tallies_since(before) == {"x.calls": {"n": 2, "flops": 10},
                                           "y.rows": {"rows": 3}}
    assert before == {"x.calls": {"n": 0, "flops": 0}}


def test_chrome_export_carries_the_realtime_origin(tmp_path):
    with tracing() as t:
        with trace.span("loader.pack", "decode", step=3) as s:
            s.note(loss_tokens=40)
        now_real, now = time.time_ns(), time.perf_counter()
    ((_, _, ts, dur, _, args),) = t.events()
    assert args == {"step": 3, "loss_tokens": 40}
    # now, on the tracer's clock put on CLOCK_REALTIME, is now
    assert abs(t.realtime_ns(now - t._epoch) - now_real) < 100_000
    assert t.realtime_ns(ts + dur) < now_real
    doc = json.loads(t.dump(tmp_path / "t.json").read_text())
    assert doc["otherData"]["realtime_origin_ns"] == t.realtime_origin_ns
    assert doc["otherData"]["device_clock"] is None  # no device span ran
    (x,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert x["args"] == {"step": 3, "loss_tokens": 40}


def test_span_and_record_function_agree_on_the_profilers_clock():
    """A span and a ``record_function`` range around the same sleep, the
    span put on the profiler's clock: within 1 ms at both ends."""
    with record_function("warm"):  # the first range pays a set-up
        pass
    with tracing() as t, profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("obs.sleep"), trace.span("obs.sleep", "compute"):
                time.sleep(0.02)
    spans = [(t.realtime_ns(ts), t.realtime_ns(ts + dur)) for _, _, ts, dur, _, _ in t.events()]
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name() == "obs.sleep")
    assert len(spans) == len(ranges) == 3
    for (s0, s1), (r0, r1) in zip(spans, ranges):
        assert abs(s0 - r0) < 1e6 and abs(s1 - r1) < 1e6, (s0 - r0, s1 - r1)


def test_device_span_on_the_cpu_records_no_interval():
    with tracing() as t:
        with t.device_span("train.feed", "compute", torch.device("cpu"), step=2):
            pass
        with t.device_span("train.step", "compute", "cpu", step=2, replay=False):
            pass
    events = t.events()
    assert [e[5] for e in events] == [{"step": 2}, {"step": 2, "replay": False}]
    assert t.device_clock is None


class FakeCuda:
    """``torch.cuda``'s streams and timing events without a card: an event
    takes the device clock's time when recorded, and the device clock runs
    ``rate`` times the host's from an offset, so only the anchors' map puts
    it on the host's."""

    rate, offset_s = 1.01, 123.0

    def __init__(self):
        self.capturing = False
        self.events = []  # every event, with the host time of its record

    def now(self) -> float:
        return self.offset_s + self.rate * time.perf_counter()

    def install(self, monkeypatch):
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = self.host = None
                fake.events.append(self)

            def record(self, stream=None):
                self.t, self.host = fake.now(), time.perf_counter()

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: "private")
        monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: "current")
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: fake.capturing)


def test_device_interval_maps_through_the_anchors(monkeypatch):
    """Stand-in events on a device clock 1% fast and offset: the resolved
    interval is the host times of its two events' records within 20 µs
    (uncorrected, the drift alone would put its start 0.5 ms off); a span
    while the stream captures records nothing."""
    fake = FakeCuda()
    fake.install(monkeypatch)
    cuda = torch.device("cuda", 0)
    with tracing() as t:
        with t.device_span("stager.stage", "stage", cuda, step=0):
            pass  # the first device span records the first anchor
        time.sleep(0.05)
        fake.capturing = True
        with t.device_span("train.step", "compute", cuda, step=1):
            pass
        fake.capturing = False
        with t.device_span("train.step", "compute", cuda, step=2, replay=True):
            time.sleep(0.01)
    events = t.events()
    assert [(e[0], e[5]["step"]) for e in events] == [("stager.stage", 0), ("train.step", 2)]
    _, _, ts, dur, _, args = events[1]
    # made: the first anchor, step 0's pair, step 2's pair, the read-out anchor
    assert len(fake.events) == 6
    start, end = fake.events[3:5]
    assert abs(args["dev_ts"] - (start.host - t._epoch)) < 2e-5
    assert abs(args["dev_dur"] - (end.host - start.host)) < 2e-5
    assert args["dev_ts"] <= ts and args["dev_ts"] + args["dev_dur"] >= ts + dur
    assert set(args) == {"step", "replay", "dev_ts", "dev_dur"}
    clock = t.device_clock
    assert clock["scale"] == pytest.approx(1 / fake.rate, rel=1e-4)
    assert clock["drift_s"] < 0  # the device clock ran ahead
    assert t.to_chrome()["otherData"]["device_clock"] == clock


def test_attribution_counts_a_span_by_its_device_interval():
    events = [
        ("train.step", "compute", 0.0, 0.001, 0, {"step": 1, "dev_ts": 0.5, "dev_dur": 1.0}),
        ("stager.wait", "stage", 1.2, 0.3, 0, {"step": 2}),
    ]
    att = attribution(events)
    assert att["busy_s"]["compute"] == pytest.approx(1.0)
    assert att["busy_s"]["stage"] == pytest.approx(0.3)
    assert att["wall_s"] == pytest.approx(1.0)  # 0.5 .. 1.5
    assert att["exclusive_s"]["stage"] == pytest.approx(0.0)  # hidden behind the step
    assert att["idle_s"] == pytest.approx(0.0)


def test_launcher_traces_feed_and_step_and_counts_loss_tokens(tmp_path, monkeypatch, capsys):
    """The launcher on the CPU under ``--trace``: a ``train.feed`` and a
    ``train.step`` span a step, each carrying its step, none of them
    synchronising; the stager's ``loss_tokens`` is the fed loss masks' sum
    and the packs' own count; positions and loss-bearing tokens printed."""
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a traced CPU run synchronised"))
    fed = []
    args = port_train.parse_args([
        "--arch", "tinyllama-1.1b", "--device", "cpu", "--device-path", "gather",
        "--steps", "3", "--num-docs", "64", "--seq-len", "32", "--batch", "4",
        "--workdir", str(tmp_path / "w"), "--trace", str(tmp_path / "t.json")])
    summary = port_train.train(args, on_batch=lambda step, feed: fed.append(feed))
    doc = json.loads((tmp_path / "t.json").read_text())
    by = {}
    for e in doc["traceEvents"]:
        by.setdefault(e["name"], []).append(e.get("args", {}))
    assert [a["step"] for a in by["train.step"]] == [1, 2, 3]
    assert not any(a["replay"] for a in by["train.step"])
    assert [a["step"] for a in by["train.feed"]] == [0, 1, 2]
    assert all(a["epoch"] == 0 for a in by["train.feed"] + by["loader.pack"])
    waited = [a["step"] for a in by["stager.wait"]]
    assert waited == [0, 1, 2]
    packs = {a["step"]: a["loss_tokens"] for a in by["loader.pack"]}
    fed_tokens = [int(f["loss_mask"].sum()) for f in fed]
    assert [packs[s] for s in waited] == fed_tokens
    assert summary["device_stats"].loss_tokens == sum(fed_tokens) > 0
    assert summary["loss_tokens_per_s"] > 0
    out = capsys.readouterr().out
    assert "positions/sec" in out and "loss-bearing tokens/sec" in out
    assert "ms a batch" in out and "overlap" not in out


# ----------------------------------------------------------------- readers
def _ctx(spans, window_s=10.0):
    return types.SimpleNamespace(spans=spans, window_s=window_s)


def _step(ts, dev_ts, dev_dur, tid=0, n=1):
    return ("train.step", "compute", ts, 0.001, tid, {"step": n, "replay": True,
                                                      "dev_ts": dev_ts, "dev_dur": dev_dur})


def _wait(ts, dur, tid=0):
    return ("stager.wait", "stage", ts, dur, tid, {"step": 0})


@pytest.mark.parametrize("case,want", [
    ("nothing_running", 100.0 * 0.5 / 10.0),
    ("covered_by_a_queued_step", 0.0),
    ("half_covered", 100.0 * 0.25 / 10.0),
    ("feed_covers", 0.0),
    ("another_threads_wait", 0.0),
])
def test_stall_share_reader(case, want):
    """A wait with no step running counts whole; one that a step queued on
    the card covers counts 0; a feed's device interval covers as a step's
    does; only the trainer's thread's waits count."""
    steps = [_step(0.0, 0.0, 1.0), _step(1.0, 3.0, 1.0, n=2)]
    wait = {"nothing_running": _wait(2.0, 0.5),
            "covered_by_a_queued_step": _wait(0.2, 0.5),
            "half_covered": _wait(0.75, 0.5),
            "feed_covers": _wait(2.0, 0.5),
            "another_threads_wait": _wait(2.0, 0.5, tid=1)}[case]
    spans = steps + [wait]
    if case == "feed_covers":
        spans.append(("train.feed", "compute", 1.9, 0.001, 0,
                      {"step": 1, "dev_ts": 1.9, "dev_dur": 0.7}))
    assert _reader("data.stall_share")(_ctx(spans)) == pytest.approx(want)


def test_stall_share_is_silent_without_device_timed_steps():
    """The program before device spans: host spans only, no reading."""
    spans = [_wait(0.0, 0.5), ("loader.pack", "decode", 0.1, 0.001, 1, {"step": 0})]
    assert _reader("data.stall_share")(_ctx(spans)) is None
    assert _reader("step.replay_ms")(_ctx(spans)) is None


def test_replay_ms_reader_is_the_mean_device_duration():
    spans = [_step(0.0, 0.0, 1.0), _step(1.0, 1.0, 2.0, n=2), _wait(0.0, 0.1),
             ("train.feed", "compute", 0.0, 0.001, 0, {"step": 0, "dev_ts": 0.0, "dev_dur": 5.0})]
    assert _reader("step.replay_ms")(_ctx(spans)) == pytest.approx(1500.0)


# ---------------------------------------------------------------- the card
def _cuda_step():
    cfg = reduced(get_config("tinyllama-1.1b"))
    run = RunConfig(remat="dots")
    model = build_model(cfg, device="cuda").init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 65), generator=gen, dtype=torch.int32)
    feed = {"tokens": tokens[:, :-1].cuda(), "targets": tokens[:, 1:].cuda(),
            "loss_mask": torch.ones(4, 64, device="cuda")}
    return build_train_step(model, run, opt), state, feed


def test_cuda_replay_interval_matches_the_profilers_device_ops():
    """Needs a card: four replays of a reduced tinyllama step, each queued
    behind 1 ms of device work as a trainer's step is queued behind the
    last, and synchronised before the next. Each ``train.step`` span's
    device interval, put on the profiler's clock, starts and ends within
    0.1 ms (median) of the first and last device operation the profiler
    shows for that step: those whose launch (the runtime call with the
    operation's correlation id) came while the step's span was open."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    from torch.autograd import DeviceType

    step, state, feed = _cuda_step()
    for _ in range(2):  # step 1 and the capture, then a replay
        step(state, feed)
    torch.cuda.synchronize()
    with tracing() as t, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda._sleep(2_000_000)  # about 1 ms of cycles at the H100's clock
            step(state, feed)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.name().startswith("cuda")}
    ops = [(launched.get(e.correlation_id()), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in events if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    spans = [(ts, dur, a) for name, _, ts, dur, _, a in t.events() if name == "train.step"]
    assert len(spans) == 5 and all(a["replay"] for *_, a in spans)
    starts, ends = [], []
    for ts, dur, a in spans[1:]:  # the first pays the profiler's first calls
        lo, hi = t.realtime_ns(ts), t.realtime_ns(ts + dur)
        mine = [(s, e) for at, s, e in ops if at is not None and lo <= at <= hi]
        assert mine, f"no device operation for step {a['step']}"
        starts.append(abs(t.realtime_ns(a["dev_ts"]) - min(s for s, _ in mine)))
        ends.append(abs(t.realtime_ns(a["dev_ts"] + a["dev_dur"]) - max(e for _, e in mine)))
    print(f"start gaps {starts} ns, end gaps {ends} ns; device clock {t.device_clock}")
    assert statistics.median(starts + ends) <= 100_000


def test_cuda_capture_records_nothing():
    """Needs a card: traced from the first call, ``GraphTrain`` records
    the eager step 1 (``replay=False``, on its warm-up stream) and each
    replay, and nothing while it captures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    step, state, feed = _cuda_step()
    with tracing() as t:
        step(state, feed)
        assert isinstance(step, GraphTrain) and step.captured
        step(state, feed)
        torch.cuda.synchronize()
    events = t.events()
    assert [(e[0], e[5]["step"], e[5]["replay"]) for e in events] == [
        ("train.step", 1, False), ("train.step", 2, True)]
    assert all(e[5]["dev_dur"] > 0 for e in events)
