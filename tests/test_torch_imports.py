"""The port stands alone: it imports no JAX and nothing of the JAX package,
and without a card its entry points refuse to run instead of falling back
to the CPU."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


#: The torch twins of the JAX examples: they import nothing banned, and
#: run on the card unless ``--device cpu``.
TWINS = ["serve_decode_torch.py", "train_lm_torch.py"]
TWIN_CPU_ARGS = {"serve_decode_torch.py": ["--batch", "2", "--prompt-len", "8",
                                           "--new-tokens", "3"],
                 "train_lm_torch.py": ["--preset", "small", "--steps", "2", "--ckpt-every", "2"]}


def test_no_jax_or_reference_imports_in_port_sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py")))
    assert len(files) >= 90
    bad = []
    for f in files:
        for mod in _imports(f):
            if mod.split(".")[0] in BANNED:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_run_without_loading_jax(name, tmp_path):
    """The twin runs on the CPU under ``--device cpu``, and neither JAX
    nor the reference package is ever imported."""
    argv = TWIN_CPU_ARGS[name] + ["--device", "cpu"]
    if name.startswith("train"):
        argv += ["--workdir", str(tmp_path)]
    script = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = [{name!r}, *{argv!r}]
        runpy.run_path({str(ROOT / "examples" / name)!r}, run_name="__main__")
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("rel", ["models/moe.py", "models/xlstm.py", "models/transformer.py"])
def test_scan_covers_every_model_module(rel):
    """The scan above walks the package, so each model module is in it,
    and each imports torch and nothing banned."""
    assert PORT / rel in set(PORT.rglob("*.py"))
    mods = list(_imports(PORT / rel))
    assert "torch" in mods and not [m for m in mods if m.split(".")[0] in BANNED]


@pytest.mark.parametrize("rel", ["parallel/__init__.py", "parallel/axes.py",
                                 "parallel/sharding.py", "launch/mesh.py", "launch/specs.py",
                                 "launch/dryrun_lib.py", "launch/dryrun.py",
                                 "launch/roofline.py"])
def test_scan_covers_the_sharding_and_dry_run_modules(rel):
    """The multi-device layer and the dry run are in the scan too; each
    imports nothing banned, and torch where it computes (the roofline is
    plain Python)."""
    assert PORT / rel in set(PORT.rglob("*.py"))
    mods = list(_imports(PORT / rel))
    assert not [m for m in mods if m.split(".")[0] in BANNED]
    pure = ("parallel/__init__.py", "launch/roofline.py")
    assert rel in pure or any(m.split(".")[0] == "torch" for m in mods)


def test_port_runs_loader_and_train_step_without_loading_jax(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from repro_torch.configs import get_config, reduced, RunConfig
        from repro_torch.core import Cluster, EpochSampler, RedoxLoader
        from repro_torch.core.device import DeviceStager
        from repro_torch.data import SyntheticTokenDataset
        from repro_torch.models import build_model
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.train.train_step import build_train_step, init_train_state

        cfg = reduced(get_config("tinyllama-1.1b"))
        ds = SyntheticTokenDataset(64, vocab_size=cfg.vocab_size, mean_len=24, seed=3)
        store = ds.build_store({str(tmp_path / "chunks")!r}, 4, num_slots=16, seed=1)
        loader = RedoxLoader(Cluster(store.plan, 1, store=store, seed=2),
                             EpochSampler(64, 1, seed=4), batch_per_node=4, seq_len=16)
        stager = DeviceStager(device="cpu")
        batches = list(loader.epoch_device(0, stager))
        assert batches and stager.stats.kernel_steps == len(batches)
        model = build_model(cfg, device="cpu")
        run = RunConfig()
        opt = make_optimizer(run)
        state = init_train_state(model, opt, 0)
        feed = {{k: batches[0][k] for k in ("tokens", "targets", "loss_mask")}}
        state, metrics = build_train_step(model, run, opt)(state, feed)
        assert np.isfinite(float(metrics["loss"]))
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_data_service_runs_without_loading_jax_or_torch(tmp_path):
    """A port server thread and a client run an epoch, and neither JAX, the
    reference package nor torch is ever imported."""
    script = textwrap.dedent(f"""
        import sys
        from repro_torch.core import ChunkStore, SessionSpec
        from repro_torch.data import SyntheticTokenDataset
        from repro_torch.service import DataService, DataServiceServer, RedoxClient

        ds = SyntheticTokenDataset(64, vocab_size=97, mean_len=24, seed=3)
        store = ds.build_store({str(tmp_path / "chunks")!r}, 4, num_slots=16, seed=1)
        spec = SessionSpec(seed=2, num_nodes=2, batch_per_node=4, seq_len=16)
        with DataServiceServer(DataService(store), {str(tmp_path / "svc.sock")!r}) as server:
            with RedoxClient(server.socket_path, spec, job_id="job0") as client:
                batches = list(client.epoch(0))
        assert len(batches) == 8, len(batches)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "ml_dtypes", "repro", "torch"))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core.device import DeviceStager
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import build_model
    from repro_torch.configs import get_config, reduced

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStager()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(reduced(get_config("tinyllama-1.1b")))
    assert resolve_device("cpu") == torch.device("cpu")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
         "--steps", "1"],
        capture_output=True, text=True, env=_env(), timeout=240, cwd=ROOT,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_refuse_to_run_without_a_card(name, tmp_path):
    """Without ``--device cpu`` a twin exits non-zero and names CUDA
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), *TWIN_CPU_ARGS[name]],
        capture_output=True, text=True, env=_env(), timeout=240, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert not list(tmp_path.iterdir())  # nothing built, nothing written


def test_port_serves_without_loading_jax():
    script = textwrap.dedent("""
        import sys
        from repro_torch.launch.serve import main
        rc = main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "12", "--new-tokens", "4"])
        assert rc == 0, rc
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "first sequence:" in out.stdout and out.stdout.strip().endswith("OK")


def test_serve_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tinyllama-1.1b"],
        capture_output=True, text=True, env=_env(), timeout=240, cwd=ROOT,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr


#: Files that are byte-for-byte twins of the reference's, apart from the
#: package name in imports and help texts: the host-side data path, the
#: configs and the CLI helpers, and the data service.
COPIES = ["configs/__init__.py", "configs/base.py", "configs/deepseek_7b.py",
          "configs/deepseek_moe_16b.py", "configs/hubert_xlarge.py",
          "configs/kimi_k2_1t_a32b.py", "configs/llava_next_34b.py",
          "configs/phi3_medium_14b.py", "configs/shapes.py", "configs/starcoder2_15b.py",
          "configs/tinyllama_1_1b.py", "configs/xlstm_350m.py", "configs/zamba2_1_2b.py",
          "core/__init__.py", "core/abstract_memory.py", "core/chunking.py",
          "core/distributed.py", "core/elastic.py", "core/loader.py", "core/planner.py",
          "core/protocol.py", "core/sampler.py", "core/spec.py", "core/stats.py",
          "core/storage/__init__.py", "core/storage/base.py", "core/storage/codec.py",
          "core/storage/mapped.py", "core/storage/parallel.py", "core/storage/store.py",
          "core/storage/vfs.py", "data/__init__.py", "data/synthetic.py", "data/tokens.py",
          "obs/__init__.py", "obs/metrics.py", "obs/report.py", "obs/tracer.py",
          "launch/cli.py",
          "autotune.py", "core/baselines.py", "ft/failures.py", "launch/data_service.py",
          "service/__init__.py", "service/residency.py", "service/service.py",
          "service/transport/__init__.py", "service/transport/ring.py",
          "service/transport/server.py", "service/transport/wire.py",
          "service/transport/client.py"]


#: Copies the port has since changed, each with the sections (a module's
#: top-level statements and its classes' members, as ``_sections`` names
#: them) where it may differ from the reference: the tracer's device spans
#: and its CLOCK_REALTIME origin, attribution by device intervals with the
#: DESIGN §6 model columns gone, the stager's loss-token count in place of
#: its host-clock overlap ratio, the loader's pack counting its
#: loss-bearing tokens and carrying its epoch, the tracer's device
#: counters and host tallies, and the configurations' fields, counts and
#: registry entries for the port's own nemotron-h and mla_moe (Kimi-K2)
#: families. Every other section stays the reference's, byte for byte.
CHANGED = {
    "configs/__init__.py": {"from .", "ARCHS", "reduced"},
    "configs/base.py": {f"ModelConfig.{n}" for n in (
        "family", "moe_impl", "moe_router_experts", "moe_routed_scale",
        "moe_shared_ff", "attn_every", "ssm_groups", "ssm_heads", "ssm_gated_norm",
        "layer_pattern", "rope", "d_inner", "moe_routed", "moe_shared_width", "param_count",
        "_block_params", "active_param_count", "block_layout", "moe_act", "q_lora_rank",
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "rope_scaling", "__post_init__", "_mla_params")} | {"YarnScaling"},
    "core/loader.py": {"RedoxLoader.epoch_device", "RedoxLoader._pack"},
    "core/stats.py": {"DeviceStats.__doc__", "DeviceStats.loss_tokens",
                      "DeviceStats.overlap_fraction"},
    "obs/__init__.py": {"__doc__", "from repro.obs.report", "__all__"},
    "obs/report.py": {"__doc__", "__all__", "_intervals_by_stage", "model_columns",
                      "format_report"},
    "obs/tracer.py": {"__doc__", "__all__", "_DEV", "_CNT", "_CAPTURING", "_NullSpan.note",
                      "_Span.note", "_DeviceSpan", "_realtime_offset_ns", "_DeviceClock",
                      "Tracer.__init__", "Tracer.device_span", "Tracer.device_mark",
                      "Tracer.complete", "Tracer.events", "Tracer.realtime_ns",
                      "Tracer.device_clock", "Tracer.to_chrome", "_TALLIES", "host_tally",
                      "tallies", "tallies_since"},
}


def _sections(text: str) -> dict:
    """A module's source cut into its top-level statements and each class's
    members, keyed by name (``Class.member``; a docstring ``__doc__``, an
    import by its module): each section runs from its first line,
    decorators included, to the line before the next one."""
    lines = text.splitlines(keepends=True)
    out: dict = {}

    def key(node) -> str:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            return node.targets[0].id
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            return node.target.id
        if (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            return "__doc__"
        if isinstance(node, ast.ImportFrom):
            return f"from {'.' * node.level}{node.module or ''}"
        if isinstance(node, ast.Import):
            return f"import {node.names[0].name}"
        return ast.dump(node)

    def first_line(node) -> int:
        return min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", ())])

    def walk(body, stop: int, prefix: str) -> None:
        for i, node in enumerate(body):
            end = first_line(body[i + 1]) if i + 1 < len(body) else stop
            name = prefix + key(node)
            if isinstance(node, ast.ClassDef):
                end_header, end = first_line(node.body[0]), end
                out[name] = out.get(name, "") + "".join(lines[first_line(node) - 1:end_header - 1])
                walk(node.body, end, name + ".")
            else:
                out[name] = out.get(name, "") + "".join(lines[first_line(node) - 1:end - 1])

    walk(ast.parse(text).body, len(lines) + 1, "")
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_equal_their_reference(rel):
    port = (PORT / rel).read_text().replace("repro_torch", "repro")
    ref = (ROOT / "src" / "repro" / rel).read_text()
    if rel.endswith("client.py"):  # epoch_device is ported: it stages with torch
        start, end = "    def epoch_device(", "    # ----" + "-" * 57 + " lifecycle"
        port, ref = (s[:s.index(start)] + s[s.index(end):] for s in (port, ref))
    if rel not in CHANGED:
        assert port == ref
        return
    mine, theirs = _sections(port), _sections(ref)
    declared = CHANGED[rel]
    assert declared <= set(mine) | set(theirs), declared - set(mine) - set(theirs)
    # a changed section changes its members too; blank lines at a section's
    # end belong to where the next one starts
    kept = {name for name in set(mine) | set(theirs)
            if not any(name == c or name.startswith(c + ".") for c in declared)}
    assert kept <= set(mine) & set(theirs), kept - (set(mine) & set(theirs))
    for name in kept:
        assert mine[name].rstrip() == theirs[name].rstrip(), name
