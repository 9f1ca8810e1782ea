"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's.

Both read the same artifact rows; with the reference's ``HW`` installed
in the port, ``model_flops`` and ``analyze`` give equal results. The lines
where the two files differ are pinned: the H100's ``HW`` table (with its
source), the temp key the port reads (``temp_size_in_bytes``, where the
reference reads its TPU-adjusted ``temp_tpu_adjusted``), the markdown's
"fits 80GB" header, and a docstring paragraph saying so.
"""

import difflib
from pathlib import Path

import pytest

from repro.launch import roofline as jroof
from repro_torch.launch import roofline

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]

CELLS = [("tinyllama-1.1b", "train_4k", "data16xmodel16", "train_step"),
         ("deepseek-moe-16b", "train_4k", "pod2xdata16xmodel16", "train_step"),
         ("zamba2-1.2b", "prefill_32k", "data16xmodel16", "serve_prefill"),
         ("starcoder2-15b", "decode_32k", "data16xmodel16", "serve_decode"),
         ("kimi-k2-1t-a32b", "train_4k", "pod2xdata16xmodel16", "train_step")]


def _rows() -> list[dict]:
    rows = []
    for i, (arch, shape, mesh, kind) in enumerate(CELLS):
        temp = 3.1e9 * (i + 1)
        rows.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                     "step_kind": kind, "flops_per_device": 1.7e13 / (i + 1),
                     "bytes_per_device": 2.3e11 * (i + 1),
                     "collectives": {"total_bytes": 4.1e9 * (5 - i)},
                     "memory": {"argument_size_in_bytes": 5.5e9 + i * 2e9,
                                "temp_size_in_bytes": temp, "temp_tpu_adjusted": temp}})
    rows.append({"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "data16xmodel16",
                 "status": "skip_encoder"})
    return rows


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _, _ in CELLS])
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == jroof.model_flops(arch, shape)


def test_analyze_equals_the_reference_on_the_same_rows_and_hw(monkeypatch):
    monkeypatch.setattr(roofline, "HW", dict(jroof.HW))
    port, ref = roofline.analyze(_rows()), jroof.analyze(_rows())
    assert port == ref
    assert [a["dominant"] for a in port if a["status"] == "ok"]  # every ok row analysed


def test_h100_table():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9,
                           "hbm_bytes": 80e9}
    md = roofline.to_markdown(roofline.analyze(_rows()))
    assert "fits 80GB" in md and md.count("\n") == len(_rows()) + 1


#: Every line of the port's file that differs from the reference's (the
#: package name aside): added (+) or removed (-).
DIFF = {
    "+ ",
    "+ The port's twin: the same terms over the same artifact rows, against an",
    "+ NVIDIA H100 SXM's rates (``HW``) and the temp bytes the port's dry run",
    "+ reports (``temp_size_in_bytes``; the reference reads a TPU-adjusted temp).",
    '- HW = {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9, "hbm_bytes": 16e9}',
    "+ # NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): 989 TFLOP/s",
    "+ # dense bf16, 3.35 TB/s and 80 GB of HBM3, NVLink 900 GB/s in both",
    '+ # directions together, so 450 GB/s each way ("ici_bw": the link term).',
    '+ HW = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9, "hbm_bytes": 80e9}',
    '-                 temp_gb=r["memory"]["temp_tpu_adjusted"] / 1e9,',
    '+                 temp_gb=r["memory"]["temp_size_in_bytes"] / 1e9,',
    '-                     r["memory"]["temp_tpu_adjusted"]',
    '+                     r["memory"]["temp_size_in_bytes"]',
    '-         "| arch | shape | mesh | comp s | mem s | coll s | dominant | 6ND/HLO | '
    'roofline frac | fits 16GB | next lever |",',
    '+         "| arch | shape | mesh | comp s | mem s | coll s | dominant | 6ND/HLO | '
    'roofline frac | fits 80GB | next lever |",',
}


def test_every_difference_from_the_reference_is_pinned():
    ref = (ROOT / "src/repro/launch/roofline.py").read_text().splitlines()
    port = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    port = port.replace("repro_torch", "repro").splitlines()
    diff = {line for line in difflib.ndiff(ref, port) if line[:2] in ("+ ", "- ")}
    assert diff == DIFF
