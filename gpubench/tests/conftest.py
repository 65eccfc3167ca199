"""The benchmark's tests import `gpubench` from the repository's root and
the port from its `src`.  ``smoke_root`` is a copy of the benchmark's data
with small cells added (a fig2 grid, two granite train steps and a
granite prefill at the port's smoke widths), made without editing any of
the benchmark's files; ``cuda`` skips a test where there is no card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMOKE_FIG2 = {"m": 200, "d": 10, "n_workers": 10, "replicas": 4, "eval_every": 50,
              "cases": [{"label": "adaptive", "controller": "pflug", "k0": 2, "step": 2, "thresh": 3, "burnin": 10,
                         "k_max": 8},
                        {"label": "fixed_k3", "controller": "fixed", "k": 3}]}
SMOKE_GRANITE = {"program_smoke": True, "num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 8,
                 "num_key_value_heads": 4, "head_dim": 16, "intermediate_size": 64, "num_local_experts": 4,
                 "num_experts_per_tok": 2, "vocab_size": 512, "vocab_pad_multiple": 64, "param_dtype": "float32",
                 "compute_dtype": "float32"}
# cell: (configuration, its base file and changes, traffic, its base file and changes, the limits' base cell)
SMOKE_CELLS = {
    "sim-smoke": ("fig2-smoke", "fig2-linreg", SMOKE_FIG2, "smoke-grid", "grid-chunks", {"chunk_iters": 100},
                  "sim-fig2-grid"),
    "train-smoke": ("granite-smoke", "granite-moe-1b-a400m", SMOKE_GRANITE, "smoke-train", "sync-16x1024",
                    {"batch": 8, "seq": 32, "n_workers": 4, "trace_steps": 1}, "train-granite-moe-sync"),
    # Pflug's test raises k every other step from the second on, into the window
    "train-smoke-switch": ("granite-smoke", "granite-moe-1b-a400m", SMOKE_GRANITE, "smoke-train-switch",
                           "sync-16x1024", {"batch": 8, "seq": 32, "n_workers": 4, "trace_steps": 1,
                                            "controller": {"name": "pflug", "k0": 1, "step": 1, "thresh": -3,
                                                           "burnin": 1}},
                           "train-granite-moe-sync"),
    "prefill-smoke": ("granite-smoke", "granite-moe-1b-a400m", SMOKE_GRANITE, "smoke-prefill",
                      "closed-1client-4x512-4096", {"lengths": [16, 32], "trace_requests": 2}, "prefill-granite-moe"),
}


def add_smoke_cells(root: Path) -> None:
    """Add the smoke cells' files and entries to the benchmark copy at ``root``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    g = root / "gpubench"
    for cell, (cfg, cfg_base, cfg_kw, traffic, tr_base, tr_kw, limits_of) in SMOKE_CELLS.items():
        c = json.loads((g / "configs" / f"{cfg_base}.json").read_text())
        (g / "configs" / f"{cfg}.json").write_text(json.dumps({**c, **cfg_kw, "name": cfg}))
        t = json.loads((g / "traffic" / f"{tr_base}.json").read_text())
        (g / "traffic" / f"{traffic}.json").write_text(json.dumps({**t, **tr_kw}))
        shutil.copy(g / "limits" / f"{limits_of}.json", g / "limits" / f"{cell}.json")
        if not any(x["name"] == cfg for x in spec["configs"]):
            spec["configs"].append({"name": cfg, "source": "smoke", "file": f"gpubench/configs/{cfg}.json",
                                    "reduced": [], "why": "smoke"})
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": traffic, "chips": 1, "why": "smoke"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if limits_of in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def smoke_root(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    add_smoke_cells(tmp_path)
    return tmp_path


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
