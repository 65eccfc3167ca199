"""The port's dry run (`launch/dryrun.py`, `dryrun_all.py`, `roofline/report.py`)
on fake worlds of 256 and 512 ranks, and the counter's per-rank counting.

- The dry-run CLI in subprocesses, on the reference dry-run test's trio,
  tracing the CPU program (`--device cpu`: a CPU-only torch cannot index a
  fake CUDA tensor; the card's program is traced by `chip_smoke.py` phase
  16 and a `cuda` test), at full depth: qwen1.5-0.5b train_4k on 256 ranks
  with FLOPs, bytes and collective bytes > 0 and a fit in 80 GB;
  llama3.2-3b decode_32k --multi-pod on 512 ranks, "2x16x16"; rwkv6-3b
  long_500k with an analytic total below 1 GB.  Every job starts at once.
- `count_step` counts a DTensor product once per rank: the local product,
  not the global one beside it, on a fake world of 256 ranks.
- A smoke train step on a fake (2, 2) world counts the same FLOPs, bytes
  and collective bytes per type as the same step run for real on a gloo
  world of four ranks (`tests/torch_dist_worker.py`), exactly.
- `dryrun_all`'s job commands and `report`'s tables from the trio's JSONs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as W  # noqa: E402

from repro_torch.launch import dryrun_all  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRIO = [("qwen1.5-0.5b", "train_4k", "base"), ("llama3.2-3b", "decode_32k", "pod2"), ("rwkv6-3b", "long_500k", "base")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file, started at once: the trio's CLI runs,
    the fake world of 256 ranks, and the gloo and fake worlds of four."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape, mode in TRIO:
        out = tmp / f"{arch}__{shape}__{mode}.json"
        cmd = dryrun_all.job_cmd(arch, shape, mode, str(out), "cpu")
        procs[arch] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                        text=True), out)
    jobs = [("count_train_step", {"arch": "llama3.2-3b", "shape": (2, 2)})]
    worlds = {"gloo": W.start_world(4, jobs, str(tmp / "gloo")),
              "fake": W.start_fake_world(4, [(n, dict(kw, fake=True)) for n, kw in jobs], str(tmp / "fake")),
              "product": W.start_fake_world(256, [("count_dtensor_product", {})], str(tmp / "product"))}
    out = {name: W.finish_world(w) for name, w in worlds.items()}
    for arch, (proc, path) in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{arch}: {err[-3000:]}"
        out[arch] = json.loads(path.read_text())
    out["dir"] = tmp
    return out


@pytest.mark.parametrize("arch,shape,mode", TRIO, ids=[t[0] for t in TRIO])
def test_dryrun_cli_traces_the_step_on_a_fake_world(runs, arch, shape, mode):
    r = runs[arch]
    devices, mesh = (512, "2x16x16") if mode == "pod2" else (256, "16x16")
    assert (r["arch"], r["shape"], r["n_devices"], r["mesh"], r["device"]) == (arch, shape, devices, mesh, "cpu")
    rl = r["roofline"]
    assert rl["flops"] > 0 and rl["bytes_accessed"] > 0 and r["collectives"]["total"] > 0
    assert rl["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["kernel_launches"] == {"flash_attention": 0, "wkv6": 0}
    assert r["memory"]["argument_bytes"] > 0 and r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"]
    am = r["analytic_memory"]
    if arch == "qwen1.5-0.5b":
        assert am["fits_80gb"] and 0 < rl["useful_flops_ratio"] < 1
    if arch == "rwkv6-3b":
        assert am["total_bytes"] < 1e9 and "cache_bytes" in am


def test_count_step_counts_a_dtensor_product_once_per_rank(runs):
    """(4096 x 8192) @ (8192 x 8192) sharded (Shard(0), Replicate()) x
    (Replicate(), Shard(1)) on (16, 16): rank 0's local product only."""
    (cost,), = runs["product"]
    assert cost["flops"] == 2 * (4096 // 16) * 8192 * (8192 // 16)
    assert cost["collectives"]["total"] == 0


def test_fake_world_counts_what_a_gloo_world_runs(runs):
    (fake,), = runs["fake"]
    gloo = [r[0] for r in runs["gloo"]]
    assert fake["flops"] > 0 and fake["collectives"]["total"] > 0
    for rank in gloo:  # the ranks of a (2, 2) mesh run the same shapes
        assert (rank["flops"], rank["bytes accessed"], rank["collectives"]) == (
            fake["flops"], fake["bytes accessed"], fake["collectives"])


def test_dryrun_all_commands_and_the_report(runs, tmp_path):
    assert dryrun_all.MODES == ["base", "pod2"] and len(dryrun_all.ARCHS) == 10
    cmd = dryrun_all.job_cmd("rwkv6-3b", "long_500k", "pod2", "x.json", "cuda")
    assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"] and "--multi-pod" in cmd and cmd[-2:] != ["--device", "cpu"]
    table, n_ok = report.dryrun_section(str(runs["dir"]))
    assert n_ok == 0  # no arch has both meshes here
    assert "| qwen1.5-0.5b | train_4k | ok (" in table and "| rwkv6-3b | long_500k | ok (" in table
    assert "| llama3.2-3b | decode_32k | **FAIL** | ok |" in table
    roof = report.roofline_section(str(runs["dir"]))
    assert roof.count("\n") == 3  # header, rule, the two base rows


def test_dryrun_traces_the_card_only_with_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch import dryrun

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dryrun.run_one("qwen1.5-0.5b", "train_4k", False)
