"""The sharded LM path where torch's DTensor needed the port's own layouts:
the vocab-parallel cross-entropy, the MoE dispatch on each rank's groups,
the head-dim-sharded projections, rwkv's decay LoRA and the SSM's decode
step, on gloo worlds of CPU ranks and on fake worlds of the dry run.

- The CE: `model._nll` of DTensor logits, batch on "data" and a padded
  vocab on a "model" axis of 4 and of 2 (a (1, 4) and a (2, 2) mesh of the
  same world), targets at every shard's first and last column.  Its
  per-row mean within 1e-6 relative of the reference's `_ce_per_row` on
  the same numpy logits, the nll within 1e-6 of the port's mesh-free
  `_nll`, and the gradient of a weighted sum within 1e-6 of its max (the
  shards' partial sums round the log-sum-exp otherwise than one sum does:
  one ulp of it, ~4.8e-7 at these logits, moves each softmax entry by as
  much relative; measured 2.0e-7 of the max).  Its
  forward all-reduces three (B, T) vectors and gathers nothing
  (`roofline.count_step`).
- Train steps: tests/test_torch_train.py's `run_both` (3 steps, Pflug,
  SGD with momentum, a comm model) of granite-moe-1b-a400m, hymba-1.5b
  and rwkv6-3b smoke on a (2, 2) mesh against both packages, with
  tests/test_torch_distribution.py's tolerances: k exact, sim_time 1e-6,
  ce and loss 1e-4 relative, the parameters at `GRAD_TOL` of a leaf's max.
- Decode: hymba-1.5b's sharded `serve.generate`, and its prefill and two
  decode steps through the step builders at its window, on (2, 2) within
  `SERVE_ATOL` of the mesh-free run, same tokens.
- Dry runs: the four jobs that `chip_smoke.py` phase 16 traces on the card
  (one per repaired site), here on the CPU program at 2 layers, all started
  at once: each traces with FLOPs, bytes and collective bytes > 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import model as jmodel_lib  # noqa: E402
from repro_torch.launch import dryrun_all, serve as tserve  # noqa: E402
from repro_torch.models import model as tmodel_lib  # noqa: E402
from test_torch_train import GRAD_TOL, _leafwise, _model_pair, run_both  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_ATOL = 1e-5
CE_RTOL, CE_GRAD_TOL = 1e-6, 1e-6
# (B, T, Vpad) logits of a vocab of 60 padded to 64: the shards of a model
# axis of 4 are 16 columns wide, of 2 are 32; the last shard holds the pad
CE_B, CE_T, CE_VPAD, CE_VOCAB = 4, 8, 64, 60
CE_MESHES = [(1, 4), (2, 2)]
TRAIN_ARCHS = ["granite-moe-1b-a400m", "hymba-1.5b", "rwkv6-3b"]
DECODE_ARCH = "hymba-1.5b"
# chip_smoke.py phase 16's jobs: one per repaired site
DRY_JOBS = [("qwen3-moe-30b-a3b", "train_4k", "base"), ("hymba-1.5b", "train_4k", "base"),
            ("rwkv6-3b", "prefill_32k", "pod2"), ("hymba-1.5b", "decode_32k", "pod2")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ce_data():
    """Seeded logits, weights and targets: every shard's first and last
    column (the last shard's last column below the pad) in row 0."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((CE_B, CE_T, CE_VPAD))).astype(np.float32)
    targets = rng.integers(0, CE_VOCAB, size=(CE_B, CE_T))
    targets[0] = [0, 15, 16, 31, 32, 47, 48, CE_VOCAB - 1]
    w = rng.standard_normal((CE_B, CE_T)).astype(np.float32)
    return {"logits": logits, "targets": targets, "w": w, "vocab": CE_VOCAB}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world and subprocess of this file, started at once; the
    references and mesh-free runs are computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("repairs")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape, mode in DRY_JOBS:
        out = tmp / f"{arch}__{shape}__{mode}.json"
        cmd = dryrun_all.job_cmd(arch, shape, mode, str(out), "cpu") + ["--override", "n_layers=2"]
        procs[(arch, shape, mode)] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                                                       stderr=subprocess.PIPE, text=True), out)
    data = _ce_data()
    torch.save(data, tmp / "ce.pt")
    for arch in sorted(set(TRAIN_ARCHS) | {DECODE_ARCH}):
        torch.save(_model_pair(arch)[4], tmp / f"{arch}.pt")
    jobs = [("vocab_parallel_nll", dict(shape=s, data_file=str(tmp / "ce.pt"))) for s in CE_MESHES]
    jobs += [("train_steps", dict(arch=a, shape=(2, 2), mode="sync", params_file=str(tmp / f"{a}.pt")))
             for a in TRAIN_ARCHS]
    jobs += [("serve", dict(arch=DECODE_ARCH, shape=(2, 2), params_file=str(tmp / f"{DECODE_ARCH}.pt"),
                            prompt_len=128, new_tokens=4))]
    world = W.start_world(4, jobs, str(tmp / "ranks4"))
    for arch in TRAIN_ARCHS:
        run_both(arch, "sync", 1, "sgd")
    out = {"ranks": W.finish_world(world), "ce_data": data}
    for job, (proc, path) in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{job}: {err[-3000:]}"
        out[job] = json.loads(path.read_text())
    return out


# ------------------------------------------------------------------ the CE


def _mesh_free_nll(data):
    lg = torch.from_numpy(data["logits"]).requires_grad_()
    nll = tmodel_lib._nll(lg, torch.from_numpy(data["targets"]), data["vocab"])
    (nll * torch.from_numpy(data["w"])).sum().backward()
    return nll.detach(), lg.grad


@pytest.mark.parametrize("case", range(len(CE_MESHES)), ids=[f"model{s[1]}" for s in CE_MESHES])
def test_vocab_parallel_ce_matches_the_reference(runs, case):
    got = runs["ranks"][0][case]
    data = runs["ce_data"]
    want = jmodel_lib._ce_per_row(jnp.asarray(data["logits"]), jnp.asarray(data["targets"]), data["vocab"])
    np.testing.assert_allclose(_np(got["ce"]), np.asarray(want), rtol=CE_RTOL)
    nll, grad = _mesh_free_nll(data)
    np.testing.assert_allclose(_np(got["nll"]), _np(nll), rtol=CE_RTOL)
    gmax = float(grad.abs().max())
    np.testing.assert_allclose(_np(got["grad"]), _np(grad), rtol=0, atol=CE_GRAD_TOL * gmax)
    # the pad's columns take no gradient; the nll is sharded as the batch
    assert float(got["grad"][..., CE_VOCAB:].abs().max()) == 0.0
    assert got["placements"] == ("S(0)", "R")
    for rank in runs["ranks"][1:]:
        assert torch.equal(rank[case]["nll"], got["nll"])


@pytest.mark.parametrize("case", range(len(CE_MESHES)), ids=[f"model{s[1]}" for s in CE_MESHES])
def test_vocab_parallel_ce_all_reduces_three_vectors_and_gathers_nothing(runs, case):
    coll = runs["ranks"][0][case]["collectives"]
    rows = CE_B // CE_MESHES[case][0]
    assert coll["all-gather"] == 0 and coll["reduce-scatter"] == 0
    assert coll["all-reduce"] == 3 * rows * CE_T * 4


# ----------------------------------------------------------- train steps


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_of_the_repaired_families(runs, arch):
    per_rank = runs["ranks"]
    idx = len(CE_MESHES) + TRAIN_ARCHS.index(arch)
    got = per_rank[0][idx]
    jstate, tstate, rows = run_both(arch, "sync", 1, "sgd")
    assert len(got["rows"]) == len(rows)
    for mesh_m, (jm, tm) in zip(got["rows"], rows):
        for want in (jm, tm):
            assert int(mesh_m["k"]) == int(want["k"])
            np.testing.assert_allclose(float(mesh_m["sim_time"]), float(want["sim_time"]), rtol=1e-6)
            np.testing.assert_allclose(float(mesh_m["ce"]), float(want["ce"]), rtol=1e-4)
            np.testing.assert_allclose(float(mesh_m["loss"]), float(want["loss"]), rtol=1e-4)
    for want_params in (jstate.params, tstate.params):
        for path, a, b in _leafwise(want_params, got["params"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL[arch] * np.abs(a).max(), err_msg=path)
    for other in per_rank[1:]:
        assert [int(m["k"]) for m in other[idx]["rows"]] == [int(m["k"]) for m in got["rows"]]


# ------------------------------------------------------------------ decode


def test_sharded_hybrid_decode_matches_the_mesh_free_run(runs):
    got = runs["ranks"][0][len(CE_MESHES) + len(TRAIN_ARCHS)]
    _, _, _, model, params = _model_pair(DECODE_ARCH)
    prompts = tserve.random_prompts(model.cfg, 4, 128, 1, "cpu")
    want = tserve.generate(model, params, prompts, 4)
    np.testing.assert_allclose(_np(got["prefill_logits"]), _np(want.prefill_logits), rtol=0, atol=SERVE_ATOL)
    assert torch.equal(got["tokens"], want.tokens)
    # the worker's make_prefill_step and make_decode_step, at the arch's
    # window (hymba's ring cache of `sliding_window` slots)
    window = model.cfg.sliding_window
    assert window > 0
    logits, cache = model.prefill(params, {"tokens": prompts}, window=window)
    np.testing.assert_allclose(_np(got["step_logits"][0]), _np(logits), rtol=0, atol=SERVE_ATOL)
    cache = tserve._grow_kv_cache(model, cache, 4, 130, window)
    tok = torch.argmax(logits, dim=-1)[:, None]
    for i in range(2):
        logits, cache = model.decode_step(params, tok, cache, 128 + i, window=window)
        np.testing.assert_allclose(_np(got["step_logits"][1 + i]), _np(logits), rtol=0, atol=SERVE_ATOL)
        tok = torch.argmax(logits, dim=-1)[:, None]
    # the SSM state's heads on "model", beside the batch on "data"
    assert got["cache_placements"]["ssm"] == ("S(1)", "S(2)"), got["cache_placements"]


# ---------------------------------------------------------------- dry runs


@pytest.mark.parametrize("job", DRY_JOBS, ids=["-".join(j) for j in DRY_JOBS])
def test_repaired_dry_run_job_traces(runs, job):
    r = runs[job]
    arch, shape, mode = job
    assert (r["arch"], r["shape"], r["mesh"]) == (arch, shape, "2x16x16" if mode == "pod2" else "16x16")
    rl = r["roofline"]
    assert rl["flops"] > 0 and rl["bytes_accessed"] > 0 and r["collectives"]["total"] > 0
    assert r["kernel_launches"] == {"flash_attention": 0, "wkv6": 0}
