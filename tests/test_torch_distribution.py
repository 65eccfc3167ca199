"""The port's distribution on gloo worlds of CPU ranks: the sweep's
("cells", "replicas") mesh, the sharded LM train step, and sharded prefill
and decode, each held to the port's mesh-free run and to the JAX package.

Each world is spawned once (`torch_dist_worker.start_world`, a FileStore
under tmp_path, one torch thread a rank) and runs several checks; the
reference and the mesh-free runs are computed here, in the parent, while
the worlds run.

- The sweep: ref tests/test_podscale.py's mixed grid (sync Pflug, K-async,
  K-batch-async, a sign-flip cell, a K-async hetero fleet with drift) at
  5 cells x 3 replicas, on meshes (1, 4) (replicas pad 3 -> 4), (2, 2)
  (cells 5 -> 6 and replicas 3 -> 4) and (4, 1) (cells 5 -> 8), through
  ``mesh=``, `shardctx.sweep_mesh`, ``partition="shard_map"`` and the
  default "auto" mesh over the world.  Against the port's mesh-free grid
  time and k are bitwise and the loss within 1e-6 (another lane count per
  rank rounds the CPU's loss reduction differently); against the
  reference's ``run_sweep(partition="none")``, k exact, time 1e-6 and loss
  1e-4 relative, as tests/test_torch_faults.py holds that grid.
- The train step: tests/test_torch_train.py's `run_both` (3 steps, Pflug,
  SGD with momentum, a comm model) of llama3.2-3b and qwen3-moe-30b-a3b
  smoke on data/model meshes (2, 2) and (1, 4) in sync mode, and llama's
  kasync on (1, 2) and kbatch on (2, 1): k exact, sim_time 1e-6, ce and
  loss 1e-4 relative, the parameters at GRAD_TOL of each leaf's max,
  against the port's mesh-free step and the reference's.
- Serving: `serve.generate`, `steps.make_prefill_step` and
  `make_decode_step` of llama3.2-3b and rwkv6-3b smoke on a (1, 2) mesh,
  within 1e-5 of the mesh-free logits (f32) and with the same greedy
  tokens.
- ``train --simulate`` under 2 ranks: the header's processes and
  mesh_shape, and the cells' k and time as one process prints them (the
  excess over f* within 1e-4; measured bit for bit, see the test).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import controller as jctl  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.core import sweep as jsw  # noqa: E402
from repro.core.faults import byzantine_plan as jbyzantine  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from test_torch_train import GRAD_TOL, _leafwise, _model_pair, run_both  # noqa: E402

import torch_dist_worker as W  # noqa: E402

ITERS, EVAL_EVERY, N_REP = 40, 20, 3
SWEEP_TIME_RTOL, SWEEP_LOSS_RTOL, MESH_LOSS_RTOL = 1e-6, 1e-4, 1e-6
SERVE_ATOL = 1e-5
MESHES = [(1, 4), (2, 2), (4, 1)]
# (arch, mesh, mode): the sync cases run in the 4-rank world, the async
# ones (a mesh of 2 ranks each) in the 2-rank world
TRAIN_CASES = [("llama3.2-3b", (2, 2), "sync"), ("llama3.2-3b", (1, 4), "sync"),
               ("qwen3-moe-30b-a3b", (2, 2), "sync"), ("qwen3-moe-30b-a3b", (1, 4), "sync"),
               ("llama3.2-3b", (1, 2), "kasync"), ("llama3.2-3b", (2, 1), "kbatch")]
SERVE_ARCHS = ["llama3.2-3b", "rwkv6-3b"]
SIM_ARGV = ["--simulate", "--device", "cpu", "--steps", "200", "--replicas", "3", "--sim-eval-every", "100",
            "--sim-controllers", "pflug,fixed", "--sim-stragglers", "exponential", "--n-workers", "8",
            "--sim-m", "80", "--sim-d", "4"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the sweep


def _podscale_grid():
    """The grid's data, keys and eta from the reference, and its
    reference run (``partition="none"``: the default raises under this
    JAX, ROADMAP Queue 3)."""
    n, m, d = W.N_SLOTS, 160, 4
    data = jax_linreg(jax.random.PRNGKey(0), m=m, d=d)
    eta = 0.05 / (2 * float(jnp.linalg.eigvalsh(data.X.T @ data.X / m).max()))
    keys = jax.random.split(jax.random.PRNGKey(7), N_REP)
    fleet = jstr.WorkerFleet(models=(jstr.Exponential(rate=1.0),) * 4 + (jstr.Exponential(rate=0.25),) * 2,
                             schedule=jstr.RateSchedule(times=(5.0,), scales=(0.5,)))
    cases = [
        jsw.SweepCase(jctl.PflugController(n_workers=n, k0=2, step=2, thresh=5, burnin=10), jstr.Exponential(rate=1.0),
                      eta, label="sync_pflug"),
        jsw.SweepCase(jctl.FixedKController(n_workers=n, k=2), jstr.Exponential(rate=1.0), eta, label="kasync_k2",
                      mode="kasync"),
        jsw.SweepCase(jctl.FixedKController(n_workers=n, k=3), jstr.Exponential(rate=1.0), eta, label="kbatch_k3",
                      mode="kbatch"),
        jsw.SweepCase(jctl.FixedKController(n_workers=n, k=3), jstr.Exponential(rate=1.0), eta, label="flip",
                      fault=jbyzantine(n, 0.25, "sign_flip")),
        jsw.SweepCase(jctl.FixedKController(n_workers=6, k=2), fleet, eta, label="kasync_hetero_n6", mode="kasync"),
    ]
    ref = jsw.run_sweep(lambda w, X, y: (X @ w - y) ** 2, jnp.zeros((d,)), data.X, data.y, n_workers=n, cases=cases,
                        num_iters=ITERS, keys=keys, eval_every=EVAL_EVERY, specialize=False, partition="none")
    grid = {"X": np.asarray(data.X), "y": np.asarray(data.y), "keys": np.asarray(keys), "eta": eta,
            "iters": ITERS, "eval_every": EVAL_EVERY}
    return grid, ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once — 4 ranks: the sweep on every mesh, the
    pod-major check, then every train case; 2 ranks: serving of both archs,
    then --simulate — while the parent computes the references."""
    tmp = tmp_path_factory.mktemp("worlds")
    grid, ref = _podscale_grid()
    torch.save(grid, tmp / "grid.pt")
    for arch in sorted({a for a, _, _ in TRAIN_CASES} | set(SERVE_ARCHS)):
        torch.save(_model_pair(arch)[4], tmp / f"{arch}.pt")
    jobs4 = [("sweep", dict(grid_file=str(tmp / "grid.pt"), shapes=MESHES)), ("placement_order", {})]
    jobs2 = [("serve", dict(arch=arch, shape=(1, 2), params_file=str(tmp / f"{arch}.pt"), prompt_len=128,
                            new_tokens=4)) for arch in SERVE_ARCHS] + [("simulate", dict(argv=SIM_ARGV))]
    for arch, shape, mode in TRAIN_CASES:
        job = ("train_steps", dict(arch=arch, shape=shape, mode=mode, params_file=str(tmp / f"{arch}.pt")))
        (jobs4 if shape[0] * shape[1] == 4 else jobs2).append(job)
    started = W.start_world(4, jobs4, str(tmp / "ranks4")), W.start_world(2, jobs2, str(tmp / "ranks2"))
    mesh_free = W.podscale_sweep(grid, partition="none")
    for arch, _, mode in TRAIN_CASES:
        run_both(arch, mode, 1, "sgd")
    ranks4, ranks2 = (W.finish_world(s) for s in started)
    return {"ranks4": ranks4, "ref": ref, "mesh_free": mesh_free, "ranks2": ranks2}


def _sweep_out(worlds, tag):
    return worlds["ranks4"][0][0][tag]


@pytest.mark.parametrize("tag", MESHES + ["context", "shard_map", "auto"])
def test_sweep_on_a_mesh_is_the_mesh_free_grid(worlds, tag):
    time_, loss, k = _sweep_out(worlds, tag)
    want = worlds["mesh_free"]
    assert time_.shape == want.time.shape == (5, N_REP, ITERS // EVAL_EVERY)
    assert torch.equal(time_, want.time) and torch.equal(k, want.k), tag
    np.testing.assert_allclose(_np(loss), _np(want.loss), rtol=MESH_LOSS_RTOL, err_msg=str(tag))


@pytest.mark.parametrize("tag", MESHES)
def test_sweep_on_a_mesh_follows_the_reference(worlds, tag):
    time_, loss, k = _sweep_out(worlds, tag)
    ref = worlds["ref"]
    np.testing.assert_array_equal(_np(k), np.asarray(ref.k), err_msg=str(tag))
    np.testing.assert_allclose(_np(time_), np.asarray(ref.time), rtol=SWEEP_TIME_RTOL, err_msg=str(tag))
    np.testing.assert_allclose(_np(loss), np.asarray(ref.loss), rtol=SWEEP_LOSS_RTOL, err_msg=str(tag))


def test_every_rank_holds_the_whole_grid_and_repopulates_without_a_capture(worlds):
    for rank in worlds["ranks4"][1:]:
        for tag in MESHES + ["context", "shard_map", "auto"]:
            for a, b in zip(rank[0][tag], _sweep_out(worlds, tag)):
                assert torch.equal(a, b), tag
    # the context's run loads the first mesh's grid into its program
    assert _sweep_out(worlds, "context_traces") == 0


def test_a_dim_over_two_mesh_axes_is_split_pod_major(worlds):
    """`sharding.to_placements` of (("pod", "data"), None) on a (2, 2) mesh:
    the rank at row-major position p holds rows [2p, 2p + 2), JAX's order,
    and the gathered tensor is the whole one."""
    x = torch.arange(24.0).reshape(8, 3)
    for rank in worlds["ranks4"]:
        got = rank[1]
        p = got["flat_index"]
        assert torch.equal(got["local"], x[2 * p:2 * p + 2]) and torch.equal(got["full"], x)
    assert sorted(rank[1]["flat_index"] for rank in worlds["ranks4"]) == [0, 1, 2, 3]


# ------------------------------------------------------- the train step


def _train_result(worlds, case):
    """Every rank's result of TRAIN_CASES[case], from the world it ran in."""
    sizes = [s[0] * s[1] for _, s, _ in TRAIN_CASES]
    n = sizes[case]
    ranks = worlds["ranks4"] if n == 4 else worlds["ranks2"]
    first = 2 if n == 4 else len(SERVE_ARCHS) + 1  # the jobs before the train cases
    idx = first + sum(1 for s in sizes[:case] if s == n)
    return [rank[idx] for rank in ranks]


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)), ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def test_sharded_train_step_matches_both_packages(worlds, case):
    arch, shape, mode = TRAIN_CASES[case]
    per_rank = _train_result(worlds, case)
    got = per_rank[0]
    jstate, tstate, rows = run_both(arch, mode, 1, "sgd")
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
    for path, a, b in _leafwise(jstate.ctrl_state, got["ctrl"]):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=path)
    # wq (L, D, H, hd) sharded on the axes of extent > 1
    assert all(p.startswith("S(") for p, n in zip(got["placements"]["wq"], shape) if n > 1), got["placements"]
    for other in per_rank[1:]:
        assert [int(m["k"]) for m in other["rows"]] == [int(m["k"]) for m in got["rows"]]


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_matches_the_mesh_free_run(worlds, arch):
    got = worlds["ranks2"][0][SERVE_ARCHS.index(arch)]
    _, _, _, model, params = _model_pair(arch)
    prompts = tserve.random_prompts(model.cfg, 4, 128, 1, "cpu")
    want = tserve.generate(model, params, prompts, 4)
    np.testing.assert_allclose(_np(got["prefill_logits"]), _np(want.prefill_logits), rtol=0, atol=SERVE_ATOL)
    assert torch.equal(got["tokens"], want.tokens)
    # make_prefill_step and make_decode_step: prefill, then two decode steps on the grown cache
    logits, cache = model.prefill(params, {"tokens": prompts})
    np.testing.assert_allclose(_np(got["step_logits"][0]), _np(logits), rtol=0, atol=SERVE_ATOL)
    if model.cfg.family != "ssm":
        cache = tserve._grow_kv_cache(model, cache, 4, 130, 0)
    tok = torch.argmax(logits, dim=-1)[:, None]
    for i in range(2):
        logits, cache = model.decode_step(params, tok, cache, 128 + i)
        np.testing.assert_allclose(_np(got["step_logits"][1 + i]), _np(logits), rtol=0, atol=SERVE_ATOL)
        tok = torch.argmax(logits, dim=-1)[:, None]
    # the cache is placed by batch_shardings: the batch on "data", and the
    # kv heads (dense) or the state's heads (rwkv's s) on "model"
    placements = got["cache_placements"]
    assert all(p[0] == "S(1)" for p in placements.values()), placements
    assert placements["s" if model.cfg.family == "ssm" else "k"][1] == ("S(2)" if model.cfg.family == "ssm"
                                                                       else "S(3)"), placements
    assert torch.equal(worlds["ranks2"][1][SERVE_ARCHS.index(arch)]["tokens"], got["tokens"])


def test_train_simulate_on_two_ranks(worlds, capsys):
    from repro_torch.launch import train as ttrain

    sim = len(SERVE_ARCHS)
    lines = [json.loads(x) for x in worlds["ranks2"][0][sim].splitlines() if x.startswith("{")]
    header, cells = lines[0], lines[1:]
    assert header["processes"] == 2 and header["devices"] == 2 and header["mesh_shape"] == [2, 1]
    assert worlds["ranks2"][1][sim] == ""  # only rank 0 prints
    ttrain.main(SIM_ARGV)
    alone = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert alone[0]["mesh_shape"] == [1, 1] and alone[0]["processes"] == 1
    assert [c["cell"] for c in cells] == [c["cell"] for c in alone[1:]]
    for a, b in zip(cells, alone[1:]):
        assert a["k_final"] == b["k_final"] and a["sim_time"] == b["sim_time"]
        # each rank's cell rows are the one-process run's (R lanes wide) and
        # f* is solved by QR (`data.least_squares`), so the excess is
        # measured equal bit for bit; the CPU's default lstsq routine gave
        # another f* from call to call, 1.05e-4 of the excess apart
        np.testing.assert_allclose(a["final_excess"], b["final_excess"], rtol=1e-4)
