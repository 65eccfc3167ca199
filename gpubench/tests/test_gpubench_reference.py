"""The plain references against the port at its smoke widths on the CPU, for
each entry the benchmark's windows drive: `run_sweep`, `run_monte_carlo`,
the fastest-k train step and `serve.generate`."""

import pytest
import torch

from gpubench import weights
from gpubench.drivers import lm, sim, train
from gpubench.reference import linreg_sim, moe_lm, train_ref

from conftest import SMOKE_FIG2, SMOKE_GRANITE

GRANITE = {**lm.FIELDS, "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "capacity_factor": 1.25,
           "router_aux_weight": 0.01, "program_arch": "granite-moe-1b-a400m", **SMOKE_GRANITE}
for _k in ("moe_dispatch", "tie_word_embeddings"):
    GRANITE.pop(_k)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sim_reference_matches_grid_and_looped_engine():
    cfg = {**SMOKE_FIG2, "straggler": {"rate": 1.0}}
    gen = torch.Generator().manual_seed(11)
    X, y = sim.make_data(cfg, gen, "cpu")
    eta = sim.step_size(X, 0.25)
    keys = torch.randint(0, 2**32, (4, 2), generator=gen, dtype=torch.int64)
    lanes = linreg_sim.lanes_of(cfg["cases"], 4)
    ref = linreg_sim.simulate(X, y, lanes, keys.repeat(2, 1), 10, eta, 1.0, 300, 50)
    for engine, cases in (("grid", cfg["cases"]), ("looped", cfg["cases"][:1])):
        call, _ = sim._program(engine, cfg, cases, eta, X, y, torch.device("cpu"), 300, 1.0)
        t, loss, k = call(keys)
        n = t.shape[0]
        assert torch.equal(t, ref[0][:n]) and torch.equal(k.long(), ref[2][:n])
        torch.testing.assert_close(loss, ref[1][:n], rtol=1e-5, atol=0)
        got = sim.compare((t, loss, k), tuple(r[:n] for r in ref), lanes[:n])
        assert got["time_gap_fixed"] == 0 and got["adaptive_lanes_departed"] == 0 and got["loss_gap"] < 1e-5


def test_moe_reference_matches_serve_generate_and_the_param_tree():
    model = lm.program_model(GRANITE, "cpu")
    gen = torch.Generator().manual_seed(3)
    params = weights.make_params(GRANITE, gen, "cpu")
    mine, theirs = weights.leaves(params), weights.leaves(model.init(torch.Generator().manual_seed(0)))
    assert {p: (t.shape, t.dtype) for p, t in mine.items()} == {p: (t.shape, t.dtype) for p, t in theirs.items()}
    from repro_torch.launch import serve

    toks = torch.randint(0, 512, (3, 64), generator=gen)
    res = serve.generate(model, params, toks, 1)
    ref = moe_lm.last_logits(params, GRANITE, toks)
    torch.testing.assert_close(res.prefill_logits, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(res.tokens[:, 0], ref.argmax(dim=1))


def test_train_reference_matches_make_train_step():
    from repro_torch.core.aggregation import CommModel
    from repro_torch.core.controller import PflugController
    from repro_torch.core.straggler import Exponential
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import adamw

    model = lm.program_model(GRANITE, "cpu")
    gen = torch.Generator().manual_seed(5)
    params = weights.make_params(GRANITE, gen, "cpu")
    p0 = {p: t.clone() for p, t in weights.leaves(params).items()}
    oc = {"lr": 3e-4, "weight_decay": 0.01, "b1": 0.9, "b2": 0.999, "eps": 1e-8}
    cc = {"k0": 1, "step": 1, "thresh": -2, "burnin": 1}  # k rises at the second step
    opt = adamw(oc["lr"], weight_decay=oc["weight_decay"])
    ctrl = PflugController(n_workers=4, k0=1, step=1, thresh=-2, burnin=1)
    step_fn = steps.make_train_step(model, opt, ctrl, Exponential(rate=1.0), 4, CommModel())
    state = steps.init_train_state(opt, ctrl, params)
    feed = [(weights.markov_tokens(8, 32, 512, gen, "cpu"), torch.randint(0, 2**32, (2,), generator=gen,
                                                                          dtype=torch.int64)) for _ in range(3)]
    prog = {"loss": [], "k": [], "sim_time": []}
    for i, ((tk, tg), key) in enumerate(feed):
        state, m = step_fn(state, {"tokens": tk, "targets": tg}, key)
        prog["loss"].append(float(m["loss"]))
        prog["k"].append(int(m["k"]))
        prog["sim_time"].append(float(m["sim_time"]))
        if i == 0:
            prog["grad_norms"] = {p: float(t.norm()) / 0.1 for p, t in weights.leaves(state.opt_state.mu).items()}
    prog["change_norms"] = {p: float((t - p0[p]).norm()) for p, t in weights.leaves(state.params).items()}
    ref = train_ref.train(p0, GRANITE, [f for f, _ in feed], [k for _, k in feed], 4, 1.0, cc, oc)
    assert prog["k"] == ref["k"] and len(set(ref["k"])) > 1  # Pflug switches inside the three steps
    got = train.compare(prog, ref)
    assert got["k_mismatch"] == 0 and got["sim_time_gap"] == 0
    assert got["loss_gap"] < 1e-5 and got["grad_norm_gap"] < 1e-4 and got["change_norm_gap"] < 1e-4
