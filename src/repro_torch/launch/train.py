"""Train an LM with adaptive fastest-k SGD: the port of the LM loop of
`repro/launch/train.py`, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu \\
        --steps 200 --batch 16 --seq 128 --controller pflug
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m --batch 8 --seq 512

Every registered arch trains: dense, moe (each row's loss carries the
router's load-balance term, as in the JAX package), ssm, hybrid, vlm and
encdec (fed zero patches or frames of the reference CLI's shapes,
`specs.stub_inputs`; the async modes refuse them, as the reference's do).

Each step is `launch.steps.make_train_step`: the same per-mode builders the
simulation engines run, around the model's loss, so ``--mode kasync`` and
``--mode kbatch`` run the async modes with no logic of their own.  It logs
one JSON line per ``--log-every`` steps (ce, k, simulated time), and
checkpoints to ``--ckpt-dir`` (resuming from its latest step) in the JAX
package's format.  Parameters are random, drawn on the device from
``--seed``; the token stream is `TokenStream` from ``--seed``, and the
straggler key splits once a step from `prng.PRNGKey(seed)`, so k and the
simulated clock follow the reference's CLI bit for bit.

Not ported yet (each flag raises, naming its ROADMAP item): ``--simulate``
(the controller x straggler sweep entry, item 18) with its ``--sim-*``
flags, ``--production-mesh`` and ``--distributed`` (item 13),
``--cache-dir`` (item 12).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import checkpoint, resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import execmode, prng, theory
from repro_torch.core.aggregation import CommModel
from repro_torch.core.controller import get_controller
from repro_torch.core.straggler import get_straggler_model
from repro_torch.data import TokenStream
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.specs import stub_inputs
from repro_torch.models import build_model
from repro_torch.optim import get_optimizer

# Flags of the reference's CLI whose machinery is not ported, and where it waits.
NOT_PORTED = {
    "simulate": "the sweep entry of the train CLI (ROADMAP Queue 1 item 18)",
    "production_mesh": "distribution (ROADMAP Queue 1 item 13)",
    "distributed": "distribution (ROADMAP Queue 1 item 13)",
    "cache_dir": "the persistent compilation cache (ROADMAP Queue 1 item 12)",
}


def make_controller(args, n_workers: int, straggler):
    ckw = {}
    if args.controller == "pflug":
        ckw = dict(k0=args.k0, step=args.k_step, thresh=args.thresh, burnin=args.burnin)
    elif args.controller == "sketched_pflug":
        ckw = dict(k0=args.k0, step=args.k_step, thresh=args.thresh, burnin=args.burnin,
                   sketch_dim=args.sketch_dim)
    elif args.controller == "fixed":
        ckw = dict(k=args.fixed_k)
    elif args.controller == "schedule":
        # Theorem-1 bound-optimal switch times from the straggler model's
        # order statistics and the supplied SGD constants
        sysm = theory.SGDSystem(
            eta=args.lr, L=args.schedule_smoothness, c=args.schedule_strong_convexity,
            sigma2=args.schedule_sigma2, s=args.batch // n_workers, F0_gap=args.schedule_f0_gap,
            n=n_workers, straggler=straggler,
        )
        times = theory.switching_times(sysm, list(range(args.k0, n_workers, args.k_step)), step=args.k_step)
        print(f"schedule: Theorem-1 switch times {[round(t, 2) for t in times]}")
        ckw = dict(switch_times=times, k0=args.k0, step=args.k_step)
    elif args.controller == "variance_ratio":
        ckw = dict(k0=args.k0, step=args.k_step, burnin=args.burnin)
    return get_controller(args.controller, n_workers, **ckw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--controller", default="pflug",
                    choices=["pflug", "sketched_pflug", "fixed", "schedule", "variance_ratio"])
    ap.add_argument("--k0", type=int, default=1)
    ap.add_argument("--k-step", type=int, default=1)
    ap.add_argument("--thresh", type=int, default=10)
    ap.add_argument("--burnin", type=int, default=20)
    ap.add_argument("--fixed-k", type=int, default=2)
    ap.add_argument("--sketch-dim", type=int, default=64, help="sketched_pflug: dimension of the gradient sketch")
    # --controller schedule: Theorem-1 switch times need the SGD system's
    # constants, which an LM run does not identify: estimates
    ap.add_argument("--schedule-smoothness", type=float, default=1.0, help="schedule: L (smoothness estimate)")
    ap.add_argument("--schedule-strong-convexity", type=float, default=0.1,
                    help="schedule: c (strong-convexity estimate)")
    ap.add_argument("--schedule-sigma2", type=float, default=1.0,
                    help="schedule: per-sample gradient variance estimate")
    ap.add_argument("--schedule-f0-gap", type=float, default=10.0, help="schedule: F(w0) - F* estimate")
    ap.add_argument("--mode", default="sync", choices=["sync", "kasync", "kbatch"],
                    help="execution mode (the per-mode step builders the simulation engines run)")
    ap.add_argument("--straggler", default="exponential",
                    choices=["exponential", "shifted_exponential", "pareto", "bimodal", "deterministic"])
    ap.add_argument("--comm-alpha", type=float, default=0.0)
    ap.add_argument("--comm-beta", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--simulate", action="store_true", help="not ported: raises")
    ap.add_argument("--production-mesh", action="store_true", help="not ported: raises")
    ap.add_argument("--distributed", action="store_true", help="not ported: raises")
    ap.add_argument("--cache-dir", default=None, metavar="DIR", help="not ported: raises")
    args = ap.parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not ported yet")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, dev)
    n_workers = args.n_workers
    if args.batch % n_workers:
        raise SystemExit(f"--batch {args.batch} must be divisible by --n-workers {n_workers}")

    opt = get_optimizer(args.optimizer, args.lr)
    straggler = get_straggler_model(args.straggler)
    controller = make_controller(args, n_workers, straggler)
    comm = CommModel(alpha=args.comm_alpha, beta=args.comm_beta)
    train_step = steps_lib.make_train_step(model, opt, controller, straggler, n_workers, comm, mode=args.mode)
    data = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
                       device=args.device)

    key = prng.PRNGKey(args.seed, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = steps_lib.init_train_state(opt, controller, params)
    start = 0
    if args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            like = state
            if args.mode != "sync":
                # an async checkpoint holds the renewal state (the reference's
                # restore, into the initial state, refuses one)
                c = execmode.init_exec_carry(state.params, n_workers, state.ctrl_state, key)
                like = state._replace(exec_async=(c.worker_params, c.remaining, c.staleness, c.pending))
            state = checkpoint.restore(args.ckpt_dir, latest, like)
            start = latest
            print(f"restored step {latest} from {args.ckpt_dir}")

    stubs = stub_inputs(cfg, args.batch, dev)
    t0 = time.time()
    for step in range(start, args.steps):
        tokens, targets = data.batch_at(step)
        key, sub = prng.split(key).unbind(0)
        state, metrics = train_step(state, {"tokens": tokens, "targets": targets, **stubs}, sub)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(json.dumps({
                "step": step,
                "ce": round(float(metrics["ce"]), 4),
                "k": int(metrics["k"]),
                "sim_time": round(float(metrics["sim_time"]), 2),
                "iter_time": round(float(metrics["iter_time"]), 3),
                "wall_s": round(time.time() - t0, 1),
            }), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, state)
        print(f"saved final checkpoint at step {args.steps}")


if __name__ == "__main__":
    main()
