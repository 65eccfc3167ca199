"""Core of the port: the paper's adaptive fastest-k SGD simulation engine.

Modules (each the torch port of the JAX package's module of that name):
  prng         — threefry-2x32 reproducing the engine's `jax.random` calls
  straggler    — response-time models, fleets, rate schedules, analytics
  aggregation  — fastest-k ranks, masks, order statistics, weighted loss,
                 and the robust aggregators (trimmed mean, coordinate
                 median, Weiszfeld geometric median)
  faults       — per-worker Byzantine and crash faults (FaultPlan) as
                 transforms on sampled times and gradients
  gradsource   — the GradSource protocol and PerExampleSource
  execmode     — the sync, K-async and K-batch-async modes as one carry
  controller   — Pflug (Algorithm 1), sketched Pflug, fixed k, the
                 Theorem-1 schedule, variance ratio
  theory       — Lemma-1 bound, Theorem-1 switching times (numpy)
  montecarlo   — R replicas of fastest-k SGD in any mode (vmap over
                 replicas; CUDA graphs of `unroll` iterations on the card)
  sweep        — a G-cell x R-replica grid as one program (vmap over G·R
                 lanes, through montecarlo's program), modes mixed
  simulate     — the R = 1 wrapper
  async_sim    — event-driven asynchronous SGD (fig3's baseline)

The sweep's mesh and the persistent cache are not ported yet (ROADMAP
Queue 1 items 13 and 12).
"""

from repro_torch.core import (  # noqa: F401
    aggregation,
    controller,
    execmode,
    faults,
    gradsource,
    montecarlo,
    prng,
    straggler,
    sweep,
    theory,
)
from repro_torch.core.aggregation import CommModel, fastest_k_mask, iteration_time  # noqa: F401
from repro_torch.core.controller import (  # noqa: F401
    FixedKController,
    PflugController,
    ScheduleController,
    SketchedPflugController,
    VarianceRatioController,
    get_controller,
)
from repro_torch.core.faults import FaultModel, FaultPlan, byzantine_plan  # noqa: F401
from repro_torch.core.gradsource import GradSource, PerExampleSource, SourceFns  # noqa: F401
from repro_torch.core.montecarlo import (  # noqa: F401
    MonteCarloResult,
    run_monte_carlo,
    run_monte_carlo_source,
    summarize,
)
from repro_torch.core.straggler import RateSchedule, WorkerFleet, get_straggler_model  # noqa: F401
from repro_torch.core.sweep import (  # noqa: F401
    GridSignature,
    SweepCase,
    SweepResult,
    clear_sweep_cache,
    grid_signature,
    product_cases,
    run_sweep,
    run_sweep_source,
    summarize_cells,
    sweep_cache_stats,
)
