"""RunConfig: one frozen carrier for a run's strategy axes (DESIGN.md §11).

Every entry point that launches an engine — the experiments CLI, the
benchmarks, library callers — used to thread the same loose kwargs
(``shards=``, ``layout=``, ``scheduler=``, ``superstep_windows=``, ...)
through its own plumbing, each with its own defaulting and validation.
:class:`RunConfig` replaces that with a single immutable value:

    rc = RunConfig(engine="jax", layout="dense", scheduler="superstep",
                   shards=8, superstep_windows=4)
    eng = make_engine(rc, app, sim_cfg)

The axes are *orthogonal strategies*, not backend internals:

  engine             registered backend name (``event`` / ``jax``)
  layout             duct ring memory layout (``auto``/``dense``/``edge``,
                     DESIGN.md §10/§13; ``auto`` resolves to the bucketed
                     dense layout on every built-in topology)
  scheduler          exchange cadence (``auto``/``window``/``superstep``/
                     ``pipelined``, DESIGN.md §9/§12/§13; ``auto`` follows
                     ``superstep_windows``)
  shards             device-mesh partitions (1 = single device)
  superstep_windows  windows fused per exchange for the superstep /
                     pipelined schedulers (and per ring commit for the
                     unsharded W-fused megakernel)
  replicates         seeds per sweep point (one vmapped dispatch on jax)
  qos_interval       QoS snapshot spacing in virtual seconds (None = the
                     caller's default, usually duration / 12)

Only *domain* checks live here (is the word known, is the count
positive).  Cross-axis rules — which combinations a given engine accepts —
stay in ``engine._validate`` against the registered
:class:`~repro_torch.runtime.engine.EngineSpec`, so they are enforced once, for
every entry point, with the registry's vocabulary in the message.

``SimConfig`` describes the simulated world (latencies, horizon, buffer
capacity); ``RunConfig`` describes how this process executes it.  The two
never overlap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: RunConfig's layout vocabulary ("auto" + engine.LAYOUTS)
LAYOUT_CHOICES = ("auto", "dense", "edge")
#: RunConfig's scheduler vocabulary ("auto" + engine.SCHEDULERS)
SCHEDULER_CHOICES = ("auto", "window", "superstep", "pipelined")

#: make_engine kwargs that RunConfig subsumes (the legacy loose-kwargs
#: spelling routes through these names; see engine.make_engine's shim)
STRATEGY_KEYS = ("layout", "scheduler", "shards", "superstep_windows")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Immutable strategy selection for one run (or one sweep point)."""

    engine: str = "event"
    layout: str = "auto"
    scheduler: str = "auto"
    shards: int = 1
    superstep_windows: int = 1
    replicates: int = 1
    qos_interval: Optional[float] = None

    def __post_init__(self):
        if not self.engine or not isinstance(self.engine, str):
            raise ValueError(f"engine must be a backend name, got "
                             f"{self.engine!r}")
        if self.layout not in LAYOUT_CHOICES:
            raise ValueError(f"unknown layout {self.layout!r}; choose from "
                             f"{LAYOUT_CHOICES}")
        if self.scheduler not in SCHEDULER_CHOICES:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; choose "
                             f"from {SCHEDULER_CHOICES}")
        for field in ("shards", "superstep_windows", "replicates"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if self.qos_interval is not None and not self.qos_interval > 0:
            raise ValueError(f"qos_interval must be positive, got "
                             f"{self.qos_interval!r}")

    # ------------------------------------------------------------------
    @classmethod
    def from_args(cls, args) -> "RunConfig":
        """Build from an argparse namespace (missing attrs keep defaults).

        The experiments CLI and the benchmark runners share flag names
        (``--engine --layout --scheduler --shards --superstep-windows
        --replicates --qos-interval``), so one constructor covers them all.
        """
        defaults = cls()
        return cls(**{f.name: getattr(args, f.name, getattr(defaults, f.name))
                      for f in dataclasses.fields(cls)})

    def to_dict(self) -> dict:
        """JSON-ready mapping of every axis (result-row provenance)."""
        return dataclasses.asdict(self)

    def engine_kwargs(self) -> dict:
        """The strategy kwargs ``make_engine`` forwards to the registry.

        ``replicates`` and ``qos_interval`` are run-level concerns (seed
        sweep size, SimConfig snapshot spacing) — not engine options — so
        they are deliberately absent.
        """
        return dict(layout=self.layout, scheduler=self.scheduler,
                    shards=self.shards,
                    superstep_windows=self.superstep_windows)

    def seeds(self, base_seed: int) -> list:
        """The replicate seed sweep rooted at ``base_seed``."""
        return [int(base_seed) + r for r in range(self.replicates)]
