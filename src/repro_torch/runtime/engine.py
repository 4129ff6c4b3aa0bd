"""Engine protocol + registry of the torch port: one contract, two backends.

Every backend consumes the same inputs (an application exposing
``n_processes`` / ``topology()`` / fragments or a batched step, a
:class:`~repro_torch.runtime.simulator.SimConfig`, an optional
:class:`~repro_torch.runtime.faults.FaultModel`) and produces the same
:class:`~repro_torch.runtime.simulator.SimResult`, so experiment families
and tests are backend-agnostic.

Each backend registers an :class:`EngineSpec` declaring its capability
surface (duct layouts, window schedulers), so callers can validate options
before anything is built: a bad combination fails with one actionable
``ValueError``.

Registered backends:

  event   ``runtime/simulator.py`` — discrete-event heap loop; exact event
          ordering, the reference semantics and the bitwise oracle
  torch   ``runtime/engine_torch.py`` — vectorized windowed-time engine on
          torch tensors, dense duct layout, per-window or W-fused superstep
          scheduler; runs on CUDA (hand-written duct kernels) unless the
          caller passes ``device="cpu"``

Callers select strategies with one frozen
:class:`~repro_torch.runtime.config.RunConfig` value
(``make_engine(RunConfig(engine="torch", superstep_windows=8), app, cfg,
device="cuda")``); the loose-kwargs spelling survives behind a deprecation
shim (:func:`_resolve_run`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

from repro_torch.runtime.config import STRATEGY_KEYS, RunConfig
from repro_torch.runtime.faults import FaultModel
from repro_torch.runtime.simulator import SimConfig, SimResult, Simulator

#: window schedulers an engine may declare (EngineSpec.schedulers)
SCHEDULERS: Tuple[str, ...] = ("window", "superstep", "pipelined")
#: duct layouts an engine may declare (EngineSpec.layouts); resolution
#: against a concrete topology lives in ``topologies.plan_layout``
LAYOUTS: Tuple[str, ...] = ("edge", "dense")

_SERVICE_MISSING = (
    "open-loop service arrivals (arrival_rate > 0) are not ported to "
    "repro_torch yet; run them on the reference "
    "(python -m repro.runtime.experiments --family serve)")


@runtime_checkable
class Engine(Protocol):
    """What every simulation backend must provide."""

    name: str

    def run(self) -> SimResult:
        """Execute the configured run and return the QoS result."""
        ...


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A registered backend plus its declared capability surface."""

    name: str
    factory: Callable[..., Engine]
    description: str
    #: duct layouts the backend accepts (beyond the implicit "auto")
    layouts: Tuple[str, ...] = ()
    #: window schedulers the backend offers; "window" = per-window
    schedulers: Tuple[str, ...] = ("window",)
    #: accepts shards > 1 (mesh-sharded dispatch)
    shardable: bool = False
    #: vectorized windowed-time semantics (vs exact event ordering)
    vectorized: bool = False

    def __post_init__(self):
        bad = set(self.layouts) - set(LAYOUTS)
        if bad:
            raise ValueError(
                f"engine {self.name!r} declares unknown layouts {sorted(bad)}; "
                f"known: {LAYOUTS}")
        bad = set(self.schedulers) - set(SCHEDULERS)
        if bad:
            raise ValueError(
                f"engine {self.name!r} declares unknown schedulers "
                f"{sorted(bad)}; known: {SCHEDULERS}")


def _make_event(app, cfg: SimConfig, faults: Optional[FaultModel],
                **kwargs) -> Engine:
    if kwargs:
        raise TypeError(f"unknown engine options {sorted(kwargs)}")
    if cfg.arrival_rate > 0:
        raise ValueError(_SERVICE_MISSING)
    return Simulator(app, cfg, faults)


def _make_torch(app, cfg: SimConfig, faults: Optional[FaultModel],
                **kwargs) -> Engine:
    # deferred import: the engine module pulls in the kernel wrappers
    kwargs.pop("shards", None)
    from repro_torch.runtime.engine_torch import TorchEngine
    return TorchEngine(app, cfg, faults, **kwargs)


_REGISTRY: Dict[str, EngineSpec] = {}


def register_engine(spec: EngineSpec) -> EngineSpec:
    """Register (or replace) a backend under ``spec.name``."""
    _REGISTRY[spec.name] = spec
    return spec


def engine_specs() -> Tuple[EngineSpec, ...]:
    """All registered backends, in registration order."""
    return tuple(_REGISTRY.values())


def get_engine_spec(name: str) -> EngineSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; choose from {sorted(_REGISTRY)}")


register_engine(EngineSpec(
    name="event",
    factory=_make_event,
    description="discrete-event heap loop; exact event ordering "
                "(the reference semantics)",
))
register_engine(EngineSpec(
    name="torch",
    factory=_make_torch,
    description="vectorized windowed-time engine on torch tensors over the "
                "dense duct layout; hand-written CUDA duct kernels on the "
                "card, plain torch on the CPU",
    layouts=("dense",),
    schedulers=("window", "superstep"),
    vectorized=True,
))

#: engine name -> factory (the CLI builds its --engine choices from it)
ENGINES = {name: spec.factory for name, spec in _REGISTRY.items()}


def _validate(spec: EngineSpec, kwargs: dict) -> dict:
    """Resolve strategy kwargs against ``spec``; mutates a copy of kwargs.

    Understands the three orthogonal axes — ``shards`` (partitioning),
    ``layout`` (duct memory layout), ``scheduler`` + ``superstep_windows``
    (exchange cadence) — and raises one actionable error per bad
    combination.  ``device`` goes to vectorized engines only.  Remaining
    kwargs pass through to the factory untouched.
    """
    kwargs = dict(kwargs)
    shards = kwargs.get("shards", 1) or 1
    superstep = kwargs.get("superstep_windows", 1) or 1
    layout = kwargs.get("layout", "auto")
    scheduler = kwargs.pop("scheduler", "auto")

    if shards > 1 and not spec.shardable:
        raise ValueError(
            f"the {spec.name} engine is single-device; --shards needs the "
            "sharded engine, which is not ported to repro_torch yet")
    if layout != "auto" and layout not in spec.layouts:
        if not spec.layouts:
            raise ValueError(
                f"--layout selects the vectorized engines' duct layout; the "
                f"{spec.name} engine has none — use --engine torch")
        raise ValueError(
            f"unknown layout {layout!r} for engine {spec.name!r}; choose "
            f"from {('auto',) + spec.layouts}"
            + (" (the edge-major layout is not ported to repro_torch yet)"
               if layout == "edge" else ""))

    if scheduler == "auto":
        scheduler = "superstep" if superstep > 1 else "window"
    if scheduler not in SCHEDULERS:
        raise ValueError(
            f"unknown scheduler {scheduler!r}; choose from "
            f"{('auto',) + SCHEDULERS}")
    if scheduler not in spec.schedulers:
        raise ValueError(
            f"the {spec.name} engine has no {scheduler!r} scheduler "
            f"(offers: {spec.schedulers}); --superstep-windows requires "
            "--engine torch" if scheduler == "superstep" else
            f"the {spec.name} engine has no {scheduler!r} scheduler "
            f"(offers: {spec.schedulers})")
    if scheduler == "superstep":
        if superstep <= 1:
            raise ValueError(
                "scheduler='superstep' fuses W windows per ring commit; "
                "pass superstep_windows > 1 (--superstep-windows W) to "
                "choose W")
    elif superstep > 1:
        raise ValueError(
            "scheduler='window' exchanges every lockstep window, but "
            f"superstep_windows={superstep} was given; drop it or pass "
            "scheduler='superstep'")

    # the event factory takes no strategy kwargs at all; strip the
    # defaults we resolved so TypeError stays reserved for true unknowns
    if not spec.vectorized:
        for key in ("shards", "superstep_windows", "layout", "device"):
            kwargs.pop(key, None)
    else:
        kwargs["scheduler"] = scheduler
    return kwargs


def _resolve_run(run: Union[RunConfig, str], kwargs: dict) -> Tuple[str, dict]:
    """Normalize the two calling conventions to (engine name, kwargs).

    The preferred form passes a :class:`RunConfig` first; the legacy form
    (an engine-name string plus loose strategy kwargs) still works, with a
    :class:`DeprecationWarning` pointing at RunConfig.  Backend extras
    (``max_pops``, ``chunk``, ``device``, ...) pass through either way.
    """
    if isinstance(run, RunConfig):
        clash = sorted(set(kwargs) & set(STRATEGY_KEYS))
        if clash:
            raise TypeError(
                f"strategy kwargs {clash} conflict with the RunConfig; "
                "set them on the RunConfig instead")
        return run.engine, {**run.engine_kwargs(), **kwargs}
    legacy = sorted(set(kwargs) & set(STRATEGY_KEYS))
    if legacy:
        warnings.warn(
            f"passing {legacy} as loose kwargs is deprecated; build a "
            "repro_torch.runtime.config.RunConfig and pass it as the first "
            "argument (make_engine(RunConfig(engine=..., ...), app, cfg))",
            DeprecationWarning, stacklevel=3)
    return run, kwargs


def make_engine(run: Union[RunConfig, str], app, cfg: SimConfig,
                faults: Optional[FaultModel] = None, **kwargs) -> Engine:
    """Build a registered engine from a RunConfig (or a name, legacy).

    ``kwargs`` are backend extras such as ``max_pops`` / ``chunk`` /
    ``device`` (the torch engine runs on ``"cuda"`` unless given
    ``device="cpu"``).  The event engine accepts none.
    """
    name, kwargs = _resolve_run(run, kwargs)
    spec = get_engine_spec(name)
    kwargs = _validate(spec, kwargs)
    return spec.factory(app, cfg, faults, **kwargs)


def validate_run_config(run: RunConfig) -> None:
    """Eagerly check a RunConfig against its engine's registered spec, so
    a bad combination fails before any app or tensor is built."""
    spec = get_engine_spec(run.engine)
    _validate(spec, run.engine_kwargs())


def run_replicates(run: Union[RunConfig, str], make_app, cfg: SimConfig,
                   seeds: Optional[Sequence[int]] = None,
                   faults: Optional[FaultModel] = None,
                   **engine_kwargs) -> List[SimResult]:
    """Run one replicate per seed.

    ``make_app(seed)`` builds a fresh application per replicate.  Backends
    exposing ``run_replicates`` (the torch engine, which runs the seeds one
    after another on one engine) get all seeds at once; others loop.
    ``cfg.seed`` is overridden by each replicate's seed.  With a
    :class:`RunConfig` first argument, ``seeds`` may be omitted: the sweep
    is ``run.seeds(cfg.seed)``.
    """
    if seeds is None:
        if not isinstance(run, RunConfig):
            raise TypeError("seeds may only be omitted when a RunConfig "
                            "is passed (its replicates field sizes the "
                            "sweep)")
        seeds = run.seeds(cfg.seed)
    eng = make_engine(run, make_app(int(seeds[0])),
                      dataclasses.replace(cfg, seed=int(seeds[0])), faults,
                      **engine_kwargs)
    if hasattr(eng, "run_replicates"):
        return eng.run_replicates([int(s) for s in seeds])
    out = [eng.run()]
    for s in seeds[1:]:
        eng = make_engine(run, make_app(int(s)),
                          dataclasses.replace(cfg, seed=int(s)), faults,
                          **engine_kwargs)
        out.append(eng.run())
    return out
