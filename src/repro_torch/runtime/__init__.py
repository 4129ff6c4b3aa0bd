from repro_torch.runtime import channels, faults, simulator, topologies  # noqa: F401
from repro_torch.runtime.engine import ENGINES, Engine, make_engine  # noqa: F401
from repro_torch.runtime.simulator import SimConfig, Simulator, SimResult  # noqa: F401
from repro_torch.runtime.topologies import Topology, make_topology  # noqa: F401
