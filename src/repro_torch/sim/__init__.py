"""Grid engine (port of ``repro.sim``)."""
from repro_torch.sim.engine import GridEngine, GridResult, run_grid

__all__ = ["GridEngine", "GridResult", "run_grid"]
