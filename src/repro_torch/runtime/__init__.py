"""Runtime support: fault tolerance (the step guard and the straggler and
speculation policies the chunk-graph executor and the daemon use) and the
analytic per-step cost model."""

from . import cost_model, fault_tolerance

__all__ = ["cost_model", "fault_tolerance"]
