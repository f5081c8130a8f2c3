"""Runtime support: fault tolerance (the step guard and the straggler and
speculation policies the chunk-graph executor and the daemon use)."""

from . import fault_tolerance

__all__ = ["fault_tolerance"]
