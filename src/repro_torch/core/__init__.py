"""repro_torch.core — the paper's contribution on PyTorch.

Pipeline:  trace (CDFG on torch.fx) → partition (Algorithm 1) → decouple
(stage programs) → execute (sequential / emulated or ranked systolic /
pipeline-parallel) or simulate (Fig. 2/5).
"""

from .cdfg import (CDFG, DEFAULT_LATENCY, MEMORY_PRIMITIVES, LatencyModel,
                   add_memory_order_edges, annotate_memory_regions)
from .partition import (Channel, Partition, Stage, StagePlan,
                        derive_channels, duplicate_cheap_rewrite, fused_plan,
                        materialize, maximal_plan, merge_costly_boundaries,
                        merge_move, neighbor_plans, partition_cdfg,
                        plan_is_legal, plan_signature, split_move,
                        stage_groups)
from .decouple import (DecoupledProgram, decouple, decoupled_call,
                       run_stages_sequential)
from .channels import ChannelSpec, DeviceFIFO, FIFOState, HostFIFO
from .pipeline import (SystolicPipeline, gpipe_bubble_fraction,
                       pipeline_apply, pipeline_apply_emulated)
from . import simulator

__all__ = [
    "CDFG", "LatencyModel", "MEMORY_PRIMITIVES", "DEFAULT_LATENCY",
    "add_memory_order_edges", "annotate_memory_regions",
    "Partition", "Stage", "StagePlan", "Channel", "partition_cdfg",
    "stage_groups", "merge_costly_boundaries", "materialize",
    "duplicate_cheap_rewrite", "derive_channels",
    "plan_signature", "plan_is_legal", "merge_move", "split_move",
    "neighbor_plans", "fused_plan", "maximal_plan",
    "DecoupledProgram", "decouple", "decoupled_call",
    "run_stages_sequential",
    "ChannelSpec", "DeviceFIFO", "FIFOState", "HostFIFO",
    "SystolicPipeline", "pipeline_apply", "pipeline_apply_emulated",
    "gpipe_bubble_fraction",
    "simulator",
]
