"""repro_torch — the dataflow architectural template on PyTorch and CUDA.

The PyTorch/H100 port of the ``repro`` package: trace a loop body with
``torch.fx``, partition it with Algorithm 1, decouple it into stages,
run the stages, and simulate the dataflow machine against the
conventional one (Fig. 5).  Its kernels are hand-written CUDA for Hopper
(``csrc/``), with a plain PyTorch version beside each.

Entry points run on the CUDA card unless the caller asks for the CPU
(:func:`set_device` or ``device=`` on :func:`compile`).
"""

from ._device import get_device, set_device
from .core.cdfg import at_set
from .dataflow.driver import compile, dataflow_jit

__all__ = ["at_set", "compile", "dataflow_jit", "get_device", "set_device"]
