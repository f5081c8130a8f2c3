"""Resolution-as-a-service: the persistent resolution daemon and its
thin client.

The daemon (:class:`~repro_torch.serve.daemon.ResolutionDaemon`) promotes
the resolution layer from a per-process library into a serving tier:
one global work-stealing scheduler over a shared spawn-pool of
chunk-graph workers, with store / in-flight / cold request dedup,
streamed per-chunk results, weighted per-client fairness with
backpressure, and a stats endpoint.  The client
(:mod:`repro_torch.serve.client`) plugs into ``simulate_dataflow_many(...,
server=...)`` — and through it ``Compiled.simulate/sweep/explore`` and
the Fig. 5 harness's ``--server auto|ADDR``.  The daemon and its workers
run on the device and engine of the process that started it;
:mod:`.faults` holds the fault-injection hooks.
"""

from .client import (ResolutionClient, ServeUnavailable, ensure_daemon,
                     get_stats, ping, prefetch, shutdown,
                     simulate_dataflow_served)
from .daemon import ResolutionDaemon
from .protocol import default_address

__all__ = [
    "ResolutionClient", "ResolutionDaemon", "ServeUnavailable",
    "default_address", "ensure_daemon", "get_stats", "ping",
    "prefetch", "shutdown", "simulate_dataflow_served",
]
