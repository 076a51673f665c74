"""Multi-tenant serving layer above :class:`repro_torch.api.Session` —
port of ``repro/serve/``, with the reference's eleven exports.

One :class:`Server` hosts several named tenants (several compiled plans, or
one model at several resolutions) over the shared cross-instance constant
cache, with continuous batching (a scheduler thread admits queued requests
into in-flight bucket dispatches — no ``flush()`` barriers), per-tenant SLO
admission control (typed :class:`Overloaded` shedding), rolling QoS
monitoring, and an open-loop Poisson load generator::

    from repro_torch.serve import SLO, Server, run_open_loop

    server = Server()     # tenants on CUDA unless given device="cpu"
    server.add_tenant("mnv2@112", plan_112, slo=SLO(p99_target_s=0.2))
    server.add_tenant("mnv2@96", plan_96, slo=SLO(p99_target_s=0.1))
    with server:
        reports = run_open_loop(server, {"mnv2@112": 200.0, "mnv2@96": 400.0},
                                make_input, duration_s=5.0)
"""
from .admission import SLO, AdmissionController, Overloaded
from .loadgen import LoadReport, run_open_loop, saturation_throughput
from .qos import QosMonitor, TenantQos
from .scheduler import EdfBatcher, QueuedRequest
from .server import Server

__all__ = [
    "AdmissionController",
    "EdfBatcher",
    "LoadReport",
    "Overloaded",
    "QosMonitor",
    "QueuedRequest",
    "SLO",
    "Server",
    "TenantQos",
    "run_open_loop",
    "saturation_throughput",
]
