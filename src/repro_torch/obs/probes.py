"""Runtime probes: read-only views of stack internals as obs gauges.

The simulator's zero-post-warmup-recompile invariant
(``simulate/invariants.py``) needs a count of what the serving path builds
at first use; a production fleet wants the same number on its status
surface, because growth under churn means a tick paid a build.  In the
reference that is the JAX jit caches.  The port compiles nothing per
shape at run time except what :func:`jit_cache_entries` counts:

  * the CUDA libraries ``kernels.build.load`` has opened (one per source;
    the first call builds it with ``nvcc``, seconds to a minute);
  * the shape-keyed column tables of ``kernels.vision_ops`` (one per frame
    width, channels, model and gate resolution, method and device), built
    and uploaded at a shape's first kernel call;
  * the attention kernels' ticket counters
    (``kernels.attention_common.ticket_counters``), allocated at first
    use per device and kernel kind;
  * the paged token engines' prefill CUDA graphs
    (``serving.engine.GRAPH_SIGNATURES``), one entry per signature (arch,
    run options, device, pool geometry, chunk width) captured in the
    process, as the reference's jit caches hold one compile per traced
    signature: a new engine of a known signature captures its own graphs
    (they hold its pool) at its first admission, but adds no entry.

The other serving dispatch functions are plain closures made per engine
(``serving.engine.dispatch_fns``): nothing is cached per shape, so they
add nothing.  On the CPU every wrapper takes its plain version, no graph
is captured and none of these is built, so the count stays 0.

:func:`register_runtime_gauges` wires the probe (plus dispatch/backlog
readings) into a :class:`~repro_torch.obs.metrics.MetricsRegistry` as
probe gauges whose value is read fresh at exposition time.  Imports of the
serving stack happen inside the probe bodies, so obs stays import-light
and cycle-free.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.obs.metrics import MetricsRegistry

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.streams.gateway import FleetGateway


def jit_cache_entries() -> int:
    """Everything the port builds at first use (see the module docstring)
    — the quantity that must not grow after warmup, whatever the churn
    (the simulator's recompile invariant).  The name is the reference's."""
    from repro_torch.kernels import attention_common as ac
    from repro_torch.kernels import build
    from repro_torch.kernels import vision_ops as vk
    from repro_torch.serving import engine
    return (build.load.cache_info().currsize
            + vk._device_tables.cache_info().currsize
            + len(ac._COUNTERS) + len(engine.GRAPH_SIGNATURES))


def register_runtime_gauges(metrics: MetricsRegistry,
                            gw: "FleetGateway" = None) -> None:
    """Install the standard probe gauges: ``jit_cache_entries`` always,
    plus fleet occupancy/backlog gauges when a gateway is given.  Probe
    gauges call back into the live stack at read time — exposition always
    reflects the current state, with zero per-tick cost."""
    metrics.gauge(
        "jit_cache_entries",
        "kernel libraries, shape tables, ticket buffers and prefill graph "
        "signatures built at first use (growth after warmup = a build "
        "mid-run)",
    ).set_function(jit_cache_entries)
    if gw is None:
        return
    metrics.gauge(
        "fleet_sessions", "open vehicle sessions across the fleet",
    ).set_function(lambda: len(gw.sessions))
    metrics.gauge(
        "fleet_bound_lanes", "bound lanes across live vision replicas",
    ).set_function(lambda: sum(r.bound_count for r in gw.live_replicas()))
    metrics.gauge(
        "fleet_backlog_frames", "pending frames across live replicas",
    ).set_function(lambda: sum(
        len(st.pending) for r in gw.live_replicas()
        for st in r.streams.values()))
    metrics.gauge(
        "fleet_fused_dispatches",
        "fused fleet-tick calls issued (1 per tick with work, by the "
        "fleet_step contract)",
    ).set_function(lambda: gw._fleet.dispatches if gw._fleet else 0)
    if getattr(gw, "tiering", None) is not None:
        director = gw.tiering

        def _tier_agg(tier_name: str, fn):
            return lambda: sum(
                fn(r) for r in gw.live_replicas()
                if director.tiers.get(r.name) is not None
                and director.tiers[r.name].name == tier_name)

        for tname in sorted({t.name for t in director.tiers.values()}):
            metrics.gauge(
                f"fleet_tier_sessions_{tname}",
                f"open streams on live {tname}-tier replicas",
            ).set_function(_tier_agg(tname, lambda r: r.session_count))
            metrics.gauge(
                f"fleet_tier_backlog_{tname}",
                f"pending frames on live {tname}-tier replicas",
            ).set_function(_tier_agg(tname, lambda r: sum(
                len(st.pending) for st in r.streams.values())))
            metrics.gauge(
                f"fleet_tier_bound_{tname}",
                f"bound lanes on live {tname}-tier replicas",
            ).set_function(_tier_agg(tname, lambda r: r.bound_count))
        metrics.gauge(
            "fleet_standby_replicas",
            "replicas currently parked by the autoscaler",
        ).set_function(lambda: len(director.standby))
        metrics.gauge(
            "fleet_pressure",
            "autoscaler pressure EWMA (mean backlog per live slot)",
        ).set_function(director.fleet_pressure)
    if gw.token_replicas:
        metrics.gauge(
            "fleet_token_backlog",
            "token requests queued or decoding across the token fleet",
        ).set_function(gw.token_backlog)
        metrics.gauge(
            "fleet_token_replicas_live",
            "token replicas currently in service (not failed)",
        ).set_function(lambda: len(gw.live_token_replicas()))
    if gw.events is not None:
        ev = gw.events
        metrics.gauge(
            "fleet_event_spool_depth",
            "undelivered events buffered across every spool (partition "
            "backlog + unacked inflight)",
        ).set_function(ev.depth)
        metrics.gauge(
            "fleet_event_duplicates",
            "replayed deliveries the idempotent sink rejected "
            "(at-least-once redundancy, never double-processing)",
        ).set_function(lambda: ev.sink.duplicates)
        metrics.gauge(
            "fleet_event_overflow_dropped",
            "events dropped by bounded spools at capacity (each drop "
            "also warns loudly)",
        ).set_function(ev.overflow_dropped)
