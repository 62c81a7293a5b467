"""Lineage-native serving (DESIGN.md §13).

``repro_torch.serve`` turns the repo into an inference tier: a
:class:`~repro_torch.serve.pool.ModelPool` keeps one chain base resident
and derives N hot-swappable views by delta application (the serving
analogue of the storage dedup, through the chain-apply kernel on the
card), a :class:`~repro_torch.serve.router.Router` maps named endpoints to
*branch heads* with the quarantine flag as a serving gate, a
:class:`~repro_torch.serve.watch.LineageWatcher` hot-swaps endpoints on
lineage publishes, and :mod:`repro_torch.serve.routes` exposes it all over
HTTP. :class:`~repro_torch.serve.engine.ServeEngine` is the batched
prefill/decode engine for every model family, whose prefill runs the
flash-attention kernel on the card.
"""

from repro_torch.serve.engine import (ServeEngine, batch_lengths,
                                      graph_eligible, left_align,
                                      make_prefill_step, make_serve_step)
from repro_torch.serve.pool import BitIdentityError, ModelPool, ResidentView
from repro_torch.serve.router import (Endpoint, EndpointUnavailable, Router,
                                      parse_endpoint_spec, resolve_branch_head)
from repro_torch.serve.routes import ServeApp, make_server, start_in_thread
from repro_torch.serve.watch import (HubLineageSource, LineageWatcher,
                                     LocalLineageSource)

__all__ = [
    "ServeEngine", "batch_lengths", "graph_eligible", "left_align",
    "make_prefill_step", "make_serve_step",
    "BitIdentityError", "ModelPool", "ResidentView",
    "Endpoint", "EndpointUnavailable", "Router",
    "parse_endpoint_spec", "resolve_branch_head",
    "ServeApp", "make_server", "start_in_thread",
    "HubLineageSource", "LineageWatcher", "LocalLineageSource",
]
