"""MGit model hub: a worker-pool HTTP daemon serving one or many repositories.

The multi-user face of the system (paper §5 collaboration; DESIGN.md §11,
§16): :class:`HubApp` wraps a repo's lineage document + transfer journal
with concurrent-push safety (optimistic lineage swap -> HTTP 409) and
server-side quarantine policy; :class:`HubService` scales that to many
repos over one shared CAS (cross-repo dedup, union-root refcounts,
orphan GC via :mod:`repro_torch.hub.gc`); :mod:`repro_torch.hub.replica` adds
read-replica hubs and a replica-aware client transport.
:mod:`repro_torch.hub.routes` exposes it all over a small REST surface that
:class:`repro_torch.remote.http.HttpTransport` speaks from the client side, so
``push``/``pull``/``clone`` work unchanged against ``http://`` remotes —
including repo-scoped ``http://hub/r/<name>`` URLs.

Start one in a thread of the calling process with :func:`start_in_thread`.

Copied from the reference package's ``repro/hub/__init__.py``; only the imports
differ.
"""

from repro_torch.hub.app import HubApp, HubService, ReadOnlyRepo
from repro_torch.hub.auth import TokenAuth
from repro_torch.hub.routes import (HubRequestHandler, HubServer, make_server,
                              start_in_thread)

__all__ = ["HubApp", "HubService", "ReadOnlyRepo", "TokenAuth",
           "HubRequestHandler", "HubServer", "make_server",
           "start_in_thread"]
