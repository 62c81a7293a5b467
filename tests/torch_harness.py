"""The fault harness of ``tests/harness/`` for the port, and the two
packages side by side for the collaboration parity tests.

``tests/harness/`` arms the reference's kill-point registry
(``repro.common.faults``) and builds its fault transports on the
reference's ``HttpTransport``; the port has a registry of its own
(``repro_torch.common.faults``) and its own transports. So this module:

* arms either package's kill-point registry the way ``harness.faults``
  arms the reference's (:func:`crash_at`);
* builds ``RacingTransport``, ``FlakyHttpTransport`` and ``AppTransport``
  over either package's transport classes (:func:`fault_transports`);
* re-exports the invariant checks of ``harness.invariants``, which call
  only the store methods both packages share;
* describes each package as a namespace (:data:`REF`, :data:`PORT`) so a
  test body runs unchanged in both: the port's stores, hubs, clones and
  directory transports are opened with ``backend="ref"`` (the host's
  plain versions), the reference's as they are.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import types
from typing import Dict, Iterator, Mapping, Optional, Sequence
from typing import Set, Tuple

import repro.core as rcore
import repro.hub as rhub
import repro.hub.replica as rreplica
import repro.remote as rremote
import repro.remote.http as rhttp
import repro.remote.transport as rtransport
from repro.common import faults as rfaults
from repro.diag import gate as rgate
from repro.store import ArtifactStore as RefStore

import repro_torch.core as tcore
import repro_torch.hub as thub
import repro_torch.hub.replica as treplica
import repro_torch.remote as tremote
import repro_torch.remote.http as thttp
import repro_torch.remote.transport as ttransport
from repro_torch.common import faults as tfaults
from repro_torch.diag import gate as tgate
from repro_torch.store import ArtifactStore as PortStore

from harness.invariants import assert_bit_identical, check_service


@contextlib.contextmanager
def crash_at(name: str, after: int = 0, count: int = 1,
             faults=tfaults) -> Iterator[None]:
    """Arm ``name`` in ``faults`` (the port's registry unless given) to
    raise its ``KillPointError`` on the next ``count`` hits after
    ``after``, disarming on exit either way."""
    faults.arm(name, after=after, count=count)
    try:
        yield
    finally:
        faults.disarm(name)


def fault_transports(http_mod, transport_mod) -> types.SimpleNamespace:
    """``RacingTransport``, ``FlakyHttpTransport`` and ``AppTransport`` of
    ``harness.transports``, built on ``http_mod.HttpTransport`` and
    ``transport_mod.Transport`` (either package's)."""

    class RacingTransport(http_mod.HttpTransport):
        """Injects a competing publish between our fetch and our publish."""

        def __init__(self, url, app, racer_payload, **kw):
            super().__init__(url, **kw)
            self._app = app
            self._racer_payload = racer_payload
            self._raced = False

        def publish_lineage(self, payload, expected=None):
            if not self._raced:
                self._raced = True
                self._app.publish(self._racer_payload)
            return super().publish_lineage(payload, expected=expected)

    class FlakyHttpTransport(http_mod.HttpTransport):
        """Connection drops after N successful object uploads."""

        def __init__(self, url, fail_after=1, **kw):
            super().__init__(url, **kw)
            self.fail_after = fail_after
            self._writes = 0
            self._guard = threading.Lock()

        def write_objects(self, objects):
            with self._guard:
                self._writes += 1
                n = self._writes
            if n > self.fail_after:
                raise ConnectionError("simulated mid-push network drop")
            super().write_objects(objects)

    class AppTransport(transport_mod.Transport):
        """In-process Transport over a HubApp, minus the socket layer."""

        def __init__(self, app) -> None:
            self.app = app
            self.url = f"app://{app.name}"

        def ensure_repo(self) -> None:
            pass

        def fetch_lineage(self) -> Optional[Dict]:
            return self.app.lineage()[0]

        def fetch_lineage_versioned(self) -> Tuple[Optional[Dict], str]:
            return self.app.lineage()

        def publish_lineage(self, payload: Dict,
                            expected: Optional[str] = None) -> Optional[Dict]:
            return self.app.publish(payload, expected=expected)

        def have(self, keys: Sequence[str]) -> Set[str]:
            return set(self.app.have(keys))

        def read_objects(self, keys: Sequence[str]) -> Dict[str, bytes]:
            cas = self.app.store.cas
            return {k: cas.get_bytes(k) for k in keys if cas.has(k)}

        def object_sizes(self, keys: Sequence[str]
                         ) -> Optional[Dict[str, int]]:
            sizes, _missing = self.app.object_sizes(keys)
            return sizes

        def write_objects(self, objects: Mapping[str, bytes]) -> None:
            self.app.import_objects(dict(objects))

        def finalize(self, roots: Sequence[str]) -> None:
            self.app.finalize()

        def journal_load(self, transfer_id: str) -> Optional[Dict]:
            return self.app.journal.journal_load(transfer_id)

        def journal_write(self, transfer_id: str, payload: Dict) -> None:
            self.app.journal.journal_write(transfer_id, payload)

        def journal_clear(self, transfer_id: str) -> None:
            self.app.journal.journal_clear(transfer_id)

        def journal_list(self) -> Sequence[str]:
            return self.app.journal.journal_list()

    return types.SimpleNamespace(RacingTransport=RacingTransport,
                                 FlakyHttpTransport=FlakyHttpTransport,
                                 AppTransport=AppTransport)


def _package(name, core, remote, hub, replica, http, transport, faults,
             gate, store_cls, backend):
    kw = {} if backend is None else {"backend": backend}
    return types.SimpleNamespace(
        name=name, core=core, remote=remote, hub=hub, http=http,
        sync=importlib.import_module(f"{remote.__name__}.sync"),
        negotiate=importlib.import_module(f"{remote.__name__}.negotiate"),
        faults=faults, quarantine_flag=gate.QUARANTINE_FLAG,
        store=lambda root, **store_kw: store_cls(root=root, **store_kw, **kw),
        local=lambda url: remote.LocalTransport(url, **kw),
        clone=lambda url, dest, **c_kw: remote.clone(url, dest, **c_kw, **kw),
        hub_app=lambda root, **h_kw: hub.HubApp(root, **h_kw, **kw),
        service=lambda root, **s_kw: hub.HubService(root, **s_kw, **kw),
        replica_hub=lambda root, url, **r_kw: replica.ReplicaHub(
            root, url, **r_kw, **kw),
        ReplicaSetTransport=replica.ReplicaSetTransport,
        transports=fault_transports(http, transport))


REF = _package("ref", rcore, rremote, rhub, rreplica, rhttp, rtransport,
               rfaults, rgate, RefStore, None)
PORT = _package("port", tcore, tremote, thub, treplica, thttp, ttransport,
                tfaults, tgate, PortStore, "ref")

__all__ = ["crash_at", "fault_transports", "assert_bit_identical",
           "check_service", "REF", "PORT"]
