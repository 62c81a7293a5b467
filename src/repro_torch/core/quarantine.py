"""The quarantine flag — one reader for every enforcement seam.

A node a test gate failed carries ``metadata["quarantined"] = True`` plus a
``metadata["quarantine"]`` record (DESIGN.md §9.4). The serving gate
(``repro_torch.serve.router``) refuses such a node traffic; push selection
and the hub's publish filter read the same flag once they are ported.
Copied from the reference package's ``repro/core/quarantine.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Union

QUARANTINE_FLAG = "quarantined"
QUARANTINE_RECORD = "quarantine"


def is_quarantined(node: Union["LineageNode", Dict[str, Any]]) -> bool:
    """Works on live nodes AND serialized node documents (sync payloads)."""
    metadata = node.get("metadata", {}) if isinstance(node, dict) \
        else node.metadata
    return bool(metadata.get(QUARANTINE_FLAG))
