"""Bearer-token auth stub for the hub daemon (DESIGN.md §11.5).

Deliberately minimal: one shared secret per daemon, compared in constant
time. The seam a real deployment swaps for per-user tokens/OAuth is the
single :meth:`TokenAuth.check` call in the request handler — routes never
see credentials, only an allow/deny.

Copied from the reference package's ``repro/hub/auth.py``; only the imports
differ.
"""

from __future__ import annotations

import hmac
from typing import Optional


class TokenAuth:
    """``TokenAuth(None)`` allows everything (open hub, loopback dev use);
    with a token set, requests must carry ``Authorization: Bearer <token>``.
    """

    def __init__(self, token: Optional[str] = None) -> None:
        self.token = token or None

    @property
    def enabled(self) -> bool:
        return self.token is not None

    def check(self, authorization_header: Optional[str]) -> bool:
        """True when the request may proceed."""
        if self.token is None:
            return True
        if not authorization_header:
            return False
        scheme, _, presented = authorization_header.partition(" ")
        if scheme.lower() != "bearer":
            return False
        return hmac.compare_digest(presented.strip(), self.token)
