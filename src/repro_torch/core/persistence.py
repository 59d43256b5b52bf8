"""Persistence of tuned configurations: the canonical key format.

Mirrors ``repro/core/persistence.py``. Only the canonical JSON identity
is ported so far; the registry, its backends and the fleet merge follow
with the tuning front door.
"""

from __future__ import annotations

import json
from typing import Any


def _canon(obj: Any) -> str:
    """Canonical JSON identity used by BOTH the tuned-point registry and
    the generation cache (``repro_torch.core.compilette``), so the two key
    formats can never silently diverge. Deliberately STRICT: a
    non-JSON-serializable specialization value raises here, loudly —
    stringifying it would embed memory addresses in persisted keys and
    silently break warm starts across restarts."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))
