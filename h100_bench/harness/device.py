"""The card the run measures, and the modules it must not load."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, Iterable, List, Optional

#: top-level module names no run may load: JAX and the JAX package the
#: port was made from (compared whole, so ``qqq_tpu_torch`` passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "qqq_tpu")


def forbidden(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: what this
    process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def smi() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"name": "unknown", "power_limit": f"unread ({e})"}
    if not out:
        return {"name": "unknown", "power_limit": "unread"}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
