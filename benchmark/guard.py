"""The check that no JAX, nor the JAX package, ran in this process.

Module names are compared by their top-level name, the part before the
first dot, whole: ``montecarlo_gated_mil_tpu_torch`` (the port) begins with
the name of the JAX package ``montecarlo_gated_mil_tpu`` and is allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "montecarlo_gated_mil_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names in ``modules`` (default ``sys.modules``) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
