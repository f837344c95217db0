"""The check that a run loaded neither JAX nor the JAX package.

Names are compared whole, by the part before the first dot: the port,
`svt_av1_psyex_tpu_torch`, begins with the JAX package's name and must
pass.
"""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "svt_av1_psyex_tpu"})


def forbidden_modules(names) -> list[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
