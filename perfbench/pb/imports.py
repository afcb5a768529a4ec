"""What the process that prints the result may not hold: JAX, its
relatives and the JAX package the program was ported from. Module names
are compared by their top-level part as a whole word, since the program's
own name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpu7z"})


def forbidden_loaded(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
