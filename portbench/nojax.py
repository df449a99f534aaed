"""The check that nothing the benchmark runs has loaded JAX or the JAX
package: top-level module names compared whole, since the port's name,
``reseek_tpu_torch``, begins with the JAX package's, ``reseek_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "reseek_tpu")


def loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
