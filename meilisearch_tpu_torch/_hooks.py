"""The guard that keeps jax out of the port's processes.

The port imports nothing of jax, but the machine that runs it may have
jax installed, and a library that imports it would start an XLA backend
on the GPU beside torch. `block_jax` makes jax, jaxlib and flax
unimportable in the current process; the port's process entry points
(the server and `chip_smoke.py`) call it first.
"""

from __future__ import annotations

import sys

_JAX_PACKAGES = ("jax", "jaxlib", "flax")


def block_jax() -> None:
    """Make jax, jaxlib and flax unimportable in this process (a None entry
    in sys.modules: `import` raises ImportError, `find_spec` answers None).
    Raises if jax is already loaded."""
    loaded = [
        m for m, mod in sys.modules.items()
        if mod is not None and m.partition(".")[0] in _JAX_PACKAGES
    ]
    if loaded:
        raise RuntimeError(f"jax is already imported: {loaded[:3]}")
    for name in _JAX_PACKAGES:
        sys.modules[name] = None
