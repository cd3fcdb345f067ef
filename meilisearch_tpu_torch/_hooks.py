"""Seams between the reference's shared host code and the port.

The reference's host modules import two jax-only modules on the keyword
search path: `meilisearch_tpu.ops.arena_scorer` (jax at module level; its
numpy helpers are needed by `score_delta`, `_device_scores` and
`_finish_device_result`) and `meilisearch_tpu.ops.device_osa` (imported
before any gate by `search/query_terms.py`). Where jax is not installed,
`install_jaxfree_aliases` puts jax-free stand-ins under those names so the
shared code runs unchanged.

`block_jax` makes jax unimportable in the current process, so the same
stand-ins apply where jax is installed: the port's process entry points
(the server and `chip_smoke.py`) call it first, because the reference's
shared code would otherwise start a jax backend on the GPU beside torch.

`rebind_globals` shares a reference function by import while pointing one
or more of the module-level names it calls at the port's versions.
"""

from __future__ import annotations

import importlib.util
import sys
import types


_JAX_PACKAGES = ("jax", "jaxlib", "flax")


def block_jax() -> None:
    """Make jax, jaxlib and flax unimportable in this process (a None entry
    in sys.modules: `import` raises ImportError, `find_spec` answers None),
    then install the jax-free aliases. Raises if jax is already loaded."""
    loaded = [
        m for m, mod in sys.modules.items()
        if mod is not None and m.partition(".")[0] in _JAX_PACKAGES
    ]
    if loaded:
        raise RuntimeError(f"jax is already imported: {loaded[:3]}")
    for name in _JAX_PACKAGES:
        sys.modules[name] = None
    install_jaxfree_aliases()


def _jax_missing() -> bool:
    try:
        return importlib.util.find_spec("jax") is None
    except ImportError:  # a meta-path finder that refuses jax outright
        return True


def install_jaxfree_aliases() -> bool:
    """Alias the jax-free stand-ins under the reference's module names when
    jax cannot be imported. Returns whether the aliases are in place.
    Where jax exists (a test process running the reference beside the
    port) nothing changes: both packages share `sys.modules`."""
    if not _jax_missing():
        return False
    from .ops import arena_host, device_osa_stub

    sys.modules.setdefault("meilisearch_tpu.ops.arena_scorer", arena_host)
    sys.modules.setdefault("meilisearch_tpu.ops.device_osa", device_osa_stub)
    return True


def rebind_globals(fn: types.FunctionType, **names) -> types.FunctionType:
    """A copy of `fn` whose module-level lookups of `names` resolve to the
    given objects; every other global resolves as in `fn`'s own module.

    The copy's globals are a snapshot of that module's, taken when this is
    called: a later rebinding of a module global (a test's monkeypatch, a
    lazily assigned `global`) does not reach the copy.
    `tests/test_torch_hooks.py` pins every copy the port makes to its
    reference module."""
    scope = dict(fn.__globals__)
    scope.update(names)
    out = types.FunctionType(
        fn.__code__, scope, fn.__name__, fn.__defaults__, fn.__closure__
    )
    out.__kwdefaults__ = fn.__kwdefaults__
    out.__doc__ = fn.__doc__
    out.__qualname__ = fn.__qualname__
    out.__module__ = fn.__module__
    return out
