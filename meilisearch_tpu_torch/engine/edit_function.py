"""Edit documents by function.

Reference: milli/src/update/new/indexer/update_by_function.rs — a restricted
script runs against each matching document with `doc` in scope; assigning to
`doc` fields edits the document, setting `doc` to an empty state removes it.

The reference embeds rhai, which is host-isolated by construction. Python
`exec` with a restricted `__builtins__` dict is NOT isolation on its own
(`().__class__.__mro__[1].__subclasses__()` walks back to os/subprocess), so
the function source is validated structurally before it ever compiles:

  * no import statements,
  * no attribute access to names starting with `_` (closes the
    `__class__`/`__mro__`/`__subclasses__`/`__globals__` ladder),
  * no access to frame/generator/coroutine introspection attributes
    (`gi_frame`, `f_globals`, …) that reach builtins without a dunder,
  * no `__`-prefixed bare names (`__builtins__`, `__import__`, …),
  * no `global`/`nonlocal`.

Execution additionally runs under a per-document trace-based operation
budget so a looping script cannot wedge the scheduler thread (the rhai
analogue of an operations limit). The feature stays behind the
`editDocumentsByFunction` experimental flag.
"""

from __future__ import annotations

import ast
import sys
from typing import Optional

from ..types.errors import EngineError, ErrorCode

# non-dunder attributes that reach frames / code objects / builtins
_BLOCKED_ATTRS = frozenset(
    {
        "gi_frame", "gi_code", "gi_yieldfrom",
        "cr_frame", "cr_code", "cr_await", "cr_origin",
        "ag_frame", "ag_code", "ag_await",
        "f_globals", "f_locals", "f_builtins", "f_back", "f_code",
        "tb_frame", "tb_next",
        "co_consts", "co_names",
        "format_map",  # str.format_map({...}) can smuggle a mapping proxy
    }
)

_MAX_OPS_PER_DOC = 1_000_000


def _validate_function_source(tree: ast.AST) -> None:
    """Reject constructs that escape the restricted scope (see module doc)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Error in `function`: import statements are not allowed.",
            )
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Error in `function`: global/nonlocal are not allowed.",
            )
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("_") or node.attr in _BLOCKED_ATTRS:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Error in `function`: access to attribute"
                    f" `{node.attr}` is not allowed.",
                )
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Error in `function`: access to name `{node.id}` is not"
                " allowed.",
            )


def _exec_budgeted(code, scope: dict) -> None:
    """Run `code` under a line-event budget on the current thread."""
    count = 0

    def tracer(frame, event, arg):
        nonlocal count
        count += 1
        if count > _MAX_OPS_PER_DOC:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Error in `function`: operation budget exceeded.",
            )
        return tracer

    old = sys.gettrace()
    sys.settrace(tracer)
    try:
        exec(code, scope)  # noqa: S102 — AST-validated + budgeted, see module doc
    finally:
        sys.settrace(old)


class _DocProxy(dict):
    """Attribute-style access so `doc.title = ...` works like rhai."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            return None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        self.pop(name, None)


_SAFE_BUILTINS = {
    "len": len,
    "str": str,
    "int": int,
    "float": float,
    "abs": abs,
    "min": min,
    "max": max,
    "round": round,
    "sorted": sorted,
}


def edit_documents_by_function(
    store, function: str, filter_expr, context: Optional[dict]
) -> tuple[int, int]:
    if not isinstance(function, str) or not function.strip():
        raise EngineError(
            ErrorCode.BAD_REQUEST, "Missing field `function`"
        )
    try:
        tree = ast.parse(function, "<edit-function>", "exec")
    except SyntaxError as err:
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Error in `function`: {err}",
        )
    _validate_function_source(tree)
    code = compile(tree, "<edit-function>", "exec")

    docids = sorted(store.documents.keys())
    if filter_expr is not None:
        from ..search.filters import evaluate_filter

        allowed = evaluate_filter(
            store, filter_expr, code=ErrorCode.INVALID_DOCUMENT_FILTER
        )
        docids = [d for d in docids if d in allowed]

    edited = 0
    to_update: list[dict] = []
    to_delete: list[str] = []
    for docid in docids:
        original = store.documents[docid]
        doc = _DocProxy({k: v for k, v in original.items()})
        scope = {
            "__builtins__": _SAFE_BUILTINS,
            "doc": doc,
            "context": context or {},
        }
        try:
            _exec_budgeted(code, scope)
        except EngineError:
            raise
        except Exception as err:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Error while running the function on document"
                f" `{store.internal_to_external.get(docid)}`: {err}",
            )
        new_doc = scope.get("doc")
        if not new_doc:
            to_delete.append(store.internal_to_external[docid])
            edited += 1
        elif dict(new_doc) != original:
            to_update.append(dict(new_doc))
            edited += 1
    if to_update:
        store.add_documents(to_update, method="replace")
    if to_delete:
        store.delete_documents(to_delete)
    return edited, len(docids)
