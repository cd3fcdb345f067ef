"""Document joins: `_foreign(..)` filter resolution and hit hydration.

Reference:
  crates/index-scheduler/src/filter.rs  (filters_into_index_filters —
      evaluate the inner condition on the foreign index, map internal ->
      external ids, rewrite as an IN condition on the source field,
      100-doc cap per foreign index)
  crates/meilisearch/src/search/hydration.rs (hydrate_documents —
      replace foreign-key field values with the foreign document's
      displayed fields; invalid ids warn and stay raw, unknown ids
      become `{}`)
  crates/meilisearch/tests/search/document_join.rs (pinned behaviors,
      ported in tests/golden/test_document_join_http.py)

Both run at the route layer — the only place other indexes are
reachable; the core search path stays single-index.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from ..types.errors import EngineError, ErrorCode
from .filters import And, Cond, Empty, Foreign, Not, Or, parse_filter

logger = logging.getLogger(__name__)

# reference filter.rs MAX_FOREIGN_FILTER_DOCIDS — bounds the rewritten
# IN list (and the full foreign-index scan the reference performs)
MAX_FOREIGN_FILTER_DOCIDS = 100

FOREIGN_KEYS_FEATURE_ERROR = (
    "requires enabling the `foreign_keys` experimental feature. See"
    " https://github.com/orgs/meilisearch/discussions/873"
)


def filter_may_join(filter_input) -> bool:
    """Cheap pre-scan: can this filter possibly contain `_foreign(`?
    Avoids parsing every filter twice on the hot path."""
    if isinstance(filter_input, str):
        return "_foreign" in filter_input
    if isinstance(filter_input, list):
        return any(filter_may_join(entry) for entry in filter_input)
    return False


def _walk_foreign(ast):
    if isinstance(ast, Foreign):
        yield ast
        yield from _walk_foreign(ast.inner)
    elif isinstance(ast, (And, Or)):
        for item in ast.items:
            yield from _walk_foreign(item)
    elif isinstance(ast, Not):
        yield from _walk_foreign(ast.inner)


def check_foreign_feature(scheduler, filter_input) -> Optional[Any]:
    """Parse `filter_input` and gate `_foreign` on the runtime feature.
    Returns the parsed AST when a Foreign node is present (so resolution
    can reuse it), None otherwise. Raises FEATURE_NOT_ENABLED with the
    reference's span-bearing message when the feature is off."""
    if not filter_may_join(filter_input):
        return None
    ast = parse_filter(filter_input)
    foreigns = list(_walk_foreign(ast))
    if not foreigns:
        return None
    if not scheduler.runtime_features.get("foreignKeys"):
        node = foreigns[0]
        msg = f"using a foreign filter {FOREIGN_KEYS_FEATURE_ERROR}"
        if node.field_span and node.context:
            s, e = node.field_span
            msg += f"\n{s}:{e} {node.context}"
        raise EngineError(ErrorCode.FEATURE_NOT_ENABLED, msg)
    return ast


def resolve_foreign_filters(scheduler, store, ast):
    """Rewrite every Foreign node in `ast` into an IN condition over the
    source field: evaluate the inner condition on the foreign index,
    map matching internal docids to external ids. The returned AST goes
    back into the query's `filter` slot (parse_filter passes pre-parsed
    nodes through)."""
    from .filters import FilterEvaluator

    foreign_keys = [
        fk for fk in store.settings.foreign_keys if isinstance(fk, dict)
    ]

    # running count per foreign index for the 100-doc cap (the reference
    # caps the UNION of all foreign filters against one index)
    fetched_per_index: dict[str, int] = {}

    def rewrite(node):
        if isinstance(node, Foreign):
            for nested in _walk_foreign(node.inner):
                raise EngineError(
                    ErrorCode.INVALID_SEARCH_FILTER,
                    f"Index `{store.uid}`: Nested foreign filters are not"
                    " supported",
                )
            fk = next(
                (
                    f
                    for f in foreign_keys
                    if f.get("fieldName") == node.field
                ),
                None,
            )
            if fk is None:
                raise EngineError(
                    ErrorCode.INVALID_SEARCH_FILTER,
                    f"Index `{store.uid}`: Field `{node.field}` is not a"
                    " foreign key",
                )
            foreign_uid = fk.get("foreignIndexUid")
            foreign_store = scheduler.index(foreign_uid)
            with foreign_store._lock:
                # inner-condition errors surface with the FOREIGN index's
                # uid and the reference's invalid_document_filter code
                # (filtered_universe path, document_join.rs
                # foreign_filter_propagates_inner_filter_error)
                docids = FilterEvaluator(
                    foreign_store, code=ErrorCode.INVALID_DOCUMENT_FILTER
                ).evaluate(node.inner)
                count = fetched_per_index.get(foreign_uid, 0) + len(docids)
                fetched_per_index[foreign_uid] = count
                if count > MAX_FOREIGN_FILTER_DOCIDS:
                    raise EngineError(
                        ErrorCode.INVALID_SEARCH_FILTER,
                        f"Index `{foreign_uid}`: Foreign filter is"
                        " retrieving too many documents, foreign filters"
                        " can't retrieve more than"
                        f" {MAX_FOREIGN_FILTER_DOCIDS} documents per index",
                    )
                els = [
                    foreign_store.internal_to_external[d]
                    for d in docids.tolist()
                    if d in foreign_store.internal_to_external
                ]
            rendered = '"{}" IN [{}]'.format(
                node.field, ", ".join(f'"{e}"' for e in els)
            )
            # span over the quoted field token in the rendered form
            # (document_join.rs foreign_filter_on_non_filterable_attribute
            # pins `2:8 "author" IN ["a1"]`)
            return Cond(
                node.field,
                "IN",
                els,
                span=(2, 2 + len(node.field)),
                ctx=rendered,
            )
        if isinstance(node, (And, Or)):
            return type(node)([rewrite(item) for item in node.items])
        if isinstance(node, Not):
            return Not(rewrite(node.inner))
        return node

    return rewrite(ast)


def apply_foreign_filter(scheduler, store, query: dict, qpos=None) -> None:
    """Route-layer entry: gate + resolve the query's filter in place.
    `qpos` (multi/federated search) prefixes the FEATURE gate error with
    `Inside `.queries[N]`: ` — resolution errors stay unprefixed, exactly
    like the reference (the gate runs per-query at parse time, resolution
    in the batched filters_into_index_filters; document_join.rs pins
    both shapes)."""
    try:
        ast = check_foreign_feature(scheduler, query.get("filter"))
    except EngineError as e:
        if qpos is not None and e.code == ErrorCode.FEATURE_NOT_ENABLED:
            raise EngineError(
                e.code, f"Inside `.queries[{qpos}]`: {e.message}"
            )
        raise
    if ast is not None:
        query["filter"] = resolve_foreign_filters(scheduler, store, ast)


# ---------------------------------------------------------------------------
# Hydration


def _select_displayed(doc: dict, displayed: list[str]) -> dict:
    from .perform import _select_fields

    return dict(_select_fields(doc, displayed))


class _Hydrator:
    """Per-foreign-index document maker (reference IndexDocumentMaker):
    external id -> displayed-fields document; unknown ids become `{}`,
    invalid ids warn and stay raw."""

    def __init__(self, scheduler, foreign_uid: str):
        self.store = scheduler.index(foreign_uid)
        self.cache: dict[str, Optional[dict]] = {}

    def make(self, value):
        from ..index.store import IndexStore

        try:
            external = IndexStore.validate_external_id(value)
        except EngineError:
            logger.warning(
                "Foreign key value %r is not a valid document id", value
            )
            return None  # keep the raw value
        if external in self.cache:
            return self.cache[external]
        with self.store._lock:
            docid = self.store.external_to_internal.get(external)
            if docid is None:
                logger.warning(
                    "Foreign key value %r does not match any document id",
                    external,
                )
                made: Optional[dict] = {}
            else:
                doc = self.store.documents.get(docid)
                made = (
                    _select_displayed(
                        doc, self.store.settings.displayed_attributes
                    )
                    if doc is not None
                    else {}
                )
        self.cache[external] = made
        return made


def _hydrate_value(obj, segments: list[str], hydrator: _Hydrator):
    """Walk `obj` along dotted-path `segments`; at the leaf replace id
    values (or each element of an id array) with the foreign document."""
    if isinstance(obj, list) and segments:
        for item in obj:
            _hydrate_value(item, segments, hydrator)
        return
    if not isinstance(obj, dict):
        return
    # try progressively longer joined keys (fields may contain dots)
    for n in range(1, len(segments) + 1):
        key = ".".join(segments[:n])
        if key not in obj:
            continue
        rest = segments[n:]
        if rest:
            _hydrate_value(obj[key], rest, hydrator)
            continue
        value = obj[key]
        if isinstance(value, list):
            out = []
            for v in value:
                made = hydrator.make(v)
                out.append(v if made is None else made)
            obj[key] = out
        else:
            made = hydrator.make(value)
            if made is not None:
                obj[key] = made
        return


def hydrate_hits(scheduler, store, hits: list[dict]) -> None:
    """Replace foreign-key field values in `hits` (and their
    `_formatted` views) with the foreign documents' displayed fields.
    Caller gates on the foreignKeys runtime feature (reference
    search/mod.rs:1921)."""
    foreign_keys = [
        fk for fk in store.settings.foreign_keys if isinstance(fk, dict)
    ]
    if not foreign_keys or not hits:
        return
    hydrators: dict[str, _Hydrator] = {}
    for fk in foreign_keys:
        uid, field = fk.get("foreignIndexUid"), fk.get("fieldName")
        if not uid or not field:
            continue
        try:
            hydrator = hydrators.get(uid) or _Hydrator(scheduler, uid)
        except EngineError:
            continue  # foreign index deleted since the setting was saved
        hydrators[uid] = hydrator
        segments = field.split(".")
        for hit in hits:
            _hydrate_value(hit, segments, hydrator)
            formatted = hit.get("_formatted")
            if isinstance(formatted, dict):
                _hydrate_value(formatted, segments, hydrator)


def hydrate_response(scheduler, store, response: dict) -> None:
    """Hydrate a search response's hits in place when the runtime
    feature is on and the index declares foreign keys."""
    if not scheduler.runtime_features.get("foreignKeys"):
        return
    if not store.settings.foreign_keys:
        return
    hits = response.get("hits")
    if isinstance(hits, list):
        hydrate_hits(scheduler, store, hits)
