"""Filter DSL: parser and evaluator.

Parser ports the reference grammar (crates/filter-parser/src/lib.rs:1-23 BNF):

  expression = or ; or = and ("OR" and)* ; and = not ("AND" not)*
  not = ("NOT" not) | primary
  primary = "(" expression ")" | geo | in | condition | exists | to | ...
  condition ops: = != > >= < <= TO, EXISTS, IS NULL, IS EMPTY, CONTAINS,
  STARTS WITH (and their NOT variants), IN [..],
  _geoRadius(lat, lng, m), _geoBoundingBox([a,b],[c,d]), _geoPolygon(...)

Evaluation ports milli's semantics
(crates/milli/src/search/facet/filter/value_bounds.rs + index_filter.rs):
  - every scalar comparison applies to BOTH the number interpretation (when
    the value parses as a finite float) and the normalized-string range
  - `!=` / NOT are complements against all documents of the index
  - `IS NULL` / `IS EMPTY` / `EXISTS` read the dedicated facet tables

On device, an evaluated filter is just a candidate bitmap intersected with
the universe before scoring.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..index.arrays import (
    EMPTY,
    ArrayCache,
    difference,
    docids_array as _docids_array,
    facet_arrays,
    intersect,
    to_array,
    union_many,
)
from ..index.store import IndexStore, facet_string_normalize
from ..types.errors import EngineError, ErrorCode

MAX_FILTER_DEPTH = 150


class FilterError(EngineError):
    def __init__(self, message: str, code=ErrorCode.INVALID_SEARCH_FILTER):
        super().__init__(code, message)


# ---------------------------------------------------------------------------
# AST


@dataclass
class Cond:
    field: str
    op: str  # '=', '!=', '>', '>=', '<', '<=', 'TO', 'EXISTS', 'NULL',
    # 'EMPTY', 'CONTAINS', 'STARTS WITH', 'IN'
    value: Any = None
    value2: Any = None
    # error-span carriage (reference filter-parser spans): 1-based
    # (start, end-exclusive) columns of the field token, plus the display
    # context string the span indexes into. Only set inside `_foreign(..)`
    # subtrees and on rewritten IN conditions, where the reference pins
    # span-bearing messages (parser.rs params_span.extra reset).
    span: Optional[tuple] = None
    ctx: Optional[str] = None


@dataclass
class Not:
    inner: Any


@dataclass
class And:
    items: list


@dataclass
class Or:
    items: list


@dataclass
class GeoRadius:
    lat: float
    lng: float
    radius_m: float


@dataclass
class GeoBoundingBox:
    top_right: tuple[float, float]
    bottom_left: tuple[float, float]


@dataclass
class GeoPolygon:
    points: list[tuple[float, float]]


@dataclass
class VectorExists:
    embedder: Optional[str]


@dataclass
class Foreign:
    """`_foreign(field, <condition>)` — a document-join filter: the inner
    condition evaluates against the foreign index named by the source
    index's `foreignKeys` setting for `field`, then maps back as an IN
    over external ids (reference filter-parser lib.rs:335 Foreign +
    index-scheduler/src/filter.rs filters_into_index_filters). Resolution
    happens at the route layer (search/join.py) where other indexes are
    reachable; an unresolved Foreign reaching evaluation means the
    endpoint does not support document joins."""

    field: str
    inner: Any
    field_span: Optional[tuple] = None  # 1-based (start, end-exclusive)
    context: Optional[str] = None  # display text from `_foreign` to EOI


class Empty:
    pass


# ---------------------------------------------------------------------------
# Lexer/parser (recursive descent)

def _is_value_char(c: str) -> bool:
    """filter-parser value.rs:253 is_value_component: UNICODE alphanumeric
    plus `_-.` — unquoted values like `pésti` parse without quotes."""
    return c.isalnum() or c in "_-."


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.depth = 0
        # inside `_foreign(..)`: the display context for span-bearing
        # errors (the reference resets the span's extra to the remainder
        # starting at `_foreign`, parser.rs parse_foreign)
        self.foreign_ctx: Optional[str] = None

    # -- low level -------------------------------------------------------

    def error(self, message: str):
        raise FilterError(f"{message}\n{self.pos}:{len(self.text)} {self.text}")

    def ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def peek_tag(self, tag: str) -> bool:
        self.ws()
        return self.text.startswith(tag, self.pos)

    def eat_tag(self, tag: str) -> bool:
        self.ws()
        if self.text.startswith(tag, self.pos):
            end = self.pos + len(tag)
            # keywords must be followed by non-word char
            if tag[-1].isalpha() and end < len(self.text) and _is_value_char(self.text[end]):
                return False
            self.pos = end
            return True
        return False

    def parse_value(self) -> str:
        self.ws()
        if self.pos >= len(self.text):
            self.error("Was expecting a value but instead got nothing.")
        ch = self.text[self.pos]
        if ch in "'\"":
            quote = ch
            self.pos += 1
            out = []
            while self.pos < len(self.text):
                c = self.text[self.pos]
                if c == "\\" and self.pos + 1 < len(self.text) and self.text[
                    self.pos + 1
                ] in ("\\", quote):
                    out.append(self.text[self.pos + 1])
                    self.pos += 2
                    continue
                if c == quote:
                    self.pos += 1
                    return "".join(out)
                out.append(c)
                self.pos += 1
            self.error(f"Expression `{''.join(out)}` is missing the following closing delimiter: `{quote}`.")
        # word
        start = self.pos
        while self.pos < len(self.text) and _is_value_char(self.text[self.pos]):
            self.pos += 1
        if self.pos == start:
            self.error(
                f"Was expecting a value but instead got `{self.text[self.pos:]}`."
            )
        word = self.text[start : self.pos]
        if word in ("AND", "OR", "IN", "NOT", "TO", "EXISTS", "IS", "EMPTY", "NULL",
                    "CONTAINS", "STARTS", "WITH"):
            self.error(
                f"Was expecting a value but instead got `{word}`, which is a reserved"
                " keyword. To use `{0}` as a field name or a value, surround it by"
                " quotes.".replace("{0}", word)
            )
        if word.startswith("_geoPoint"):
            self.error(
                "`_geoPoint` is a reserved keyword and thus can't be used as a"
                " filter expression. Use the `_geoRadius(latitude, longitude,"
                " distance)` or `_geoBoundingBox([latitude, longitude],"
                " [latitude, longitude])` built-in rules to filter on `_geo`"
                " coordinates."
            )
        return word

    def parse_float(self) -> float:
        v = self.parse_value()
        try:
            return float(v)
        except ValueError:
            self.error(f"Expected a float but instead got `{v}`.")

    # -- grammar -----------------------------------------------------------

    def parse(self):
        self.ws()
        if not self.text.strip():
            return Empty()
        expr = self.parse_or()
        self.ws()
        if self.pos != len(self.text):
            self.error(
                f"Found unexpected characters at the end of the filter:"
                f" `{self.text[self.pos:]}`. You probably forgot an `OR` or an"
                " `AND` rule."
            )
        return expr

    def parse_or(self):
        items = [self.parse_and()]
        while self.eat_tag("OR"):
            items.append(self.parse_and())
        return items[0] if len(items) == 1 else Or(items)

    def parse_and(self):
        items = [self.parse_not()]
        while self.eat_tag("AND"):
            items.append(self.parse_not())
        return items[0] if len(items) == 1 else And(items)

    def parse_not(self):
        if self.eat_tag("NOT"):
            return Not(self.parse_not())
        return self.parse_primary()

    def parse_primary(self):
        self.depth += 1
        if self.depth > MAX_FILTER_DEPTH:
            self.error("The filter exceeded the maximum depth limit.")
        try:
            self.ws()
            if self.eat_tag("("):
                expr = self.parse_or()
                self.ws()
                if not self.eat_tag(")"):
                    self.error("Expression is missing the following closing delimiter: `)`.")
                return expr
            if self.eat_tag("_geoRadius("):
                lat = self.parse_float()
                self._comma()
                lng = self.parse_float()
                self._comma()
                radius = self.parse_float()
                self.ws()
                if self.eat_tag(","):  # optional resolution arg
                    self.parse_value()
                    self.ws()
                if not self.eat_tag(")"):
                    self.error("The `_geoRadius` filter expects three arguments: `_geoRadius(latitude, longitude, radius)`.")
                return GeoRadius(lat, lng, radius)
            if self.eat_tag("_geoBoundingBox("):
                tr = self._point()
                self._comma()
                bl = self._point()
                self.ws()
                if not self.eat_tag(")"):
                    self.error("The `_geoBoundingBox` filter expects two pairs of arguments: `_geoBoundingBox([latitude, longitude], [latitude, longitude])`.")
                return GeoBoundingBox(tr, bl)
            if self.eat_tag("_geoPolygon("):
                points = []
                while True:
                    self.ws()
                    if self.peek_tag("["):
                        points.append(self._point())
                        self.ws()
                        self.eat_tag(",")
                    else:
                        break
                if not self.eat_tag(")"):
                    self.error("The `_geoPolygon` filter expects a list of points: `_geoPolygon([lat, lng], ...)`.")
                if len(points) < 3:
                    self.error("The `_geoPolygon` filter expects at least three points.")
                return GeoPolygon(points)
            if self.peek_tag("_foreign"):
                node = self.parse_foreign()
                if node is not None:
                    return node
            if self.peek_tag("_geoDistance") or self.peek_tag("_geo ") or self.peek_tag("_geo="):
                self.error(
                    "`_geo` is a reserved keyword and thus can't be used as a"
                    " filter expression. Use the `_geoRadius(latitude, longitude,"
                    " distance)` or `_geoBoundingBox([latitude, longitude],"
                    " [latitude, longitude])` built-in rules to filter on `_geo`"
                    " coordinates."
                )
            return self.parse_condition()
        finally:
            self.depth -= 1

    def parse_foreign(self):
        """`_foreign(field, <or-expr>)`. Returns None when `_foreign` is a
        plain field name (keyword boundary: `_foreignkey = 1` is a normal
        condition). Once `_foreign(` is committed the rest MUST parse
        (reference parse_foreign map_cut ErrorKind::Foreign)."""
        self.ws()
        start = self.pos
        if not self.eat_tag("_foreign"):
            return None
        self.ws()
        if not self.peek_tag("("):
            self.pos = start  # a field literally named `_foreign`
            return None
        outer_ctx = self.foreign_ctx
        self.foreign_ctx = self.text[start:]
        try:
            self.eat_tag("(")

            def fail():
                raise FilterError(
                    "Was expecting a field name and an condition inside"
                    " `_foreign(..)` filter but instead found"
                    f" `{self.text[self.pos:]}`.\n"
                    f"{self.pos + 1}:{len(self.text) + 1} {self.foreign_ctx}"
                )

            self.ws()
            fstart = self.pos
            try:
                field = self.parse_value()
            except FilterError:
                fail()
            fend = self.pos
            self.ws()
            if not self.eat_tag(","):
                fail()
            inner = self.parse_or()
            self.ws()
            if not self.eat_tag(")"):
                fail()
            return Foreign(
                field, inner, (fstart + 1, fend + 1), self.foreign_ctx
            )
        finally:
            self.foreign_ctx = outer_ctx

    def _comma(self):
        self.ws()
        if not self.eat_tag(","):
            self.error("Expected a comma.")

    def _point(self):
        self.ws()
        if not self.eat_tag("["):
            self.error("Expected `[`.")
        lat = self.parse_float()
        self._comma()
        lng = self.parse_float()
        self.ws()
        if not self.eat_tag("]"):
            self.error("Expected `]`.")
        return (lat, lng)

    def parse_condition(self):
        self.ws()
        fstart = self.pos
        field = self.parse_value()
        fend = self.pos
        node = self._parse_condition_body(field)
        if self.foreign_ctx is not None:
            # inside `_foreign(..)`: conditions carry the field token span
            # so evaluation errors on the FOREIGN index render the
            # reference's span line (document_join.rs inner-filter error)
            tgt = node.inner if isinstance(node, Not) else node
            if isinstance(tgt, Cond) and tgt.span is None:
                tgt.span = (fstart + 1, fend + 1)
                tgt.ctx = self.foreign_ctx
        return node

    def _parse_condition_body(self, field):
        self.ws()

        if field == "_vectors" or field.startswith("_vectors."):
            embedder = field[len("_vectors.") :] if "." in field else None
            if embedder and "." in embedder:
                embedder = embedder.split(".")[0]
            if self.eat_tag("NOT"):
                if not self.eat_tag("EXISTS"):
                    self.error("Expected `EXISTS` after `NOT`.")
                return Not(VectorExists(embedder))
            if self.eat_tag("EXISTS"):
                return VectorExists(embedder)
            self.error("The `_vectors` field can only be filtered with `EXISTS`.")

        for op in ("<=", ">=", "!=", "=", "<", ">"):
            if self.eat_tag(op):
                value = self.parse_value()
                return Cond(field, op, value)
        if self.eat_tag("IN"):
            self.ws()
            if not self.eat_tag("["):
                self.error("Expected `[` after `IN` keyword.")
            values = []
            while True:
                self.ws()
                if self.eat_tag("]"):
                    break
                values.append(self.parse_value())
                self.ws()
                if self.eat_tag(","):
                    continue
                if self.eat_tag("]"):
                    break
                self.error("Expected `,` or `]` in the value list.")
            return Cond(field, "IN", values)
        if self.eat_tag("NOT"):
            if self.eat_tag("EXISTS"):
                return Not(Cond(field, "EXISTS"))
            if self.eat_tag("IN"):
                self.pos -= 2
                cond = self.parse_condition_after_not_in(field)
                return cond
            if self.eat_tag("CONTAINS"):
                return Not(Cond(field, "CONTAINS", self.parse_value()))
            if self.eat_tag("STARTS"):
                if not self.eat_tag("WITH"):
                    self.error("Expected `WITH` after `STARTS`.")
                return Not(Cond(field, "STARTS WITH", self.parse_value()))
            self.error("Expected `EXISTS`, `IN`, `CONTAINS` or `STARTS WITH` after `NOT`.")
        if self.eat_tag("EXISTS"):
            return Cond(field, "EXISTS")
        if self.eat_tag("IS"):
            negate = self.eat_tag("NOT")
            if self.eat_tag("NULL"):
                c = Cond(field, "NULL")
            elif self.eat_tag("EMPTY"):
                c = Cond(field, "EMPTY")
            else:
                self.error("Expected `NULL` or `EMPTY` after `IS`.")
            return Not(c) if negate else c
        if self.eat_tag("CONTAINS"):
            return Cond(field, "CONTAINS", self.parse_value())
        if self.eat_tag("STARTS"):
            if not self.eat_tag("WITH"):
                self.error("Expected `WITH` after `STARTS`.")
            return Cond(field, "STARTS WITH", self.parse_value())
        # `value value TO value`
        save = self.pos
        try:
            low = self.parse_value()
        except FilterError:
            low = None
        if low is not None and self.eat_tag("TO"):
            high = self.parse_value()
            return Cond(field, "TO", low, high)
        self.pos = save
        self.error(
            f"Was expecting an operation `=`, `!=`, `>=`, `>`, `<=`, `<`, `IN`,"
            f" `NOT IN`, `TO`, `EXISTS`, `NOT EXISTS`, `IS NULL`, `IS NOT NULL`,"
            f" `IS EMPTY`, `IS NOT EMPTY`, `CONTAINS`, `NOT CONTAINS`,"
            f" `STARTS WITH`, `NOT STARTS WITH` at `{self.text[self.pos:]}`."
        )

    def parse_condition_after_not_in(self, field):
        self.eat_tag("IN")
        self.ws()
        if not self.eat_tag("["):
            self.error("Expected `[` after `IN` keyword.")
        values = []
        while True:
            self.ws()
            if self.eat_tag("]"):
                break
            values.append(self.parse_value())
            self.ws()
            if self.eat_tag(","):
                continue
            if self.eat_tag("]"):
                break
            self.error("Expected `,` or `]` in the value list.")
        return Not(Cond(field, "IN", values))


_AST_NODES = (
    Cond, Not, And, Or, GeoRadius, GeoBoundingBox, GeoPolygon,
    VectorExists, Foreign, Empty,
)


def parse_filter(filter_input) -> Any:
    """Parse a filter — either the string DSL or the array form
    (["a = b", ["c = d", "e = f"]] meaning AND of ORs). A pre-parsed AST
    passes through unchanged (the route layer rewrites `_foreign(..)`
    subtrees into IN conditions before perform_search re-parses)."""
    if filter_input is None:
        return None
    if isinstance(filter_input, _AST_NODES):
        return filter_input
    if isinstance(filter_input, str):
        return _Parser(filter_input).parse()
    if isinstance(filter_input, list):
        items = []
        for entry in filter_input:
            if isinstance(entry, str):
                items.append(_Parser(entry).parse())
            elif isinstance(entry, list):
                ors = [_Parser(e).parse() for e in entry if isinstance(e, str)]
                if len(ors) == 1:
                    items.append(ors[0])
                elif ors:
                    items.append(Or(ors))
            else:
                raise FilterError("Invalid syntax for the filter parameter.")
        items = [i for i in items if not isinstance(i, Empty)]
        if not items:
            return Empty()
        return items[0] if len(items) == 1 else And(items)
    import json as _json

    raise FilterError(
        "Invalid syntax for the filter parameter: `expected String, Array,"
        f" found: {_json.dumps(filter_input, separators=(',', ':'))}`."
    )


# ---------------------------------------------------------------------------
# Evaluation


def _parse_finite_float(value: str) -> Optional[float]:
    try:
        f = float(value)
        if math.isfinite(f):
            return f
    except (ValueError, TypeError):
        pass
    return None


class FilterEvaluator:
    """Evaluates a parsed filter into a docid set over one index."""

    def __init__(self, store: IndexStore, code=ErrorCode.INVALID_SEARCH_FILTER):
        self.store = store
        self.code = code

    def _fid(self, field: str) -> Optional[int]:
        return self.store.fields_ids_map.id(field)

    def _check_filterable(self, field: str, op: str, span_ctx=None):
        settings = self.store.settings
        feats = settings.filter_features_for(field)
        if not feats:
            attrs = sorted(set(settings.filter_enabled_patterns()))
            if attrs:
                msg = (
                    f"Index `{self.store.uid}`: Attribute `{field}` is not"
                    f" filterable. Available filterable attribute patterns are:"
                    f" `{', '.join(attrs)}`."
                )
            else:
                msg = (
                    f"Index `{self.store.uid}`: Attribute `{field}` is not"
                    " filterable. This index does not have configured filterable"
                    " attributes."
                )
            if span_ctx is not None:
                # conditions from `_foreign(..)` subtrees (or rewritten IN
                # conditions) carry the reference's span line
                (s, e), ctx = span_ctx
                msg += f"\n{s}:{e} {ctx}"
            raise EngineError(self.code, msg)
        if op in (">", ">=", "<", "<=", "TO") and not feats["filter"].get(
            "comparison", True
        ):
            self._op_not_allowed(field, op, feats)
        if op in ("=", "!=", "IN") and not feats["filter"].get("equality", True):
            self._op_not_allowed(field, op, feats)

    def _op_not_allowed(self, field: str, op: str, feats: dict):
        """milli error.rs FilterOperatorNotAllowed: the allowed-operator
        list reflects the matched rule's remaining features
        (filterable_attributes_rules.rs allowed_operators), plus the
        rule-index notes and enable/prepend hints."""
        ops = ["OR", "AND", "NOT"]
        if feats["filter"].get("equality", True):
            ops += ["=", "!=", "IN"]
        if feats["filter"].get("comparison", True):
            ops += ["<", ">", "<=", ">=", "TO"]
        ops += ["IS EMPTY", "IS NULL", "EXISTS"]
        kind = (
            "equality"
            if op in ("=", "!=", "IN")
            else "comparison"
            if op in ("<", ">", "<=", ">=", "TO")
            else "the appropriate filter operators"
        )
        ri = feats.get("rule_index", 0)
        raise EngineError(
            self.code,
            f"Index `{self.store.uid}`: Filter operator `{op}` is not"
            f" allowed for the attribute `{field}`."
            f"\n  - Note: allowed operators: {', '.join(ops)}."
            f"\n  - Note: field `{field}` matched rule #{ri} in"
            " `filterableAttributes`"
            f"\n  - Hint: enable {kind} in rule #{ri} by modifying the"
            " features.filter object"
            f"\n  - Hint: prepend another rule matching `{field}` with"
            f" appropriate filter features before rule #{ri}",
        )

    def evaluate(self, ast) -> "np.ndarray":
        """Returns the matching docids as a sorted int64 array."""
        all_docs = _docids_array(self.store)
        return self._eval(ast, all_docs)

    def _eval(self, ast, all_docs) -> "np.ndarray":
        store = self.store
        if ast is None or isinstance(ast, Empty):
            return all_docs
        if isinstance(ast, Or):
            return union_many([self._eval(item, all_docs) for item in ast.items])
        if isinstance(ast, And):
            out = all_docs
            for item in ast.items:
                out = intersect(out, self._eval(item, all_docs))
                if not len(out):
                    return out
            return out
        if isinstance(ast, Not):
            return difference(all_docs, self._eval(ast.inner, all_docs))
        if isinstance(ast, GeoRadius):
            # union of `_geo` point matches and `_geojson` shape matches
            # (reference index_filter.rs:495-530)
            geo_on, geojson_on = self._geo_features()
            out = set()
            if geo_on:
                for docid, (lat, lng) in store.geo_points.items():
                    if _haversine_m(ast.lat, ast.lng, lat, lng) <= ast.radius_m:
                        out.add(docid)
            if geojson_on:
                from ..index.geojson import shape_in_circle

                for docid, shapes in store.geojson_shapes.items():
                    if shape_in_circle(shapes, ast.lat, ast.lng, ast.radius_m):
                        out.add(docid)
            return to_array(out)
        if isinstance(ast, GeoBoundingBox):
            geo_on, geojson_on = self._geo_features()
            (tr_lat, tr_lng) = ast.top_right
            (bl_lat, bl_lng) = ast.bottom_left
            out = set()
            if geo_on:
                for docid, (lat, lng) in store.geo_points.items():
                    if not (bl_lat <= lat <= tr_lat):
                        continue
                    if bl_lng <= tr_lng:
                        if bl_lng <= lng <= tr_lng:
                            out.add(docid)
                    else:  # wrap around the antimeridian
                        if lng >= bl_lng or lng <= tr_lng:
                            out.add(docid)
            if geojson_on:
                from ..index.geojson import shape_in_box

                for docid, shapes in store.geojson_shapes.items():
                    if shape_in_box(shapes, ast.top_right, ast.bottom_left):
                        out.add(docid)
            return to_array(out)
        if isinstance(ast, GeoPolygon):
            # shapes only: requires `_geojson` filtering
            # (reference index_filter.rs:697-715)
            if not store.settings.is_filterable("_geojson"):
                attrs = sorted(set(store.settings.filter_enabled_patterns()))
                raise EngineError(
                    self.code,
                    f"Index `{store.uid}`: Attribute `_geojson` is not"
                    " filterable. Available filterable attribute patterns"
                    f" are: `{', '.join(attrs) or ''}`.",
                )
            from ..index.geojson import shape_in_polygon

            out = set()
            for docid, shapes in store.geojson_shapes.items():
                if shape_in_polygon(shapes, ast.points):
                    out.add(docid)
            return to_array(out)
        if isinstance(ast, VectorExists):
            out = set()
            if ast.embedder is None:
                for emb in store.vectors:
                    out |= set(store.vectors[emb].keys())
            else:
                out |= set(store.vectors.get(ast.embedder, {}).keys())
            return to_array(out)
        if isinstance(ast, Cond):
            return self._eval_cond(ast, all_docs)
        if isinstance(ast, Foreign):
            # document-join filters resolve at the route layer
            # (search/join.py); an unresolved node means this endpoint
            # does not support them (reference filter.rs
            # unsupported_foreign_filter_error)
            raise EngineError(
                self.code,
                "Filter condition `_foreign` is not supported for this"
                " endpoint.",
            )
        raise AssertionError(ast)

    def _eval_shard(self, cond: Cond, all_docs) -> "np.ndarray":
        """`_shard = name`, `_shard != name`, `_shard IN [..]` against the
        store's rendezvous ownership sets. Without a topology every shard
        set is empty (= matches nothing; != matches everything)."""
        store = self.store
        op = cond.op
        if op == "=":
            return intersect(all_docs, to_array(store.shard_docids(cond.value)))
        if op == "!=":
            return difference(
                all_docs, to_array(store.shard_docids(cond.value))
            )
        if op == "IN":
            return intersect(
                all_docs,
                union_many(
                    [to_array(store.shard_docids(v)) for v in cond.value]
                ),
            )
        raise EngineError(
            self.code,
            f"Index `{store.uid}`: Filter operator `{op}` is not allowed for"
            " the attribute `_shard`.",
        )

    def _check_geo(self):
        if not self.store.settings.is_filterable("_geo"):
            raise EngineError(
                self.code,
                f"Index `{self.store.uid}`: Attribute `_geo` is not filterable."
                " Available filterable attribute patterns are:"
                f" `{', '.join(sorted(set(self.store.settings.filter_enabled_patterns()))) or ''}`.",
            )

    def _geo_features(self) -> tuple[bool, bool]:
        """(points filterable, shapes filterable); raises when neither
        (reference error attribute `_geo/_geojson`)."""
        settings = self.store.settings
        geo_on = settings.is_filterable("_geo")
        geojson_on = settings.is_filterable("_geojson")
        if not geo_on and not geojson_on:
            attrs = sorted(set(settings.filter_enabled_patterns()))
            raise EngineError(
                self.code,
                f"Index `{self.store.uid}`: Attribute `_geo/_geojson` is not"
                " filterable. Available filterable attribute patterns are:"
                f" `{', '.join(attrs) or ''}`.",
            )
        return geo_on, geojson_on

    def _eval_cond(self, cond: Cond, all_docs) -> "np.ndarray":
        store = self.store
        if cond.field == "_shard":
            # implicitly filterable, resolved against the rendezvous shard
            # ownership sets (reference: index_filter.rs:254
            # evaluate_shard_operator; SHARD_FIELD bypasses the
            # filterable-attribute check at :57)
            return self._eval_shard(cond, all_docs)
        self._check_filterable(
            cond.field,
            cond.op,
            span_ctx=(cond.span, cond.ctx) if cond.span is not None else None,
        )
        fid = self._fid(cond.field)
        if fid is None:
            return EMPTY
        idx = facet_arrays(store, fid)
        cache = ArrayCache(store)

        def equal_docids(value: str) -> "np.ndarray":
            parts = [idx.string_eq(facet_string_normalize(value))]
            number = _parse_finite_float(value)
            if number is not None:
                parts.append(idx.number_eq(number))
            return union_many(parts)

        op = cond.op
        if op == "=":
            return equal_docids(cond.value)
        if op == "!=":
            return difference(all_docs, equal_docids(cond.value))
        if op == "IN":
            return union_many([equal_docids(v) for v in cond.value])
        if op == "EXISTS":
            return cache.get(
                ("fx", fid), store.facet_exists_docids.get(fid, set())
            )
        if op == "NULL":
            return cache.get(
                ("fnl", fid), store.facet_is_null_docids.get(fid, set())
            )
        if op == "EMPTY":
            return cache.get(
                ("fe", fid), store.facet_is_empty_docids.get(fid, set())
            )
        if op == "CONTAINS":
            norm = facet_string_normalize(cond.value)
            return union_many(
                [
                    arr
                    for s, arr in zip(idx.str_values, idx.str_arrays)
                    if norm in s
                ]
            )
        if op == "STARTS WITH":
            norm = facet_string_normalize(cond.value)
            return idx.string_prefix(norm)
        # range operators: both number range and normalized string range
        # (reference value_bounds.rs — string comparison always applies,
        # number comparison only when the value parses as a finite float)
        if op == "TO":
            lo_n, hi_n = _parse_finite_float(cond.value), _parse_finite_float(cond.value2)
            lo_s, hi_s = facet_string_normalize(cond.value), facet_string_normalize(cond.value2)
            parts = [idx.string_range(lo_s, hi_s)]
            if lo_n is not None and hi_n is not None:
                parts.append(idx.number_range(lo_n, hi_n))
            return union_many(parts)

        value = cond.value
        number = _parse_finite_float(value)
        norm = facet_string_normalize(value)
        parts = []
        if number is not None:
            if op == ">":
                parts.append(idx.number_range(number, None, lo_strict=True))
            elif op == ">=":
                parts.append(idx.number_range(number, None))
            elif op == "<":
                parts.append(idx.number_range(None, number, hi_strict=True))
            elif op == "<=":
                parts.append(idx.number_range(None, number))
        if op == ">":
            parts.append(idx.string_range(norm, None, lo_strict=True))
        elif op == ">=":
            parts.append(idx.string_range(norm, None))
        elif op == "<":
            parts.append(idx.string_range(None, norm, hi_strict=True))
        elif op == "<=":
            parts.append(idx.string_range(None, norm))
        return union_many(parts)


_FILTER_CACHE_CAP = 256


def evaluate_filter(
    store: IndexStore,
    filter_input,
    code=ErrorCode.INVALID_SEARCH_FILTER,
    as_array: bool = False,
):
    """Evaluates a filter to matching docids: a set by default (the mutation
    and task paths iterate/discard), or the evaluator's native sorted array
    with `as_array=True` (the query path).

    Query-path results are cached per (generation, filter) in a bounded
    LRU — the standard production-search filter cache (Lucene/ES ship the
    same): a hot filter like `points > 1000` unions thousands of facet
    value arrays at 1M docs (~10-30 ms), and repeated filters are the
    norm in real traffic. The arrays are immutable per generation, so a
    hit is safe to share."""
    ast = parse_filter(filter_input)
    if ast is None:
        return None
    if not as_array:
        return set(FilterEvaluator(store, code).evaluate(ast).tolist())

    try:
        key = repr(filter_input)
    except Exception:
        key = None
    cache = getattr(store, "_filter_result_cache", None)
    if cache is None or cache[0] != store.generation:
        from collections import OrderedDict

        cache = (store.generation, OrderedDict())
        store._filter_result_cache = cache
    lru = cache[1]
    if key is not None and key in lru:
        lru.move_to_end(key)
        return lru[key]
    arr = FilterEvaluator(store, code).evaluate(ast)
    if key is not None:
        lru[key] = arr
        if len(lru) > _FILTER_CACHE_CAP:
            lru.popitem(last=False)
    return arr


def _haversine_m(lat1, lng1, lat2, lng2) -> float:
    r = 6371000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lng2 - lng1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))


def _point_in_polygon(lat, lng, points) -> bool:
    inside = False
    n = len(points)
    for i in range(n):
        la1, lo1 = points[i]
        la2, lo2 = points[(i + 1) % n]
        if (lo1 > lng) != (lo2 > lng):
            t = (lng - lo1) / (lo2 - lo1)
            if lat < la1 + t * (la2 - la1):
                inside = not inside
    return inside
