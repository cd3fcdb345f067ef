"""Per-index settings model.

Mirrors the reference settings DTO
(the Meilisearch source, crates/meilisearch-types/src/settings.rs:223-435) and milli's
stored settings (index `main` DB keys, milli/src/index.rs:49-95).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

# Reference: milli/src/prompt/mod.rs default document template.
DEFAULT_DOCUMENT_TEMPLATE = (
    "{% for field in fields %}"
    "{% if field.is_searchable and field.value != nil %}"
    "{{ field.name }}: {{ field.value }}\n"
    "{% endif %}{% endfor %}"
)

# Reference: meilisearch-types/src/features.rs ChatCompletionSettings default
# (the /settings/chat sub-route default payload).
DEFAULT_CHAT_SETTINGS = {
    "description": "",
    "documentTemplate": DEFAULT_DOCUMENT_TEMPLATE,
    "documentTemplateMaxBytes": 400,
    "searchParameters": {},
}


def hide_secret(secret: str, offset: int = 0) -> str:
    """Mask an API key for display (reference:
    meilisearch-types/src/settings.rs:459 hide_secret): the number of leading
    characters kept scales with the secret's length."""
    if not isinstance(secret, str):
        return secret
    n = len(secret) - offset
    if n < 0:
        return secret
    if n < 10:
        return secret[:offset] + "XXX..."
    if n < 20:
        return secret[: offset + 2] + "XXXX..."
    if n < 30:
        return secret[: offset + 3] + "XXXXX..."
    return secret[: offset + 5] + "XXXXXX..."


def masked_embedders(embedders: dict) -> dict:
    """Copy of an embedders settings map with apiKey secrets hidden
    (reference: settings.rs:439 hide_secrets)."""
    out = {}
    for name, conf in (embedders or {}).items():
        if isinstance(conf, dict) and isinstance(conf.get("apiKey"), str):
            conf = {**conf, "apiKey": hide_secret(conf["apiKey"])}
        out[name] = conf
    return out


def embedders_api_view(embedders: dict) -> dict:
    """The embedders map as the settings routes render it: secrets hidden
    and per-source defaults materialized (reference: the stored
    EmbeddingSettings serialization, settings.rs + vector/settings.rs)."""
    out = {}
    for name, conf in masked_embedders(embedders).items():
        if isinstance(conf, dict) and conf.get("source") != "userProvided":
            conf = dict(conf)
            conf.setdefault("documentTemplate", DEFAULT_DOCUMENT_TEMPLATE)
            conf.setdefault("documentTemplateMaxBytes", 400)
            if conf.get("source") == "rest":
                conf.setdefault("headers", {})
        out[name] = conf
    return out


DEFAULT_RANKING_RULES = [
    # Reference: milli/src/criterion.rs:121 default_criteria()
    "words",
    "typo",
    "proximity",
    "attributeRank",
    "sort",
    "wordPosition",
    "exactness",
]


@dataclass
class MinWordSizeForTypos:
    # Reference: milli/src/index.rs:46-47 (DEFAULT_MIN_WORD_LEN_ONE_TYPO = 5,
    # DEFAULT_MIN_WORD_LEN_TWO_TYPOS = 9)
    one_typo: int = 5
    two_typos: int = 9

    def to_json(self) -> dict:
        return {"oneTypo": self.one_typo, "twoTypos": self.two_typos}


@dataclass
class TypoTolerance:
    enabled: bool = True
    min_word_size_for_typos: MinWordSizeForTypos = field(default_factory=MinWordSizeForTypos)
    disable_on_words: list[str] = field(default_factory=list)
    disable_on_attributes: list[str] = field(default_factory=list)
    disable_on_numbers: bool = False

    def to_json(self) -> dict:
        return {
            "enabled": self.enabled,
            "minWordSizeForTypos": self.min_word_size_for_typos.to_json(),
            "disableOnWords": sorted(self.disable_on_words),
            "disableOnAttributes": sorted(self.disable_on_attributes),
            "disableOnNumbers": self.disable_on_numbers,
        }


@dataclass
class Pagination:
    max_total_hits: int = 1000

    def to_json(self) -> dict:
        return {"maxTotalHits": self.max_total_hits}


@dataclass
class Faceting:
    max_values_per_facet: int = 100
    sort_facet_values_by: dict[str, str] = field(default_factory=lambda: {"*": "alpha"})

    def to_json(self) -> dict:
        return {
            "maxValuesPerFacet": self.max_values_per_facet,
            "sortFacetValuesBy": dict(self.sort_facet_values_by),
        }


@dataclass
class Settings:
    displayed_attributes: list[str] = field(default_factory=lambda: ["*"])
    searchable_attributes: list[str] = field(default_factory=lambda: ["*"])
    filterable_attributes: list[Any] = field(default_factory=list)
    sortable_attributes: list[str] = field(default_factory=list)
    ranking_rules: list[str] = field(default_factory=lambda: list(DEFAULT_RANKING_RULES))
    stop_words: list[str] = field(default_factory=list)
    non_separator_tokens: list[str] = field(default_factory=list)
    separator_tokens: list[str] = field(default_factory=list)
    dictionary: list[str] = field(default_factory=list)
    synonyms: dict[str, list[str]] = field(default_factory=dict)
    distinct_attribute: Optional[str] = None
    proximity_precision: str = "byWord"  # byWord | byAttribute
    typo_tolerance: TypoTolerance = field(default_factory=TypoTolerance)
    faceting: Faceting = field(default_factory=Faceting)
    pagination: Pagination = field(default_factory=Pagination)
    embedders: dict[str, dict] = field(default_factory=dict)
    search_cutoff_ms: Optional[int] = None
    localized_attributes: Optional[list[dict]] = None
    facet_search: bool = True
    prefix_search: str = "indexingTime"  # indexingTime | disabled
    exact_attributes: list[str] = field(default_factory=list)
    chat: Optional[dict] = None
    # sub-route-only setting (reference: settings.rs ALL_SETTINGS_NAMES
    # includes foreign_keys; it is NOT part of the main /settings payload)
    foreign_keys: list = field(default_factory=list)

    # ------------------------------------------------------------------

    def clone(self) -> "Settings":
        return copy.deepcopy(self)

    def searchable_is_wildcard(self) -> bool:
        return self.searchable_attributes == ["*"]

    def filterable_attribute_names(self) -> list[str]:
        """Flatten filterable attribute rules to plain patterns."""
        out = []
        for rule in self.filterable_attributes:
            if isinstance(rule, str):
                out.append(rule)
            elif isinstance(rule, dict):
                out.extend(rule.get("attributePatterns", []))
        return out

    def filter_enabled_patterns(self) -> list[str]:
        """Patterns of rules whose filter features allow ANY filtering
        (milli filtered_matching_patterns + FilterFeatures::is_filterable:
        equality || comparison) — the set shown in 'Available filterable
        attribute patterns are' errors; a fully filter-disabled rule's
        patterns are excluded."""
        out = []
        for rule in self.filterable_attributes:
            if isinstance(rule, str):
                out.append(rule)
            elif isinstance(rule, dict):
                f = rule.get("features", {}).get("filter", {})
                if f.get("equality", True) or f.get("comparison", False):
                    out.extend(rule.get("attributePatterns", []))
        return out

    def locales_for_field(self, attr: str) -> Optional[list[str]]:
        """Locales forced for one attribute by `localizedAttributes`
        (reference: milli LocalizedAttributesRule::match_str — FIRST
        matching rule wins; [] means "any language" i.e. detection).
        None = no rule (detection)."""
        for rule in self.localized_attributes or ():
            patterns = rule.get("attributePatterns", [])
            if any(_match_pattern(p, attr) for p in patterns):
                locs = rule.get("locales", [])
                return list(locs)
        return None

    def infer_search_locales(
        self, attributes_to_search_on: Optional[list[str]] = None
    ) -> Optional[list[str]]:
        """Locales allow-list for a query that did not pass `locales`:
        the union of localizedAttributes locales over the searched
        attributes (reference meilisearch/src/search/mod.rs — search
        restricted to attrs whose rules share locales steers detection;
        tests/search/locales.rs auto_infer_*). None when no rule
        contributes (pure detection)."""
        if not self.localized_attributes:
            return None
        attrs = attributes_to_search_on
        if not attrs or "*" in attrs:
            attrs = self.searchable_attributes
        out: list[str] = []
        if not attrs or "*" in attrs:
            # all fields searchable: every rule's locales contribute
            for rule in self.localized_attributes:
                for loc in rule.get("locales", []):
                    if loc not in out:
                        out.append(loc)
            return out or None
        for attr in attrs:
            locs = self.locales_for_field(attr)
            for loc in locs or ():
                if loc not in out:
                    out.append(loc)
        return out or None

    def filter_features_for(self, attr: str) -> dict:
        """Return the filter feature set for an attribute.

        Plain string rules enable everything (legacy behavior); object rules
        carry explicit `features` (reference:
        milli/src/attribute_patterns.rs + filterable_attributes_rules.rs).
        """
        for rule_index, rule in enumerate(self.filterable_attributes):
            if isinstance(rule, str):
                if _match_pattern(rule, attr):
                    return {
                        "facetSearch": True,
                        "filter": {"equality": True, "comparison": True},
                        "rule_index": rule_index,
                    }
            elif isinstance(rule, dict):
                if any(
                    _match_pattern(p, attr, legacy=False)
                    for p in rule.get("attributePatterns", [])
                ):
                    feats = rule.get("features", {})
                    eq = feats.get("filter", {}).get("equality", True)
                    cmp_ = feats.get("filter", {}).get("comparison", False)
                    if not eq and not cmp_:
                        # FilterFeatures::is_filterable = eq || comparison:
                        # a fully filter-disabled rule makes the attribute
                        # NOT filterable (first matching rule wins —
                        # tests/search/filters.rs priority scenarios)
                        return {}
                    return {
                        "facetSearch": feats.get("facetSearch", False),
                        "filter": {"equality": eq, "comparison": cmp_},
                        "rule_index": rule_index,
                    }
        return {}

    def is_filterable(self, attr: str) -> bool:
        return bool(self.filter_features_for(attr))

    def is_sortable(self, attr: str) -> bool:
        return attr in self.sortable_attributes

    # -- JSON (API camelCase) -------------------------------------------

    def to_json(self) -> dict:
        return {
            "displayedAttributes": list(self.displayed_attributes),
            "searchableAttributes": list(self.searchable_attributes),
            "filterableAttributes": list(self.filterable_attributes),
            "sortableAttributes": sorted(self.sortable_attributes),
            "rankingRules": list(self.ranking_rules),
            "stopWords": sorted(self.stop_words),
            "nonSeparatorTokens": sorted(self.non_separator_tokens),
            "separatorTokens": sorted(self.separator_tokens),
            "dictionary": sorted(self.dictionary),
            "synonyms": {k: list(v) for k, v in sorted(self.synonyms.items())},
            "distinctAttribute": self.distinct_attribute,
            "proximityPrecision": self.proximity_precision,
            "typoTolerance": self.typo_tolerance.to_json(),
            "faceting": self.faceting.to_json(),
            "pagination": self.pagination.to_json(),
            "embedders": dict(self.embedders),
            "searchCutoffMs": self.search_cutoff_ms,
            "localizedAttributes": self.localized_attributes,
            "facetSearch": self.facet_search,
            "prefixSearch": self.prefix_search,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Settings":
        s = cls()
        s.apply_json(data)
        return s

    def apply_json(self, data: dict) -> set[str]:
        """Apply a partial settings JSON patch; `null` resets a setting to its
        default. Returns the set of changed setting names."""
        changed: set[str] = set()
        defaults = Settings()

        if data.get("localizedAttributes") is not None:
            from .errors import EngineError, ErrorCode
            from .locales import validate_locales

            rules = data["localizedAttributes"]
            if not isinstance(rules, list):
                raise EngineError(
                    ErrorCode.INVALID_SETTINGS_LOCALIZED_ATTRIBUTES,
                    "Invalid value type at `.localizedAttributes`: expected"
                    " an array of rules.",
                )
            for i, rule in enumerate(rules):
                if not isinstance(rule, dict) or "attributePatterns" not in rule:
                    raise EngineError(
                        ErrorCode.INVALID_SETTINGS_LOCALIZED_ATTRIBUTES,
                        f"Invalid value at `.localizedAttributes[{i}]`:"
                        " expected an object with `attributePatterns` and"
                        " `locales` fields.",
                    )
                validate_locales(
                    rule.get("locales"),
                    code=ErrorCode.INVALID_SETTINGS_LOCALIZED_ATTRIBUTES,
                    field=f".localizedAttributes[{i}].locales",
                )

        def setattr_tracked(name, value):
            if getattr(self, name) != value:
                setattr(self, name, value)
                changed.add(name)

        simple = {
            "displayedAttributes": "displayed_attributes",
            "searchableAttributes": "searchable_attributes",
            "filterableAttributes": "filterable_attributes",
            "sortableAttributes": "sortable_attributes",
            "rankingRules": "ranking_rules",
            "stopWords": "stop_words",
            "nonSeparatorTokens": "non_separator_tokens",
            "separatorTokens": "separator_tokens",
            "dictionary": "dictionary",
            "distinctAttribute": "distinct_attribute",
            "proximityPrecision": "proximity_precision",
            "searchCutoffMs": "search_cutoff_ms",
            "localizedAttributes": "localized_attributes",
            "facetSearch": "facet_search",
            "prefixSearch": "prefix_search",
            "exactAttributes": "exact_attributes",
            "chat": "chat",
            "foreignKeys": "foreign_keys",
        }
        for key, attr in simple.items():
            if key in data:
                value = data[key]
                if value is None:
                    value = copy.deepcopy(getattr(defaults, attr))
                setattr_tracked(attr, value)

        if "synonyms" in data:
            value = data["synonyms"] or {}
            setattr_tracked("synonyms", {k: list(v) for k, v in value.items()})

        if "typoTolerance" in data:
            tt = data["typoTolerance"]
            if tt is None:
                setattr_tracked("typo_tolerance", TypoTolerance())
            else:
                new = copy.deepcopy(self.typo_tolerance)
                if "enabled" in tt and tt["enabled"] is not None:
                    new.enabled = bool(tt["enabled"])
                mws = tt.get("minWordSizeForTypos")
                if mws:
                    if mws.get("oneTypo") is not None:
                        new.min_word_size_for_typos.one_typo = int(mws["oneTypo"])
                    if mws.get("twoTypos") is not None:
                        new.min_word_size_for_typos.two_typos = int(mws["twoTypos"])
                if "disableOnWords" in tt and tt["disableOnWords"] is not None:
                    new.disable_on_words = list(tt["disableOnWords"])
                if "disableOnAttributes" in tt and tt["disableOnAttributes"] is not None:
                    new.disable_on_attributes = list(tt["disableOnAttributes"])
                if "disableOnNumbers" in tt and tt["disableOnNumbers"] is not None:
                    new.disable_on_numbers = bool(tt["disableOnNumbers"])
                if new != self.typo_tolerance:
                    self.typo_tolerance = new
                    changed.add("typo_tolerance")

        if "faceting" in data:
            f = data["faceting"]
            if f is None:
                setattr_tracked("faceting", Faceting())
            else:
                new = copy.deepcopy(self.faceting)
                if f.get("maxValuesPerFacet") is not None:
                    new.max_values_per_facet = int(f["maxValuesPerFacet"])
                if f.get("sortFacetValuesBy") is not None:
                    new.sort_facet_values_by.update(f["sortFacetValuesBy"])
                if new != self.faceting:
                    self.faceting = new
                    changed.add("faceting")

        if "pagination" in data:
            p = data["pagination"]
            if p is None:
                setattr_tracked("pagination", Pagination())
            elif p.get("maxTotalHits") is not None:
                new = Pagination(max_total_hits=int(p["maxTotalHits"]))
                if new != self.pagination:
                    self.pagination = new
                    changed.add("pagination")

        if "embedders" in data:
            value = data["embedders"]
            if value is None:
                setattr_tracked("embedders", {})
            else:
                new = dict(self.embedders)
                for name, conf in value.items():
                    if conf is None:
                        new.pop(name, None)
                    else:
                        from ..vector.embedders import (
                            validate_embedder_settings,
                        )

                        validate_embedder_settings(name, conf)
                        new[name] = conf
                setattr_tracked("embedders", new)

        return changed


def _match_pattern(pattern: str, attr: str, legacy: bool = True) -> bool:
    """Attribute pattern matching (reference:
    milli/src/attribute_patterns.rs:89 match_pattern): `*` matches
    everything, `*mid*` contains, `*suffix` ends-with, `prefix*`
    starts-with, exact otherwise. With `legacy` (match_field_legacy —
    string rules in searchable/sortable/filterable settings) a pattern
    also matches nested fields of a matching parent (`a.b` matches
    pattern `a`); OBJECT attributePatterns do NOT get that extension
    (tests/search/filters.rs priority: rule `doggos` must not claim
    `doggos.name`)."""
    if pattern == "*":
        return True
    if pattern.startswith("*") and pattern.endswith("*") and len(pattern) > 1:
        return pattern[1:-1] in attr
    if pattern.startswith("*"):
        return attr.endswith(pattern[1:])
    if pattern.endswith("*"):
        return attr.startswith(pattern[:-1])
    if attr == pattern:
        return True
    return legacy and attr.startswith(pattern + ".")
