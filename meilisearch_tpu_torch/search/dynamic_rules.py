"""Dynamic search rules: query-conditioned document pinning.

Reference: milli/src/dynamic_search_rules.rs + routes/dynamic_search_rules.rs
— rules with activation conditions (time window, query emptiness / required
words) and pin actions (document -> result position). Matching rules are
resolved by ascending precedence; pinned documents are removed from the
organic ranking and re-injected at their target positions
(milli merge_positioned_hits_into_page, lib.rs:579).
"""

from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import Optional

from ..types.errors import EngineError, ErrorCode

# Reference DsrFuel defaults (milli lib.rs:243-300): bounded rule evaluation.
MAX_ACTIVE_RULES = 100
MAX_PIN_ACTIONS = 100
MAX_COUNTED_WORDS = 10


class DynamicSearchRules:
    """Global rule store (rules carry per-index selectors)."""

    def __init__(self):
        self.rules: dict[str, dict] = {}

    def update_or_create(self, uid: str, patch: dict) -> dict:
        rule = self.rules.get(
            uid,
            {
                "uid": uid,
                "description": None,
                "precedence": None,
                "active": True,
                "conditions": {},
                "actions": [],
                "lastUpdatedAt": None,
            },
        )
        for key in ("description", "precedence", "active", "conditions", "actions"):
            if key in patch and patch[key] is not None:
                rule[key] = patch[key]
        for action in rule.get("actions") or []:
            if not isinstance(action, dict) or "selector" not in action or "action" not in action:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    "Invalid value at `.actions`: each action needs a"
                    " `selector` and an `action`.",
                )
            if action["action"].get("type") != "pin":
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Unknown action type `{action['action'].get('type')}`:"
                    " expected `pin`.",
                )
        conditions = rule.get("conditions") or {}
        q = conditions.get("query") or {}
        if q.get("isEmpty") is True and q.get("words"):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "either `isEmpty` or `words` can be used, not both at once",
            )
        rule["lastUpdatedAt"] = (
            datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")
        )
        self.rules[uid] = rule
        return rule

    def delete(self, uid: str) -> None:
        if uid not in self.rules:
            raise EngineError(
                ErrorCode.NOT_FOUND, f"Dynamic search rule `{uid}` not found."
            )
        del self.rules[uid]

    def list(self, query: Optional[str], active: Optional[bool]) -> list[dict]:
        out = []
        for uid in sorted(self.rules):
            rule = self.rules[uid]
            if active is not None and bool(rule.get("active")) != active:
                continue
            if query:
                haystack = (rule.get("description") or "") + " " + (
                    (rule.get("conditions") or {}).get("query", {}) or {}
                ).get("words", "")
                if query.lower() not in haystack.lower():
                    continue
            out.append(rule)
        return out

    # -- search-time resolution ------------------------------------------------

    def resolve_pins(
        self, store, query_words: list[str], query_is_empty: bool
    ) -> list[tuple[int, int]]:
        """Returns [(position, docid)] for the active matching rules."""
        matching = []
        now = datetime.now(timezone.utc)
        count = 0
        for uid in sorted(self.rules):
            rule = self.rules[uid]
            if not rule.get("active", True):
                continue
            conditions = rule.get("conditions") or {}
            t = conditions.get("time") or {}
            if t.get("from") and _parse_dt(t["from"]) and now < _parse_dt(t["from"]):
                continue
            if t.get("to") and _parse_dt(t["to"]) and now > _parse_dt(t["to"]):
                continue
            q = conditions.get("query") or {}
            if q.get("isEmpty") is True and not query_is_empty:
                continue
            if q.get("isEmpty") is False and query_is_empty:
                continue
            words = q.get("words")
            if words:
                # the rule's condition words are an array (a bare string is
                # accepted as one entry); normalize each the same way query
                # words are tokenized before matching
                if isinstance(words, str):
                    words = [words]
                tokenizer = store.make_tokenizer()
                needed = [
                    w
                    for entry in words
                    for w, _ in tokenizer.indexed_words(str(entry))
                ][:MAX_COUNTED_WORDS]
                if not all(w in query_words for w in needed):
                    continue
            matching.append(rule)
            count += 1
            if count >= MAX_ACTIVE_RULES:
                break

        # ascending precedence wins (None = lowest precedence)
        matching.sort(
            key=lambda r: (
                r.get("precedence") is None,
                r.get("precedence") or 0,
                r["uid"],
            )
        )
        pins: list[tuple[int, int]] = []
        seen_docs: set[int] = set()
        for rule in matching:
            for action in rule.get("actions") or []:
                selector = action.get("selector") or {}
                if selector.get("indexUid") not in (None, store.uid):
                    continue
                docid = store.external_to_internal.get(str(selector.get("id")))
                if docid is None or docid in seen_docs:
                    continue
                seen_docs.add(docid)
                pins.append((int(action["action"].get("position", 0)), docid))
                if len(pins) >= MAX_PIN_ACTIONS:
                    return sorted(pins)
        return sorted(pins)


def merge_pins_into_page(
    organic: list[int], pins: list[tuple[int, int]], offset: int, limit: int
) -> list[int]:
    """Inject pinned docids at their target positions and slice the page
    (reference: milli merge_positioned_hits_into_page — pins are pumped
    forward when there are fewer organic results than requested)."""
    pinned_ids = {d for _p, d in pins}
    organic = [d for d in organic if d not in pinned_ids]
    merged: list[int] = []
    pi = oi = 0
    total = len(organic) + len(pins)
    while len(merged) < total:
        if pi < len(pins) and pins[pi][0] <= len(merged):
            merged.append(pins[pi][1])
            pi += 1
        elif oi < len(organic):
            merged.append(organic[oi])
            oi += 1
        elif pi < len(pins):
            merged.append(pins[pi][1])
            pi += 1
        else:
            break
    return merged[offset : offset + limit]


def _parse_dt(value: str):
    try:
        return datetime.fromisoformat(str(value).replace("Z", "+00:00"))
    except (ValueError, TypeError):
        return None
