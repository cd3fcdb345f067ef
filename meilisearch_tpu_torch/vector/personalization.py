"""Personalized search: Cohere rerank of the hit page.

Reference: meilisearch/src/personalization/mod.rs — the `personalize`
search parameter carries a `userContext` string; hits are reranked by
Cohere `/v1/rerank` (model rerank-english-v3.0) against
"User Context: …\nQuery: …"; service disabled unless the server runs with
`--experimental-personalization-api-key` (option.rs:493).
"""

from __future__ import annotations

import json
from typing import Optional

from ..types.errors import EngineError, ErrorCode

COHERE_API_URL = "https://api.cohere.ai/v1/rerank"
COHERE_MODEL = "rerank-english-v3.0"


def validate_personalize(personalize) -> str:
    """Returns the userContext; raises invalid_search_personalize."""
    if not isinstance(personalize, dict):
        raise EngineError(
            ErrorCode.INVALID_SEARCH_PERSONALIZE,
            "Invalid value type at `.personalize`: expected an object with a"
            " `userContext` field.",
        )
    user_context = personalize.get("userContext")
    if not isinstance(user_context, str):
        raise EngineError(
            ErrorCode.INVALID_SEARCH_PERSONALIZE,
            "Missing field `userContext` inside `.personalize`.",
        )
    unknown = set(personalize) - {"userContext"}
    if unknown:
        raise EngineError(
            ErrorCode.INVALID_SEARCH_PERSONALIZE,
            f"Unknown field `{sorted(unknown)[0]}` inside `.personalize`.",
        )
    return user_context


class PersonalizationService:
    """Reranks a hit page; `api_key=None` is the Disabled service."""

    def __init__(self, api_key: Optional[str] = None):
        self.api_key = api_key

    def rerank_hits(
        self, hits: list[dict], personalize, query: Optional[str]
    ) -> list[dict]:
        user_context = validate_personalize(personalize)
        if self.api_key is None:
            raise EngineError(
                ErrorCode.FEATURE_NOT_ENABLED,
                "reranking search results requires enabling the"
                " `personalization` experimental feature. Run the server with"
                " --experimental-personalization-api-key.",
            )
        if not hits:
            return hits
        prompt = (
            f"User Context: {user_context}\nQuery: {query}"
            if query
            else f"User Context: {user_context}"
        )
        documents = [json.dumps(h, ensure_ascii=False, default=str) for h in hits]
        indices = self._call_rerank(prompt, documents)
        out = [hits[i] for i in indices if 0 <= i < len(hits)]
        seen = set(id(h) for h in out)
        out.extend(h for h in hits if id(h) not in seen)
        return out

    def _call_rerank(self, prompt: str, documents: list[str]) -> list[int]:
        import urllib.error
        import urllib.request

        from ..utils.http_policy import guarded_urlopen

        payload = {
            "model": COHERE_MODEL,
            "query": prompt,
            "documents": documents,
            "top_n": len(documents),
        }
        req = urllib.request.Request(
            COHERE_API_URL,
            data=json.dumps(payload).encode("utf-8"),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        try:
            with guarded_urlopen(req, timeout=30) as resp:
                data = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as err:
            status = err.code
            if status == 401:
                raise EngineError(
                    ErrorCode.REMOTE_INVALID_API_KEY,
                    "Personalization service: Unauthorized: invalid API key",
                )
            if status == 429:
                raise EngineError(
                    ErrorCode.TOO_MANY_SEARCH_REQUESTS,
                    "Personalization service: Rate limited: too many requests",
                )
            if 400 <= status < 500:
                raise EngineError(
                    ErrorCode.REMOTE_BAD_REQUEST,
                    f"Personalization service: Bad request: {err.reason}",
                )
            raise EngineError(
                ErrorCode.REMOTE_REMOTE_ERROR,
                f"Personalization service: Internal server error: {err.reason}",
            )
        except Exception as err:
            raise EngineError(
                ErrorCode.REMOTE_COULD_NOT_SEND_REQUEST,
                f"Personalization service: Network error: {err}",
            )
        try:
            results = data["results"]
            return [int(r["index"]) for r in results]
        except Exception as err:
            raise EngineError(
                ErrorCode.REMOTE_BAD_RESPONSE,
                f"Personalization service: Failed to parse response: {err}",
            )
