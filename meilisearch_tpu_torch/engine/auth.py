"""API keys and tenant tokens.

Reference: crates/meilisearch-auth/src/ — key store with action + index
pattern scoping, default search/admin/chat keys derived from the master key,
and tenant tokens (JWTs signed with an API key embedding searchRules).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from ..types.errors import EngineError, ErrorCode
from .tasks import now_iso

ALL_ACTIONS = [
    "*",
    "search",
    "documents.*",
    "documents.add",
    "documents.get",
    "documents.delete",
    "indexes.*",
    "indexes.create",
    "indexes.get",
    "indexes.update",
    "indexes.delete",
    "indexes.swap",
    "tasks.*",
    "tasks.cancel",
    "tasks.delete",
    "tasks.get",
    "settings.*",
    "settings.get",
    "settings.update",
    "stats.get",
    "metrics.get",
    "dumps.create",
    "snapshots.create",
    "version",
    "keys.create",
    "keys.get",
    "keys.update",
    "keys.delete",
    "experimental.get",
    "experimental.update",
    "network.get",
    "network.update",
    "export",
    "chatCompletions",
    "chats.*",
    "chats.get",
    "chats.delete",
    "chatsSettings.*",
    "chatsSettings.get",
    "chatsSettings.update",
    "webhooks.get",
    "webhooks.update",
    "webhooks.delete",
    "webhooks.create",
    "*.get",
]


def action_allowed(granted: list[str], action: str) -> bool:
    if "*" in granted or action in granted:
        return True
    if "." in action:
        group = action.split(".")[0] + ".*"
        if group in granted:
            return True
        if action.endswith(".get") and "*.get" in granted:
            return True
    return False


def index_pattern_match(pattern: str, index_uid: str) -> bool:
    if pattern == "*":
        return True
    if pattern.endswith("*"):
        return index_uid.startswith(pattern[:-1])
    return pattern == index_uid


@dataclass
class ApiKey:
    uid: str
    key: str
    name: Optional[str]
    description: Optional[str]
    actions: list[str]
    indexes: list[str]
    expires_at: Optional[str]
    created_at: str = field(default_factory=now_iso)
    updated_at: str = field(default_factory=now_iso)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "key": self.key,
            "uid": self.uid,
            "actions": self.actions,
            "indexes": self.indexes,
            "expiresAt": self.expires_at,
            "createdAt": self.created_at,
            "updatedAt": self.updated_at,
        }

    def is_expired(self) -> bool:
        if not self.expires_at:
            return False
        from datetime import datetime

        try:
            exp = datetime.fromisoformat(self.expires_at.replace("Z", "+00:00"))
            from datetime import timezone

            return exp < datetime.now(timezone.utc)
        except ValueError:
            return False


def _derive_key(master_key: str, uid: str) -> str:
    return hmac.new(
        master_key.encode("utf-8"), uid.encode("utf-8"), hashlib.sha256
    ).hexdigest()


class AuthController:
    def __init__(self, master_key: Optional[str] = None):
        self.master_key = master_key
        self.keys: dict[str, ApiKey] = {}  # by key value
        self.keys_by_uid: dict[str, ApiKey] = {}
        if master_key:
            self._create_default_keys()

    def _create_default_keys(self):
        self.create_key(
            {
                "name": "Default Search API Key",
                "description": "Use it to search from the frontend",
                "actions": ["search"],
                "indexes": ["*"],
                "expiresAt": None,
                "uid": str(uuid.uuid5(uuid.NAMESPACE_URL, "default-search-key")),
            }
        )
        self.create_key(
            {
                "name": "Default Admin API Key",
                "description": "Use it for anything that is not a search operation. Caution! Do not expose it on a public frontend",
                "actions": ["*"],
                "indexes": ["*"],
                "expiresAt": None,
                "uid": str(uuid.uuid5(uuid.NAMESPACE_URL, "default-admin-key")),
            }
        )

    # -- CRUD --------------------------------------------------------------

    def create_key(self, body: dict) -> ApiKey:
        actions = body.get("actions")
        indexes = body.get("indexes")
        if not isinstance(actions, list) or not actions:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Invalid value at `.actions`: expected a list of actions.",
            )
        for a in actions:
            if a not in ALL_ACTIONS:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Unknown value `{a}` at `.actions`.",
                )
        if not isinstance(indexes, list):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Invalid value at `.indexes`: expected a list of index patterns.",
            )
        uid = body.get("uid") or str(uuid.uuid4())
        key_value = _derive_key(self.master_key or "", uid)
        key = ApiKey(
            uid=uid,
            key=key_value,
            name=body.get("name"),
            description=body.get("description"),
            actions=actions,
            indexes=indexes,
            expires_at=body.get("expiresAt"),
        )
        self.keys[key.key] = key
        self.keys_by_uid[key.uid] = key
        return key

    def get_key(self, key_or_uid: str) -> ApiKey:
        key = self.keys.get(key_or_uid) or self.keys_by_uid.get(key_or_uid)
        if key is None:
            raise EngineError(
                ErrorCode.API_KEY_NOT_FOUND,
                f"API key `{key_or_uid}` not found.",
            )
        return key

    def update_key(self, key_or_uid: str, body: dict) -> ApiKey:
        key = self.get_key(key_or_uid)
        if "actions" in body or "indexes" in body or "expiresAt" in body:
            for forbidden in ("actions", "indexes", "expiresAt", "uid", "key"):
                if forbidden in body:
                    raise EngineError(
                        ErrorCode.IMMUTABLE_API_KEY_ACTIONS
                        if forbidden == "actions"
                        else ErrorCode.BAD_REQUEST,
                        f"The `{forbidden}` field of an API key cannot be changed.",
                    )
        if "name" in body:
            key.name = body["name"]
        if "description" in body:
            key.description = body["description"]
        key.updated_at = now_iso()
        return key

    def delete_key(self, key_or_uid: str) -> None:
        key = self.get_key(key_or_uid)
        del self.keys[key.key]
        del self.keys_by_uid[key.uid]

    def list_keys(self) -> list[ApiKey]:
        return sorted(self.keys.values(), key=lambda k: k.created_at)

    # -- authorization -------------------------------------------------------

    def authenticate(
        self, token: Optional[str], action: str, index_uid: Optional[str]
    ) -> dict:
        """Returns {'filters': {index: searchRules}} context or raises.

        Master key grants everything; API keys are checked for action and
        index pattern; tenant tokens (JWTs) are verified against their key.
        """
        if self.master_key is None:
            return {}
        if not token:
            raise EngineError(
                ErrorCode.MISSING_AUTHORIZATION_HEADER,
                "The Authorization header is missing. It must use the bearer"
                " authorization method.",
            )
        if token == self.master_key:
            return {}
        key = self.keys.get(token)
        if key is not None:
            self._check_key(key, action, index_uid)
            return {}
        # maybe a tenant token
        rules = self._verify_tenant_token(token, action, index_uid)
        if rules is not None:
            return {"searchRules": rules}
        raise EngineError(
            ErrorCode.INVALID_API_KEY, "The provided API key is invalid."
        )

    def _check_key(self, key: ApiKey, action: str, index_uid: Optional[str]):
        if key.is_expired():
            raise EngineError(
                ErrorCode.INVALID_API_KEY, "The provided API key is invalid."
            )
        if not action_allowed(key.actions, action):
            raise EngineError(
                ErrorCode.INVALID_API_KEY, "The provided API key is invalid."
            )
        if index_uid is not None and not any(
            index_pattern_match(p, index_uid) for p in key.indexes
        ):
            raise EngineError(
                ErrorCode.INVALID_API_KEY, "The provided API key is invalid."
            )

    # -- tenant tokens ---------------------------------------------------------

    def _verify_tenant_token(self, token: str, action: str, index_uid):
        parts = token.split(".")
        if len(parts) != 3:
            return None
        try:
            payload = json.loads(_b64url_decode(parts[1]))
        except Exception:
            return None
        uid = payload.get("apiKeyUid")
        key = self.keys_by_uid.get(uid)
        if key is None:
            return None
        expected = make_tenant_token_signature(
            parts[0] + "." + parts[1], key.key
        )
        if not hmac.compare_digest(expected, parts[2]):
            raise EngineError(
                ErrorCode.INVALID_API_KEY, "Tenant token expired or invalid."
            )
        exp = payload.get("exp")
        if exp is not None and exp < time.time():
            raise EngineError(
                ErrorCode.INVALID_API_KEY,
                "Tenant token expired. Was valid up to `%s`." % exp,
            )
        if action != "search":
            raise EngineError(
                ErrorCode.INVALID_API_KEY,
                "Tenant tokens can only be used for search operations.",
            )
        self._check_key(key, action, None)
        rules = payload.get("searchRules")
        if index_uid is not None and rules is not None:
            allowed = _tenant_rules_for_index(rules, index_uid)
            if allowed is None:
                raise EngineError(
                    ErrorCode.INVALID_API_KEY,
                    "The provided tenant token cannot be used on index"
                    f" `{index_uid}`.",
                )
            if not any(
                index_pattern_match(p, index_uid) for p in key.indexes
            ):
                raise EngineError(
                    ErrorCode.INVALID_API_KEY,
                    "The provided API key is invalid.",
                )
        return rules


def _tenant_rules_for_index(rules: Any, index_uid: str):
    if isinstance(rules, list):
        for p in rules:
            if index_pattern_match(p, index_uid):
                return {}
        return None
    if isinstance(rules, dict):
        for pattern, sub in rules.items():
            if index_pattern_match(pattern, index_uid):
                return sub or {}
        return None
    return None


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(data: str) -> bytes:
    padding = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + padding)


def make_tenant_token_signature(signing_input: str, api_key: str) -> str:
    mac = hmac.new(
        api_key.encode("utf-8"), signing_input.encode("ascii"), hashlib.sha256
    )
    return _b64url_encode(mac.digest())


def generate_tenant_token(
    api_key_uid: str,
    api_key: str,
    search_rules: Any,
    expires_at: Optional[float] = None,
) -> str:
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = {"searchRules": search_rules, "apiKeyUid": api_key_uid}
    if expires_at is not None:
        payload["exp"] = int(expires_at)
    body = _b64url_encode(json.dumps(payload).encode())
    signing_input = header + "." + body
    return signing_input + "." + make_tenant_token_signature(signing_input, api_key)
