"""Engine error taxonomy.

Mirrors the reference's error codes surfaced over the API
(the Meilisearch source, crates/meilisearch-types/src/error.rs): every API error has a
`message`, `code`, `type`, `link` quadruple.
"""

from __future__ import annotations

from enum import Enum


class ErrorType(str, Enum):
    INVALID_REQUEST = "invalid_request"
    INTERNAL = "internal"
    AUTH = "auth"
    SYSTEM = "system"


class ErrorCode(str, Enum):
    BAD_REQUEST = "bad_request"
    INDEX_NOT_FOUND = "index_not_found"
    INDEX_ALREADY_EXISTS = "index_already_exists"
    INVALID_INDEX_UID = "invalid_index_uid"
    DOCUMENT_NOT_FOUND = "document_not_found"
    MISSING_DOCUMENT_ID = "missing_document_id"
    INVALID_DOCUMENT_ID = "invalid_document_id"
    INVALID_DOCUMENT_FIELDS = "invalid_document_fields"
    INVALID_DOCUMENT_FILTER = "invalid_document_filter"
    MISSING_DOCUMENT_FILTER = "missing_document_filter"
    INVALID_SEARCH_Q = "invalid_search_q"
    INVALID_SEARCH_FILTER = "invalid_search_filter"
    INVALID_SEARCH_SORT = "invalid_search_sort"
    INVALID_SEARCH_FACETS = "invalid_search_facets"
    INVALID_SEARCH_LIMIT = "invalid_search_limit"
    INVALID_SEARCH_OFFSET = "invalid_search_offset"
    INVALID_SEARCH_PAGE = "invalid_search_page"
    INVALID_SEARCH_HITS_PER_PAGE = "invalid_search_hits_per_page"
    INVALID_SEARCH_ATTRIBUTES_TO_SEARCH_ON = "invalid_search_attributes_to_search_on"
    INVALID_SEARCH_DISTINCT = "invalid_search_distinct"
    INVALID_SEARCH_MATCHING_STRATEGY = "invalid_search_matching_strategy"
    INVALID_SEARCH_SHOW_MATCHES_POSITION = "invalid_search_show_matches_position"
    INVALID_SEARCH_SHOW_RANKING_SCORE = "invalid_search_show_ranking_score"
    INVALID_SEARCH_SHOW_RANKING_SCORE_DETAILS = (
        "invalid_search_show_ranking_score_details"
    )
    INVALID_SEARCH_RETRIEVE_VECTORS = "invalid_search_retrieve_vectors"
    INVALID_SEARCH_SHOW_PERFORMANCE_DETAILS = (
        "invalid_search_show_performance_details"
    )
    INVALID_MULTI_SEARCH_QUERY_SHOW_PERFORMANCE_DETAILS = (
        "invalid_multi_search_query_show_performance_details"
    )
    MISSING_INDEX_UID = "missing_index_uid"
    INVALID_MULTI_SEARCH_WEIGHT = "invalid_multi_search_weight"
    INVALID_MULTI_SEARCH_QUERY_PAGINATION = (
        "invalid_multi_search_query_pagination"
    )
    INVALID_MULTI_SEARCH_QUERY_FACETS = "invalid_multi_search_query_facets"
    INVALID_MULTI_SEARCH_FEDERATION_OPTIONS = (
        "invalid_multi_search_federation_options"
    )
    INVALID_MULTI_SEARCH_DISTINCT = "invalid_multi_search_distinct"
    INVALID_SEARCH_RANKING_SCORE_THRESHOLD = "invalid_search_ranking_score_threshold"
    INVALID_SIMILAR_ID = "invalid_similar_id"
    INVALID_SETTINGS_RANKING_RULES = "invalid_settings_ranking_rules"
    INVALID_SETTINGS_TYPO_TOLERANCE = "invalid_settings_typo_tolerance"
    INVALID_SETTINGS_DISPLAYED_ATTRIBUTES = (
        "invalid_settings_displayed_attributes"
    )
    INVALID_SETTINGS_SEARCHABLE_ATTRIBUTES = (
        "invalid_settings_searchable_attributes"
    )
    INVALID_SETTINGS_FILTERABLE_ATTRIBUTES = (
        "invalid_settings_filterable_attributes"
    )
    INVALID_SETTINGS_SORTABLE_ATTRIBUTES = (
        "invalid_settings_sortable_attributes"
    )
    INVALID_SETTINGS_STOP_WORDS = "invalid_settings_stop_words"
    INVALID_SETTINGS_NON_SEPARATOR_TOKENS = (
        "invalid_settings_non_separator_tokens"
    )
    INVALID_SETTINGS_SEPARATOR_TOKENS = "invalid_settings_separator_tokens"
    INVALID_SETTINGS_DICTIONARY = "invalid_settings_dictionary"
    INVALID_SETTINGS_SYNONYMS = "invalid_settings_synonyms"
    INVALID_SETTINGS_DISTINCT_ATTRIBUTE = (
        "invalid_settings_distinct_attribute"
    )
    INVALID_SETTINGS_PROXIMITY_PRECISION = (
        "invalid_settings_proximity_precision"
    )
    INVALID_SETTINGS_FACETING = "invalid_settings_faceting"
    INVALID_SETTINGS_PAGINATION = "invalid_settings_pagination"
    INVALID_SETTINGS_SEARCH_CUTOFF_MS = "invalid_settings_search_cutoff_ms"
    INVALID_SETTINGS_FACET_SEARCH = "invalid_settings_facet_search"
    INVALID_SETTINGS_PREFIX_SEARCH = "invalid_settings_prefix_search"
    INVALID_SETTINGS_EMBEDDERS = "invalid_settings_embedders"
    INVALID_FACET_SEARCH_FACET_NAME = "invalid_facet_search_facet_name"
    FACET_SEARCH_DISABLED = "facet_search_disabled"
    INVALID_API_KEY = "invalid_api_key"
    MISSING_AUTHORIZATION_HEADER = "missing_authorization_header"
    TASK_NOT_FOUND = "task_not_found"
    BATCH_NOT_FOUND = "batch_not_found"
    API_KEY_NOT_FOUND = "api_key_not_found"
    IMMUTABLE_API_KEY_UID = "immutable_api_key_uid"
    IMMUTABLE_API_KEY_ACTIONS = "immutable_api_key_actions"
    INVALID_SWAP_INDEXES = "invalid_swap_indexes"
    INVALID_STATE = "invalid_state"
    INTERNAL = "internal"
    FEATURE_NOT_ENABLED = "feature_not_enabled"
    INVALID_EMBEDDER = "invalid_embedder"
    VECTOR_EMBEDDING_ERROR = "vector_embedding_error"
    NOT_FOUND = "not_found"
    INVALID_SEARCH_PERSONALIZE = "invalid_search_personalize"
    REMOTE_INVALID_API_KEY = "remote_invalid_api_key"
    REMOTE_BAD_REQUEST = "remote_bad_request"
    REMOTE_BAD_RESPONSE = "remote_bad_response"
    REMOTE_REMOTE_ERROR = "remote_remote_error"
    REMOTE_COULD_NOT_SEND_REQUEST = "remote_could_not_send_request"
    TOO_MANY_SEARCH_REQUESTS = "too_many_search_requests"
    NO_SPACE_LEFT_ON_DEVICE = "no_space_left_on_device"
    INVALID_SEARCH_LOCALES = "invalid_search_locales"
    INVALID_SETTINGS_LOCALIZED_ATTRIBUTES = (
        "invalid_settings_localized_attributes"
    )

    @property
    def http_status(self) -> int:
        return _STATUS.get(self, 400)

    @property
    def error_type(self) -> ErrorType:
        if self in (
            ErrorCode.INVALID_API_KEY,
            ErrorCode.MISSING_AUTHORIZATION_HEADER,
        ):
            return ErrorType.AUTH
        if self is ErrorCode.INTERNAL:
            return ErrorType.INTERNAL
        if self in (
            ErrorCode.NO_SPACE_LEFT_ON_DEVICE,
            # reference error.rs: TooManySearchRequests is a System error
            # (search_queue.rs snapshot pins "type": "system")
            ErrorCode.TOO_MANY_SEARCH_REQUESTS,
        ):
            return ErrorType.SYSTEM
        return ErrorType.INVALID_REQUEST


_STATUS = {
    ErrorCode.INDEX_NOT_FOUND: 404,
    ErrorCode.DOCUMENT_NOT_FOUND: 404,
    ErrorCode.TASK_NOT_FOUND: 404,
    ErrorCode.BATCH_NOT_FOUND: 404,
    ErrorCode.API_KEY_NOT_FOUND: 404,
    ErrorCode.NOT_FOUND: 404,
    ErrorCode.INDEX_ALREADY_EXISTS: 409,
    ErrorCode.INVALID_API_KEY: 403,
    ErrorCode.MISSING_AUTHORIZATION_HEADER: 401,
    ErrorCode.INTERNAL: 500,
    ErrorCode.FEATURE_NOT_ENABLED: 400,
    ErrorCode.REMOTE_INVALID_API_KEY: 403,
    ErrorCode.REMOTE_REMOTE_ERROR: 502,
    ErrorCode.REMOTE_BAD_RESPONSE: 502,
    ErrorCode.REMOTE_COULD_NOT_SEND_REQUEST: 502,
    ErrorCode.TOO_MANY_SEARCH_REQUESTS: 503,
    ErrorCode.NO_SPACE_LEFT_ON_DEVICE: 422,
}


class EngineError(Exception):
    def __init__(self, code: ErrorCode, message: str, status: int = None):
        super().__init__(message)
        self.code = code
        self.message = message
        # per-site override: multi-search wraps per-query errors (incl.
        # index_not_found, normally 404) as 400 Bad Request responses
        # (reference multi/mod.rs search_one_index_doesnt_exist)
        self.status = status

    def to_json(self) -> dict:
        code = self.code.value
        return {
            "message": self.message,
            "code": code,
            "type": self.code.error_type.value,
            "link": f"https://docs.meilisearch.com/errors#{code}",
        }
