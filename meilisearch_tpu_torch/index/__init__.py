from .store import IndexStore, FieldsIdsMap, flatten_json, facet_string_normalize

__all__ = ["IndexStore", "FieldsIdsMap", "flatten_json", "facet_string_normalize"]
