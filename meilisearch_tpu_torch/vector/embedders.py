"""Embedders.

Reference: milli/src/vector/embedder/ — Embedder enum: HuggingFace (in-process
inference), OpenAI, Ollama, REST, UserProvided, Composite
(embedder/mod.rs:23-35); search-time embeddings are LRU-cached.

Local inference (`huggingFace`) runs the port's BERT or XLM-RoBERTa
(models/hf_encoder.py; any other model type is refused with its name, as a
VECTOR_EMBEDDING_ERROR) on the device the index is bound to (`store.device`; None = the CPU), for
documents at indexing and for queries at search; the remote embedders are
host HTTP calls. A failure of the local model is a VECTOR_EMBEDDING_ERROR
and counts in `serving_stats()["device_errors"]` when a device is bound.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

import numpy as np

from ..types.errors import EngineError, ErrorCode

KNOWN_SOURCES = (
    "openAi",
    "huggingFace",
    "ollama",
    "userProvided",
    "rest",
    "composite",
)


def validate_embedder_settings(name: str, conf: dict) -> None:
    source = conf.get("source", "openAi")
    if source not in KNOWN_SOURCES:
        raise EngineError(
            ErrorCode.INVALID_EMBEDDER,
            f"`.embedders.{name}.source`: Invalid value `{source}`, expected"
            f" one of {', '.join(KNOWN_SOURCES)}.",
        )
    if source == "userProvided" and not conf.get("dimensions"):
        raise EngineError(
            ErrorCode.INVALID_EMBEDDER,
            f"`.embedders.{name}`: Missing field `dimensions` (note: this"
            " field is mandatory for source `userProvided`)",
        )
    if source == "composite":
        # reference: vector/settings.rs:230-259 — composite embedders pair a
        # searchEmbedder (queries) with an indexingEmbedder (documents)
        for sub in ("searchEmbedder", "indexingEmbedder"):
            sub_conf = conf.get(sub)
            if not isinstance(sub_conf, dict):
                raise EngineError(
                    ErrorCode.INVALID_EMBEDDER,
                    f"`.embedders.{name}`: Missing field `{sub}` (note: this"
                    " field is mandatory for source `composite`)",
                )
            sub_source = sub_conf.get("source", "openAi")
            if sub_source in ("composite", "userProvided"):
                raise EngineError(
                    ErrorCode.INVALID_EMBEDDER,
                    f"`.embedders.{name}.{sub}.source`: Invalid value"
                    f" `{sub_source}`: nested composite or userProvided"
                    " embedders are not allowed.",
                )
    if conf.get("documentTemplate") is not None:
        from .templates import Template

        Template(str(conf["documentTemplate"]))  # raises on invalid syntax
    # media fragments (reference: vector/settings.rs:169-182
    # indexing_fragments/search_fragments — REST-only, named JSON templates)
    for key in ("indexingFragments", "searchFragments"):
        frags = conf.get(key)
        if frags is None:
            continue
        if source != "rest":
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                f"`.embedders.{name}.{key}`: Field not available for source"
                f" `{source}` (note: fragments require source `rest`)",
            )
        if conf.get("documentTemplate") is not None:
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                f"`.embedders.{name}.{key}`: Cannot use both fragments and"
                " `documentTemplate`.",
            )
        if not isinstance(frags, dict):
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                f"`.embedders.{name}.{key}`: Expected a map of fragment"
                " names to fragment values.",
            )


class Embedder:
    """Dispatch over embedder sources."""

    def __init__(self, name: str, conf: dict, device=None):
        self.name = name
        self.conf = conf
        self.source = conf.get("source", "openAi")
        self.dimensions = conf.get("dimensions")
        self.device = device  # the local model's torch device (None: the CPU)

    def embed_search(self, text: str) -> np.ndarray:
        # keyed by the embedder's whole configuration, not its name alone:
        # indexes (or one index before and after a settings change) may
        # give one embedder name to different models
        conf = json.dumps(self.conf, sort_keys=True, default=str)
        key = hashlib.sha256(
            (conf + "\0" + self.name + "\0" + text).encode("utf-8")
        ).hexdigest()
        return _cached_embed(self, key, text)

    def _embed(self, text: str) -> np.ndarray:
        if self.source == "userProvided":
            raise EngineError(
                ErrorCode.VECTOR_EMBEDDING_ERROR,
                f"Cannot compute embeddings with embedder `{self.name}`:"
                " `userProvided` embedders cannot embed queries; pass a"
                " `vector` parameter instead.",
            )
        if self.source == "composite":
            # queries go through the searchEmbedder half
            return self._sub_embedder("searchEmbedder")._embed(text)
        if self.source == "huggingFace":
            return self._embed_huggingface(text)
        if self.source in ("openAi", "ollama", "rest"):
            return self._embed_rest(text)
        raise EngineError(
            ErrorCode.VECTOR_EMBEDDING_ERROR,
            f"Embedder source `{self.source}` is not available.",
        )

    def _sub_embedder(self, which: str) -> "Embedder":
        sub_conf = self.conf.get(which)
        if not isinstance(sub_conf, dict):
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                f"`.embedders.{self.name}`: Missing field `{which}`.",
            )
        return Embedder(f"{self.name}.{which}", sub_conf, self.device)

    def embed_documents(self, texts: list) -> np.ndarray:
        """Index-time batch embedding (reference Embedder::embed_index;
        HuggingFace batches through the in-process model, remote sources
        chunk over HTTP)."""
        if self.source == "userProvided":
            raise EngineError(
                ErrorCode.VECTOR_EMBEDDING_ERROR,
                f"Cannot compute embeddings with embedder `{self.name}`:"
                " `userProvided` embedders require `_vectors` in documents.",
            )
        if self.source == "composite":
            return self._sub_embedder("indexingEmbedder").embed_documents(texts)
        if self.source == "huggingFace":
            return self._local_model(list(texts))
        return np.stack([self._embed_rest(t) for t in texts])

    def _embed_huggingface(self, text: str) -> np.ndarray:
        return self._local_model([text])[0]

    def _local_model(self, texts: list) -> np.ndarray:
        """The huggingFace model's embeddings of `texts` on this embedder's
        device. Any failure is a VECTOR_EMBEDDING_ERROR, counted in
        device_errors when a device is bound; nothing retries on the CPU."""
        try:
            from ..models.hf_encoder import encoder

            model_name = self.conf.get("model", "BAAI/bge-base-en-v1.5")
            pooling = self.conf.get("pooling", "useModel")
            return encoder(model_name, pooling, self.device).encode(texts)
        except Exception as err:
            if self.device is not None:
                from ..search.device_batch import _stats_add

                _stats_add(device_errors=1)
            raise EngineError(
                ErrorCode.VECTOR_EMBEDDING_ERROR,
                f"Error while generating embeddings with embedder"
                f" `{self.name}`: {err}",
            )

    def _embed_rest(self, text: str) -> np.ndarray:
        import urllib.request

        from ..utils.http_policy import guarded_urlopen

        url = self.conf.get("url")
        if self.source == "openAi":
            url = url or "https://api.openai.com/v1/embeddings"
            payload = {
                "input": [text],
                "model": self.conf.get("model", "text-embedding-3-small"),
            }
            headers = {"Content-Type": "application/json"}
            if self.conf.get("apiKey"):
                headers["Authorization"] = f"Bearer {self.conf['apiKey']}"
        elif self.source == "ollama":
            url = url or "http://localhost:11434/api/embed"
            payload = {"model": self.conf.get("model"), "input": [text]}
            headers = {"Content-Type": "application/json"}
        else:
            if not url:
                raise EngineError(
                    ErrorCode.INVALID_EMBEDDER,
                    f"`.embedders.{self.name}.url`: Missing field `url`"
                    " (note: this field is mandatory for source `rest`)",
                )
            request_template = self.conf.get("request", {"input": "{{text}}"})
            payload = _inject_text(request_template, text)
            headers = {"Content-Type": "application/json", **(self.conf.get("headers") or {})}
            if self.conf.get("apiKey"):
                headers["Authorization"] = f"Bearer {self.conf['apiKey']}"
        try:
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode("utf-8"), headers=headers
            )
            with guarded_urlopen(req, timeout=30) as resp:
                data = json.loads(resp.read().decode("utf-8"))
        except Exception as err:
            raise EngineError(
                ErrorCode.VECTOR_EMBEDDING_ERROR,
                f"Error while generating embeddings with embedder"
                f" `{self.name}`: {err}",
            )
        emb = _extract_embedding(data, self.conf.get("response"))
        return np.asarray(emb, dtype=np.float32)

    def embed_fragment(self, rendered) -> np.ndarray:
        """Embed one rendered fragment JSON through the REST request
        template's `{{fragment}}` placeholder (reference:
        rest.rs:611 REQUEST_FRAGMENT_PLACEHOLDER)."""
        import urllib.request

        from ..utils.http_policy import guarded_urlopen

        if self.source != "rest":
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                f"Embedder `{self.name}`: fragments require source `rest`.",
            )
        url = self.conf.get("url")
        request_template = self.conf.get("request", {"input": "{{fragment}}"})
        payload = _inject_fragment(request_template, rendered)
        headers = {
            "Content-Type": "application/json",
            **(self.conf.get("headers") or {}),
        }
        if self.conf.get("apiKey"):
            headers["Authorization"] = f"Bearer {self.conf['apiKey']}"
        try:
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode("utf-8"), headers=headers
            )
            with guarded_urlopen(req, timeout=30) as resp:
                data = json.loads(resp.read().decode("utf-8"))
        except Exception as err:
            raise EngineError(
                ErrorCode.VECTOR_EMBEDDING_ERROR,
                f"Error while generating embeddings with embedder"
                f" `{self.name}`: {err}",
            )
        emb = _extract_embedding(data, self.conf.get("response"))
        return np.asarray(emb, dtype=np.float32)


_search_cache: dict = {}


def _cached_embed(embedder: Embedder, key: str, text: str) -> np.ndarray:
    if key in _search_cache:
        return _search_cache[key]
    emb = embedder._embed(text)
    if len(_search_cache) > 1000:
        _search_cache.clear()
    _search_cache[key] = emb
    return emb


def _inject_text(template, text):
    if isinstance(template, str):
        return template.replace("{{text}}", text)
    if isinstance(template, dict):
        return {k: _inject_text(v, text) for k, v in template.items()}
    if isinstance(template, list):
        return [_inject_text(v, text) for v in template]
    return template


def _inject_fragment(template, rendered):
    """Replace the `{{fragment}}` placeholder with the rendered fragment
    VALUE (a bare-placeholder string keeps the JSON type)."""
    if isinstance(template, str):
        if template.strip() == "{{fragment}}":
            return rendered
        if "{{fragment}}" in template:
            return template.replace("{{fragment}}", json.dumps(rendered))
        return template
    if isinstance(template, dict):
        return {k: _inject_fragment(v, rendered) for k, v in template.items()}
    if isinstance(template, list):
        return [_inject_fragment(v, rendered) for v in template]
    return template


def _extract_embedding(data, response_template):
    # OpenAI shape
    if isinstance(data, dict) and "data" in data:
        entries = data["data"]
        if entries and "embedding" in entries[0]:
            return entries[0]["embedding"]
    if isinstance(data, dict) and "embeddings" in data:
        embs = data["embeddings"]
        return embs[0] if embs and isinstance(embs[0], list) else embs
    if isinstance(data, dict) and "embedding" in data:
        return data["embedding"]
    if isinstance(data, list):
        return data[0] if data and isinstance(data[0], list) else data
    raise EngineError(
        ErrorCode.VECTOR_EMBEDDING_ERROR,
        "Could not extract embeddings from the embedder response.",
    )


def ensure_document_embeddings(store) -> None:
    """Index-time auto-embedding (reference: new/extract/vectors/mod.rs) —
    for every non-userProvided embedder, render each document through its
    documentTemplate and embed the docs that have no stored vectors (or were
    engine-generated, hence `regenerate: true`). Raises on embedding errors,
    failing the indexing task like the reference does."""
    settings = store.settings
    changed = False
    for name, conf in settings.embedders.items():
        source = conf.get("source", "openAi")
        if source == "userProvided":
            continue
        embedder = Embedder(name, conf, store.device)
        doc_conf = (
            conf.get("indexingEmbedder", {}) if source == "composite" else conf
        )
        template = doc_conf.get("documentTemplate")
        max_bytes = doc_conf.get("documentTemplateMaxBytes")
        per_doc = store.vectors.get(name, {})
        regen = store.vector_regenerate.get(name, {})
        todo = [
            docid
            for docid in sorted(store.documents_ids())
            if docid not in per_doc or regen.get(docid, True)
        ]
        if not todo:
            continue
        fragments = conf.get("indexingFragments")
        if fragments:
            # media fragments: each named fragment that renders for the
            # document becomes ONE of its embeddings (reference:
            # new/extract/vectors/mod.rs fragment diffing)
            from .templates import render_json_fragment

            new_vectors: dict[int, np.ndarray] = {}
            for docid in todo:
                rows = []
                for _fname, fvalue in sorted(fragments.items()):
                    rendered = render_json_fragment(
                        fvalue, doc=store.documents[docid]
                    )
                    if rendered is None:
                        continue
                    rows.append(embedder.embed_fragment(rendered))
                if rows:
                    new_vectors[docid] = np.stack(rows).astype(np.float32)
            with store._lock:
                for docid, mat in new_vectors.items():
                    store.vectors[name][docid] = mat
                    store.vector_regenerate[name][docid] = True
            changed = True
            continue
        searchable = None
        if not settings.searchable_is_wildcard():
            searchable = set(settings.searchable_attributes)
        from .templates import render_document_template

        texts = [
            render_document_template(
                template, store.documents[docid], searchable, max_bytes
            )
            for docid in todo
        ]
        # embed without holding the store lock (may be remote HTTP / model
        # inference); take it only for the table mutation so searches never
        # observe a half-written vectors table
        embs = embedder.embed_documents(texts)
        with store._lock:
            for docid, emb in zip(todo, np.asarray(embs, dtype=np.float32)):
                store.vectors[name][docid] = emb[None, :]
                store.vector_regenerate[name][docid] = True
        changed = True
    if changed:
        with store._lock:
            store._bump()


def get_embedder(store, name: Optional[str]) -> Embedder:
    embedders = store.settings.embedders
    if name is None:
        if len(embedders) == 1:
            name = next(iter(embedders))
        else:
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                "The embedder must be specified when the index has several"
                " embedders configured."
                if embedders
                else "Cannot find embedder: the index has no embedders"
                " configured.",
            )
    conf = embedders.get(name)
    if conf is None:
        raise EngineError(
            ErrorCode.INVALID_EMBEDDER,
            f"Cannot find embedder with name `{name}`.",
        )
    return Embedder(name, conf, store.device)
