"""Chat completions: the OpenAI-compatible RAG endpoint.

Reference: meilisearch routes/chats/chat_completions.rs — the workspace's
LLM (source/baseUrl/apiKey) is called with a `_meiliSearchInIndex` tool
whose schema enumerates the authorized indexes (chat_completions.rs:280-325);
tool calls are executed as index searches, their hits appended as tool
messages, and the loop continues until the model answers. Responses stream
as SSE when `stream: true`.
"""

from __future__ import annotations

import json
from ..types.errors import EngineError, ErrorCode

SEARCH_IN_INDEX = "_meiliSearchInIndex"
MAX_TOOL_ROUNDS = 10

DEFAULT_BASE_URLS = {
    "openAi": "https://api.openai.com/v1",
    "mistral": "https://api.mistral.ai/v1",
    "vLlm": "http://localhost:8000/v1",
}


def validate_workspace_settings(body: dict) -> None:
    """Reference parity: features.rs:84-95 ChatCompletionSettings::validate —
    azureOpenAi needs baseUrl+deploymentId+apiVersion, vLlm needs baseUrl."""
    source = body.get("source", "openAi")
    if source == "azureOpenAi" and not (
        body.get("baseUrl") and body.get("deploymentId") and body.get("apiVersion")
    ):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "azureOpenAi requires setting a valid `baseUrl`, `deploymentId`,"
            " and `apiVersion`",
        )
    if source == "vLlm" and not body.get("baseUrl"):
        raise EngineError(
            ErrorCode.BAD_REQUEST, "vLlm requires setting a valid `baseUrl`"
        )


def _llm_request(ws: dict, payload: dict):
    """URL + headers per source (reference routes/chats/config.rs: the
    AzureOpenAi arm builds async-openai's AzureConfig — deployment-scoped
    path, `api-version` query param, `api-key` header; every other source
    is OpenAI-compatible with a Bearer token)."""
    import urllib.request

    source = ws.get("source", "openAi")
    base = (ws.get("baseUrl") or DEFAULT_BASE_URLS.get(source, "")).rstrip("/")
    if not base:
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Chat workspace has no baseUrl and source `{source}` has no"
            " default endpoint.",
        )
    headers = {"Content-Type": "application/json"}
    if source == "azureOpenAi":
        url = (
            f"{base}/openai/deployments/{ws.get('deploymentId', '')}"
            f"/chat/completions?api-version={ws.get('apiVersion', '')}"
        )
        if ws.get("apiKey"):
            headers["api-key"] = ws["apiKey"]
    else:
        url = f"{base}/chat/completions"
        if ws.get("apiKey"):
            headers["Authorization"] = f"Bearer {ws['apiKey']}"
    return urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"), headers=headers
    )


def _build_search_tool(scheduler, prompts: dict) -> dict:
    index_uids = sorted(s.uid for s in scheduler.list_indexes())
    return {
        "type": "function",
        "function": {
            "name": SEARCH_IN_INDEX,
            "description": prompts.get(
                "searchDescription",
                "Search the Meilisearch indexes for relevant documents.",
            ),
            "parameters": {
                "type": "object",
                "properties": {
                    "index_uid": {
                        "type": "string",
                        "enum": index_uids,
                        "description": prompts.get(
                            "searchIndexUidParam",
                            "The index to search in.",
                        ),
                    },
                    "q": {
                        "type": "string",
                        "description": prompts.get(
                            "searchQParam", "The search query."
                        ),
                    },
                },
                "required": ["index_uid", "q"],
                "additionalProperties": False,
            },
        },
    }


def _call_llm(ws: dict, payload: dict) -> dict:
    import urllib.error

    from ..utils.http_policy import guarded_urlopen

    req = _llm_request(ws, payload)
    try:
        with guarded_urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as err:
        raise EngineError(
            ErrorCode.REMOTE_BAD_REQUEST if err.code < 500 else ErrorCode.REMOTE_REMOTE_ERROR,
            f"Error from the chat LLM: {err.code} {err.reason}",
        )
    except Exception as err:
        raise EngineError(
            ErrorCode.REMOTE_COULD_NOT_SEND_REQUEST,
            f"Could not reach the chat LLM: {err}",
        )


def _run_search_tool(scheduler, arguments: str) -> str:
    from ..search.perform import perform_search

    try:
        params = json.loads(arguments)
        index_uid = params["index_uid"]
        q = params.get("q") or ""
    except Exception as err:
        return json.dumps({"error": f"invalid tool arguments: {err}"})
    try:
        store = scheduler.index(index_uid)
        res = perform_search(store, {"q": q, "limit": 20})
        return json.dumps({"documents": res["hits"]}, ensure_ascii=False, default=str)
    except EngineError as err:
        return json.dumps({"error": err.message})


def execute_chat_completion(scheduler, workspace: dict, body: dict) -> dict:
    """Runs the tool-call loop; returns the final OpenAI-style response."""
    prompts = workspace.get("prompts") or {}
    messages = list(body.get("messages") or [])
    system = prompts.get("system")
    if system and not any(m.get("role") == "system" for m in messages):
        messages.insert(0, {"role": "system", "content": system})

    tools = list(body.get("tools") or [])
    if any(
        (t.get("function") or {}).get("name") == SEARCH_IN_INDEX for t in tools
    ):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"{SEARCH_IN_INDEX} function is already defined.",
        )
    tools.append(_build_search_tool(scheduler, prompts))

    payload_base = {
        k: v
        for k, v in body.items()
        if k not in ("messages", "tools", "stream")
    }

    response = None
    for _ in range(MAX_TOOL_ROUNDS):
        payload = {**payload_base, "messages": messages, "tools": tools}
        response = _call_llm(workspace, payload)
        choice = (response.get("choices") or [{}])[0]
        message = choice.get("message") or {}
        tool_calls = [
            c
            for c in (message.get("tool_calls") or [])
            if (c.get("function") or {}).get("name") == SEARCH_IN_INDEX
        ]
        if not tool_calls:
            return response
        messages.append(message)
        for call in tool_calls:
            result = _run_search_tool(
                scheduler, (call.get("function") or {}).get("arguments", "{}")
            )
            messages.append(
                {
                    "role": "tool",
                    "tool_call_id": call.get("id"),
                    "content": result,
                }
            )
    return response


def _call_llm_stream(ws: dict, payload: dict):
    """Yield parsed chunk dicts from the upstream SSE stream."""
    import urllib.error

    from ..utils.http_policy import guarded_urlopen

    req = _llm_request(ws, payload)
    try:
        with guarded_urlopen(req, timeout=120) as resp:
            for raw in resp:
                line = raw.strip()
                if not line or not line.startswith(b"data:"):
                    continue
                data = line[5:].strip()
                if data == b"[DONE]":
                    return
                yield json.loads(data)
    except urllib.error.HTTPError as err:
        raise EngineError(
            ErrorCode.REMOTE_BAD_REQUEST if err.code < 500 else ErrorCode.REMOTE_REMOTE_ERROR,
            f"Error from the chat LLM: {err.code} {err.reason}",
        )


def execute_chat_completion_stream(scheduler, workspace: dict, body: dict):
    """Token-level SSE passthrough (reference: streamed branch of
    routes/chats/chat_completions.rs). Content deltas forward to the
    client AS THEY ARRIVE from upstream; tool-call deltas accumulate
    per index, run the `_meiliSearchInIndex` search between upstream
    streams, and the loop re-enters with the tool results appended.
    Yields SSE byte chunks, terminated by `data: [DONE]`."""
    prompts = workspace.get("prompts") or {}
    messages = list(body.get("messages") or [])
    system = prompts.get("system")
    if system and not any(m.get("role") == "system" for m in messages):
        messages.insert(0, {"role": "system", "content": system})
    tools = list(body.get("tools") or [])
    if any(
        (t.get("function") or {}).get("name") == SEARCH_IN_INDEX for t in tools
    ):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"{SEARCH_IN_INDEX} function is already defined.",
        )
    tools.append(_build_search_tool(scheduler, prompts))
    payload_base = {
        k: v for k, v in body.items() if k not in ("messages", "tools", "stream")
    }

    for _ in range(MAX_TOOL_ROUNDS):
        payload = {
            **payload_base,
            "messages": messages,
            "tools": tools,
            "stream": True,
        }
        tool_acc: dict[int, dict] = {}
        for chunk in _call_llm_stream(workspace, payload):
            choice = (chunk.get("choices") or [{}])[0]
            delta = choice.get("delta") or {}
            tcs = delta.get("tool_calls")
            if tcs:
                for tc in tcs:
                    acc = tool_acc.setdefault(
                        tc.get("index", 0),
                        {"id": None, "name": "", "arguments": ""},
                    )
                    if tc.get("id"):
                        acc["id"] = tc["id"]
                    fn = tc.get("function") or {}
                    acc["name"] += fn.get("name") or ""
                    acc["arguments"] += fn.get("arguments") or ""
                continue  # interpreted locally, not forwarded
            if delta.get("content") or delta.get("role") or choice.get(
                "finish_reason"
            ):
                yield (
                    f"data: {json.dumps(chunk, ensure_ascii=False)}\n\n".encode(
                        "utf-8"
                    )
                )
        calls = [
            a for a in tool_acc.values() if a["name"] == SEARCH_IN_INDEX
        ]
        if not calls:
            break
        messages.append(
            {
                "role": "assistant",
                "content": None,
                "tool_calls": [
                    {
                        "id": a["id"] or f"call_{i}",
                        "type": "function",
                        "function": {
                            "name": a["name"],
                            "arguments": a["arguments"],
                        },
                    }
                    for i, a in enumerate(calls)
                ],
            }
        )
        for a in calls:
            messages.append(
                {
                    "role": "tool",
                    "tool_call_id": a["id"],
                    "content": _run_search_tool(scheduler, a["arguments"]),
                }
            )
    yield b"data: [DONE]\n\n"


def sse_chunks(response: dict):
    """Renders a completed response as OpenAI-style SSE chunks."""
    choice = (response.get("choices") or [{}])[0]
    message = choice.get("message") or {}
    chunk = {
        "id": response.get("id", "chatcmpl-meili"),
        "object": "chat.completion.chunk",
        "model": response.get("model"),
        "choices": [
            {
                "index": 0,
                "delta": {
                    "role": message.get("role", "assistant"),
                    "content": message.get("content", ""),
                },
                "finish_reason": choice.get("finish_reason", "stop"),
            }
        ],
    }
    yield f"data: {json.dumps(chunk, ensure_ascii=False)}\n\n".encode("utf-8")
    yield b"data: [DONE]\n\n"
