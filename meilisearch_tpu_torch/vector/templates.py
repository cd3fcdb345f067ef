"""documentTemplate rendering — a liquid subset.

Reference: milli/src/prompt/mod.rs — each document is rendered to the text
that gets embedded, through a liquid template exposing `doc` (the document)
and `fields` (ordered {name, value, is_searchable} entries); the default
template (prompt/mod.rs:66-71) emits "name: value\n" per searchable non-nil
field; output is truncated to documentTemplateMaxBytes (default 400,
prompt/mod.rs:74).

This implements the template constructs those prompts actually use:
`{{ expr }}` output, `{% for x in expr %}`, `{% if cond %}/{% elsif %}/
{% else %}`, dotted paths, `==`/`!=` against literals and `nil`, `and`/`or`,
and the `truncatewords` / `default` filters.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from ..types.errors import EngineError, ErrorCode

DEFAULT_TEMPLATE = (
    "{% for field in fields %}"
    "{% if field.is_searchable and field.value != nil %}"
    "{{ field.name }}: {{ field.value }}\n"
    "{% endif %}"
    "{% endfor %}"
)
DEFAULT_MAX_BYTES = 400

_NIL = object()


class TemplateError(EngineError):
    def __init__(self, message: str):
        super().__init__(ErrorCode.INVALID_EMBEDDER, message)


# -- parsing ----------------------------------------------------------------


def _lex(text: str) -> list[tuple[str, str]]:
    """Split into ("text", s) / ("out", expr) / ("tag", content) tokens."""
    out = []
    i = 0
    while i < len(text):
        jo = text.find("{{", i)
        jt = text.find("{%", i)
        if jo == -1 and jt == -1:
            out.append(("text", text[i:]))
            break
        j = min(x for x in (jo, jt) if x != -1)
        if j > i:
            out.append(("text", text[i:j]))
        if j == jo:
            end = text.find("}}", j)
            if end == -1:
                raise TemplateError("unterminated `{{` in documentTemplate")
            out.append(("out", text[j + 2 : end].strip()))
            i = end + 2
        else:
            end = text.find("%}", j)
            if end == -1:
                raise TemplateError("unterminated `{%` in documentTemplate")
            out.append(("tag", text[j + 2 : end].strip()))
            i = end + 2
    return out


def _parse(tokens: list, i: int, until: tuple) -> tuple[list, int, Optional[str]]:
    """Parses a node list until one of the `until` tags; returns
    (nodes, next_index, stop_tag)."""
    nodes: list = []
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "text":
            nodes.append(("text", val))
            i += 1
        elif kind == "out":
            nodes.append(("out", val))
            i += 1
        else:
            word = val.split(None, 1)[0] if val else ""
            if word in until:
                return nodes, i, val
            if word == "for":
                rest = val[3:].strip()
                if " in " not in rest:
                    raise TemplateError(f"invalid for tag `{val}`")
                var, _, expr = rest.partition(" in ")
                body, i, stop = _parse(tokens, i + 1, ("endfor",))
                if stop is None:
                    raise TemplateError("missing {% endfor %}")
                nodes.append(("for", var.strip(), expr.strip(), body))
                i += 1
            elif word == "if":
                branches = []
                cond = val[2:].strip()
                body, i, stop = _parse(tokens, i + 1, ("elsif", "else", "endif"))
                branches.append((cond, body))
                while stop is not None and stop.split(None, 1)[0] == "elsif":
                    cond = stop[5:].strip()
                    body, i, stop = _parse(
                        tokens, i + 1, ("elsif", "else", "endif")
                    )
                    branches.append((cond, body))
                if stop is not None and stop.split(None, 1)[0] == "else":
                    body, i, stop = _parse(tokens, i + 1, ("endif",))
                    branches.append((None, body))
                if stop is None:
                    raise TemplateError("missing {% endif %}")
                nodes.append(("if", branches))
                i += 1
            else:
                raise TemplateError(
                    f"unsupported tag `{word}` in documentTemplate"
                )
    return nodes, i, None


# -- evaluation ---------------------------------------------------------------


def _lookup(path: str, ctx: dict) -> Any:
    path = path.strip()
    if path == "nil" or path == "null":
        return None
    if path in ("true", "false"):
        return path == "true"
    if (path.startswith('"') and path.endswith('"')) or (
        path.startswith("'") and path.endswith("'")
    ):
        return path[1:-1]
    try:
        return float(path) if "." in path else int(path)
    except ValueError:
        pass
    cur: Any = ctx
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return _NIL
    return cur


def _apply_filters(value: Any, filters: list[str], ctx: dict) -> Any:
    for f in filters:
        name, _, arg = f.partition(":")
        name = name.strip()
        arg = arg.strip()
        if name == "truncatewords":
            n = int(arg.split(",")[0]) if arg else 15
            words = _stringify(value).split()
            value = " ".join(words[:n]) + ("..." if len(words) > n else "")
        elif name == "default":
            if value is _NIL or value is None or value == "":
                value = _lookup(arg, ctx)
        elif name == "json":
            value = json.dumps(None if value is _NIL else value)
        else:
            raise TemplateError(
                f"unsupported filter `{name}` in documentTemplate"
            )
    return value


def _eval_expr(expr: str, ctx: dict) -> Any:
    parts = [p.strip() for p in expr.split("|")]
    value = _lookup(parts[0], ctx)
    return _apply_filters(value, parts[1:], ctx)


def _truthy(v: Any) -> bool:
    # liquid truthiness: only nil and false are falsy
    return not (v is _NIL or v is None or v is False)


def _eval_cond(cond: str, ctx: dict) -> bool:
    for part in cond.split(" or "):
        ok = True
        for sub in part.split(" and "):
            sub = sub.strip()
            if "!=" in sub:
                l, _, r = sub.partition("!=")
                ok = ok and _cmp(l, ctx) != _cmp(r, ctx)
            elif "==" in sub:
                l, _, r = sub.partition("==")
                ok = ok and _cmp(l, ctx) == _cmp(r, ctx)
            else:
                ok = ok and _truthy(_eval_expr(sub, ctx))
            if not ok:
                break
        if ok:
            return True
    return False


def _cmp(expr: str, ctx: dict) -> Any:
    v = _eval_expr(expr.strip(), ctx)
    return None if v is _NIL else v


def _stringify(v: Any) -> str:
    if v is _NIL or v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v, ensure_ascii=False)
    return str(v)


def _render_nodes(nodes: list, ctx: dict, out: list) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "out":
            out.append(_stringify(_eval_expr(node[1], ctx)))
        elif kind == "for":
            _, var, expr, body = node
            seq = _eval_expr(expr, ctx)
            if seq is _NIL or seq is None:
                continue
            for item in seq:
                sub = dict(ctx)
                sub[var] = item
                _render_nodes(body, sub, out)
        elif kind == "if":
            for cond, body in node[1]:
                if cond is None or _eval_cond(cond, ctx):
                    _render_nodes(body, ctx, out)
                    break


_SKIP = object()


def _render_fragment_string(text: str, ctx: dict):
    tokens = _lex(text)
    if len(tokens) == 1 and tokens[0][0] == "out":
        # a pure-placeholder string keeps the VALUE type, so media objects
        # (image payloads, arrays) pass through intact — the reference's
        # InjectableValue placeholder semantics (vector/json_template/)
        v = _eval_expr(tokens[0][1], ctx)
        return _SKIP if v is _NIL or v is None else v
    for kind, expr in tokens:
        if kind == "out":
            v = _eval_expr(expr, ctx)
            if v is _NIL or v is None:
                return _SKIP
    return Template(text).render(ctx)


def _render_fragment_value(value: Any, ctx: dict):
    if isinstance(value, str):
        if "{{" in value or "{%" in value:
            return _render_fragment_string(value, ctx)
        return value
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            r = _render_fragment_value(v, ctx)
            if r is _SKIP:
                return _SKIP
            out[k] = r
        return out
    if isinstance(value, list):
        out_list = []
        for v in value:
            r = _render_fragment_value(v, ctx)
            if r is _SKIP:
                return _SKIP
            out_list.append(r)
        return out_list
    return value


def render_json_fragment(value: Any, doc=None, media=None, q=None):
    """Render one indexing/search fragment (reference: JsonTemplate,
    vector/json_template/mod.rs): every string in the JSON value renders as
    a template over `doc` / `media` / `q`; if ANY placeholder resolves to
    nothing the whole fragment is skipped (returns None) — that is how a
    multimodal embedder config gets 'only the fragments whose media are
    present' behavior at both index and search time."""
    ctx: dict = {"doc": doc or {}, "media": media or {}}
    if q is not None:
        ctx["q"] = q
    out = _render_fragment_value(value, ctx)
    return None if out is _SKIP else out


class Template:
    def __init__(self, text: str):
        self.nodes, _, stop = _parse(_lex(text), 0, ())
        if stop is not None:
            raise TemplateError(f"unexpected `{stop}` in documentTemplate")

    def render(self, ctx: dict) -> str:
        out: list[str] = []
        _render_nodes(self.nodes, ctx, out)
        return "".join(out)


_template_cache: dict[str, Template] = {}


def render_document_template(
    template_text: Optional[str],
    doc: dict,
    searchable: Optional[set] = None,
    max_bytes: Optional[int] = None,
) -> str:
    """Render one document to its embedding text (milli Prompt::render)."""
    text = template_text or DEFAULT_TEMPLATE
    tpl = _template_cache.get(text)
    if tpl is None:
        tpl = Template(text)
        if len(_template_cache) < 256:
            _template_cache[text] = tpl
    fields = []
    for name, value in doc.items():
        if name.startswith("_"):
            continue
        fields.append(
            {
                "name": name,
                "value": value,
                "is_searchable": searchable is None or name in searchable,
            }
        )
    rendered = tpl.render({"doc": doc, "fields": fields})
    limit = max_bytes if max_bytes is not None else DEFAULT_MAX_BYTES
    data = rendered.encode("utf-8")
    if len(data) > limit:
        data = data[:limit]
        rendered = data.decode("utf-8", errors="ignore")
    return rendered
