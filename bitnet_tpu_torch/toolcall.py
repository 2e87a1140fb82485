"""OpenAI-style tool / function calling over grammar-constrained decoding.

Counterpart of ``bitnet_tpu/toolcall.py``, a copy over the port's
``grammar`` and ``templates``.

The reference has no tool-calling support anywhere (BitNet-rs serves
plain completions only); this module implements the OpenAI ``tools`` /
``tool_choice`` chat protocol the "generic" way (llama.cpp's fallback
style for models without native tool tokens):

1. The available tools are rendered into a system instruction telling
   the model to answer a call with exactly
   ``{"name": <function>, "arguments": <object>}``.
2. When ``tool_choice`` is ``"required"`` or names a function, output
   is *grammar-constrained* to precisely that JSON shape — the
   arguments object is compiled from the tool's JSON-schema
   ``parameters`` via :func:`bitnet_tpu_torch.grammar.json_schema_grammar`,
   so an ill-formed call is unrepresentable.
3. Assistant output that parses as a call is returned as OpenAI
   ``message.tool_calls`` with ``finish_reason="tool_calls"``; under
   ``"auto"`` the model may also answer in plain text.

Used by ``serve/server.py`` (/v1/chat/completions).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from .errors import ConfigError
from .grammar import json_schema_grammar
from .templates import Message

__all__ = [
    "ToolCallError",
    "normalize_tool_messages",
    "parse_tool_calls",
    "tool_choice_grammar",
    "tools_system_text",
    "validate_tools",
]


class ToolCallError(ConfigError):
    """Malformed ``tools`` / ``tool_choice`` request fields."""


def validate_tools(tools: Any, tool_choice: Any = None) -> list[dict]:
    """Validate the OpenAI ``tools`` array; returns the function specs."""
    if not isinstance(tools, list) or not tools:
        raise ToolCallError("tools must be a non-empty array")
    fns = []
    names = set()
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function" \
                or not isinstance(t.get("function"), dict):
            raise ToolCallError(
                'each tool must be {"type": "function", "function": {...}}')
        fn = t["function"]
        name = fn.get("name")
        if not isinstance(name, str) or not name:
            raise ToolCallError("tool function.name must be a string")
        if name in names:
            raise ToolCallError(f"duplicate tool name {name!r}")
        names.add(name)
        params = fn.get("parameters", {"type": "object"})
        if not isinstance(params, dict):
            raise ToolCallError("tool function.parameters must be an object")
        fns.append({"name": name,
                    "description": fn.get("description", ""),
                    "parameters": params})
    if tool_choice is not None and not (
            tool_choice in ("auto", "none", "required")
            or (isinstance(tool_choice, dict)
                and tool_choice.get("type") == "function"
                and isinstance(tool_choice.get("function"), dict)
                and isinstance(tool_choice["function"].get("name"), str))):
        raise ToolCallError(
            "tool_choice must be 'auto' | 'none' | 'required' | "
            '{"type": "function", "function": {"name": ...}}')
    if isinstance(tool_choice, dict):
        want = tool_choice["function"]["name"]
        if want not in names:
            raise ToolCallError(f"tool_choice names unknown tool {want!r}")
    return fns


def tools_system_text(fns: list[dict]) -> str:
    """System instruction describing the callable functions."""
    lines = [
        "You can call the following functions. To call one, respond with "
        'ONLY a JSON object of the form {"name": <function-name>, '
        '"arguments": <arguments-object>} and no other text.',
        "Available functions:",
    ]
    for f in fns:
        desc = f" — {f['description']}" if f["description"] else ""
        lines.append(f"- {f['name']}{desc}")
        lines.append(f"  parameters (JSON schema): "
                     f"{json.dumps(f['parameters'], sort_keys=True)}")
    return "\n".join(lines)


def _call_schema(fn: dict) -> dict:
    return {
        "type": "object",
        "properties": {"name": {"const": fn["name"]},
                       "arguments": fn["parameters"]},
        "required": ["name", "arguments"],
        "additionalProperties": False,
    }


def tool_choice_grammar(fns: list[dict], tool_choice: Any) -> Optional[str]:
    """GBNF source forcing a call (``required`` / named function), or
    None when the model may answer freely (``auto``)."""
    if tool_choice == "required":
        return json_schema_grammar(
            {"anyOf": [_call_schema(f) for f in fns]})
    if isinstance(tool_choice, dict):
        want = tool_choice["function"]["name"]
        fn = next(f for f in fns if f["name"] == want)
        return json_schema_grammar(_call_schema(fn))
    return None


def normalize_tool_messages(messages: list[dict],
                            fns: list[dict]) -> list[Message]:
    """OpenAI chat messages (incl. ``tool`` role and assistant
    ``tool_calls`` turns) → template-family messages, with the tools
    instruction merged into the system turn."""
    out: list[Message] = []
    sys_text = tools_system_text(fns) if fns else None
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content") or ""
        if role == "system" and sys_text is not None:
            content = (content + "\n\n" + sys_text).strip()
            sys_text = None
        elif role == "tool":
            # families only know system/user/assistant: feed results back
            # as a user-visible tool-result block (generic style)
            name = m.get("name", "tool")
            role, content = "user", f"[{name} result]\n{content}"
        elif role == "assistant" and m.get("tool_calls"):
            # client-controlled history: tolerate malformed entries
            # (missing name, broken arguments JSON) instead of 500ing
            calls = []
            for c in m["tool_calls"]:
                fn = c.get("function") if isinstance(c, dict) else None
                if not isinstance(fn, dict) or not fn.get("name"):
                    continue
                args = fn.get("arguments", {})
                if isinstance(args, str):
                    try:
                        args = json.loads(args)
                    except ValueError:
                        pass                # keep the raw string verbatim
                calls.append({"name": fn["name"], "arguments": args})
            content = "\n".join(json.dumps(c) for c in calls)
        out.append(Message(role, content))
    if sys_text is not None:
        out.insert(0, Message("system", sys_text))
    return out


def parse_tool_calls(text: str, fns: list[dict]) -> Optional[list[dict]]:
    """Parse assistant output as tool calls; None when it is plain text.

    Returns OpenAI ``tool_calls`` entries (arguments re-serialized as a
    JSON string, as the OpenAI API does).
    """
    s = text.strip()
    if not s.startswith("{"):
        return None
    try:
        doc = json.loads(s)
    except ValueError:
        return None
    if not (isinstance(doc, dict) and isinstance(doc.get("name"), str)
            and isinstance(doc.get("arguments"), dict)):
        return None
    if doc["name"] not in {f["name"] for f in fns}:
        return None
    return [{
        "id": f"call_{abs(hash(s)) % 10**8:08d}",
        "type": "function",
        "function": {"name": doc["name"],
                     "arguments": json.dumps(doc["arguments"])},
    }]
