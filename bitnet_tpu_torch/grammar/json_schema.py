"""JSON-schema → GBNF compiler (structured-output serving); a copy of
``bitnet_tpu/grammar/json_schema.py`` that emits the same GBNF text.

Covers the subset modern OpenAI-compatible servers enforce for
``response_format={"type": "json_schema"}``: object properties
(+required, additionalProperties:false semantics), arrays (items,
minItems/maxItems), string / integer / number / boolean / null, enum,
const, anyOf/oneOf, and local ``$ref``s into ``$defs`` / ``definitions``.
Unsupported keywords raise :class:`GrammarError` rather than silently
over-generating.

The emitted grammar is deliberately strict-JSON: no trailing commas,
object keys in declaration order (required and optional interleaved as
declared — optional properties may be omitted), standard string escapes.
"""

from __future__ import annotations

import json
import re

from .gbnf import GrammarError

# whitespace: keep it tight (single optional spaces/newlines) so decoded
# output can't pad forever inside "whitespace"
_PRELUDE = r"""
ws ::= [ \t\n]{0,4}
string ::= "\"" char* "\""
char ::= [^"\\\x00-\x1f] | "\\" escape
escape ::= ["\\/bfnrt] | "u" hex hex hex hex
hex ::= [0-9a-fA-F]
integer ::= "-"? ("0" | [1-9] [0-9]{0,15})
number ::= integer frac? exp?
frac ::= "." [0-9]{1,16}
exp ::= [eE] [-+]? [0-9]{1,4}
boolean ::= "true" | "false"
null ::= "null"
"""

# the fully-generic JSON value grammar (response_format json_object)
JSON_GRAMMAR = _PRELUDE + r"""
root ::= ws value ws
value ::= object | array | string | number | boolean | null
object ::= "{" ws ( member ( "," ws member )* )? "}"
member ::= string ws ":" ws value ws
array ::= "[" ws ( value ws ( "," ws value ws )* )? "]"
"""


def _lit(text: str) -> str:
    """A JSON value as a GBNF literal."""
    out = []
    for ch in text:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\t":
            out.append("\\t")
        elif ord(ch) < 0x20:
            out.append(f"\\x{ord(ch):02x}")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9-]")


class _Compiler:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {}
        self.counter = 0
        self.ref_cache: dict[str, str] = {}

    def compile(self) -> str:
        root = self.visit(self.schema, "root0")
        lines = [f"root ::= ws {root} ws"]
        for name, body in self.rules.items():
            lines.append(f"{name} ::= {body}")
        return "\n".join(lines) + "\n" + _PRELUDE

    def _rule(self, hint: str, body: str) -> str:
        name = _NAME_SANITIZE.sub("-", hint) or "r"
        if name[0].isdigit():
            name = "r" + name
        while name in self.rules:
            self.counter += 1
            name = f"{name}{self.counter}"
        self.rules[name] = body
        return name

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise GrammarError(f"only local $refs supported, got {ref!r}")
        node: object = self.schema
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if not isinstance(node, dict) or part not in node:
                raise GrammarError(f"unresolvable $ref {ref!r}")
            node = node[part]
        if not isinstance(node, dict):
            raise GrammarError(f"$ref {ref!r} is not a schema object")
        return node

    # ------------------------------------------------------------------
    def visit(self, schema: dict, hint: str) -> str:
        """Return a GBNF *expression* (rule name or inline literal)."""
        if not isinstance(schema, dict):
            raise GrammarError(f"schema node must be an object: {schema!r}")
        if "$ref" in schema:
            ref = schema["$ref"]
            if ref in self.ref_cache:
                return self.ref_cache[ref]
            # pre-register to terminate recursive schemas
            name = self._rule(hint + "-ref", "null")
            self.ref_cache[ref] = name
            body_expr = self.visit(self._resolve_ref(ref), hint + "-def")
            self.rules[name] = body_expr
            return name
        if "const" in schema:
            return self._rule(hint, _lit(json.dumps(schema["const"])))
        if "enum" in schema:
            alts = " | ".join(_lit(json.dumps(v)) for v in schema["enum"])
            return self._rule(hint, alts)
        for key in ("anyOf", "oneOf"):
            if key in schema:
                alts = " | ".join(
                    self.visit(s, f"{hint}-alt{i}")
                    for i, s in enumerate(schema[key]))
                return self._rule(hint, alts)

        t = schema.get("type")
        if isinstance(t, list):
            alts = " | ".join(
                self.visit({**schema, "type": ti}, f"{hint}-{ti}")
                for ti in t)
            return self._rule(hint, alts)
        if t == "string":
            return self._string(schema, hint)
        if t == "integer":
            return "integer"
        if t == "number":
            return "number"
        if t == "boolean":
            return "boolean"
        if t == "null":
            return "null"
        if t == "object" or "properties" in schema:
            return self._object(schema, hint)
        if t == "array":
            return self._array(schema, hint)
        if t is None:
            # unconstrained: generic JSON value
            self.rules.setdefault(
                "value", "object | array | string | number | boolean | null")
            self.rules.setdefault(
                "object",
                '"{" ws ( member ( "," ws member )* )? "}"')
            self.rules.setdefault(
                "member", 'string ws ":" ws value ws')
            self.rules.setdefault(
                "array", '"[" ws ( value ws ( "," ws value ws )* )? "]"')
            return "value"
        raise GrammarError(f"unsupported schema type {t!r}")

    def _string(self, schema: dict, hint: str) -> str:
        unsupported = {"pattern", "format", "minLength", "maxLength"} \
            & schema.keys()
        if "pattern" in unsupported or "format" in unsupported:
            raise GrammarError(
                "string pattern/format constraints are not supported")
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is None and hi is None:
            return "string"
        lo = int(lo or 0)
        rep = f"{{{lo},{int(hi)}}}" if hi is not None else f"{{{lo},}}"
        return self._rule(hint, f'"\\"" char{rep} "\\""')

    def _object(self, schema: dict, hint: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        unknown = required - set(props)
        if unknown:
            raise GrammarError(
                f"required names missing from properties: {sorted(unknown)}")
        if not props:
            if schema.get("additionalProperties") is False:
                return self._rule(hint, '"{" ws "}"')
            self.rules.setdefault(
                "value", "object | array | string | number | boolean | null")
            self.rules.setdefault(
                "object", '"{" ws ( member ( "," ws member )* )? "}"')
            self.rules.setdefault("member", 'string ws ":" ws value ws')
            self.rules.setdefault(
                "array", '"[" ws ( value ws ( "," ws value ws )* )? "]"')
            return "object"

        # members in declaration order; optional ones may be skipped.
        # Build as a chain of alternatives: each suffix rule emits the
        # remaining members (with its leading comma handled by position).
        member_exprs = []
        for pname, pschema in props.items():
            val = self.visit(pschema, f"{hint}-{pname}")
            member_exprs.append(
                (pname in required,
                 f'{_lit(json.dumps(pname))} ws ":" ws {val}'))

        # kv{i} ::= member_i;  tail rules: rest{i} matches members i.. with
        # leading ", " before each emitted member
        kv_names = [self._rule(f"{hint}-kv{i}", expr)
                    for i, (_, expr) in enumerate(member_exprs)]
        n = len(kv_names)

        # rest(i): members i..n-1, each optional unless required, each
        # preceded by "," (used after at least one member was emitted)
        rest_names: list[str] = [""] * (n + 1)
        rest_names[n] = self._rule(f"{hint}-rest{n}", '""')
        for i in range(n - 1, -1, -1):
            req = member_exprs[i][0]
            with_me = f'"," ws {kv_names[i]} ws {rest_names[i + 1]}'
            body = with_me if req else f"{with_me} | {rest_names[i + 1]}"
            rest_names[i] = self._rule(f"{hint}-rest{i}", body)

        # first(i): members i..n-1 where member i is the FIRST emitted
        # (no leading comma); empty object allowed iff nothing required
        first_alts = []
        for i in range(n):
            first_alts.append(f"{kv_names[i]} ws {rest_names[i + 1]}")
            if member_exprs[i][0]:
                break            # a required member can't be skipped
        else:
            first_alts.append('""')   # all optional → may be empty
        first = self._rule(f"{hint}-members", " | ".join(first_alts))
        return self._rule(hint, f'"{{" ws {first} "}}"')

    def _array(self, schema: dict, hint: str) -> str:
        items = self.visit(schema.get("items", {}), f"{hint}-item")
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is not None and int(hi) < lo:
            raise GrammarError("maxItems < minItems")
        if lo == 0 and hi is None:
            body = f'"[" ws ( {items} ws ( "," ws {items} ws )* )? "]"'
        else:
            rep = (f"{{{max(lo - 1, 0)},{int(hi) - 1}}}" if hi is not None
                   else f"{{{max(lo - 1, 0)},}}")
            more = f'( "," ws {items} ws ){rep}'
            inner = f"{items} ws {more}"
            if lo == 0:
                inner = f"( {inner} )?"
            body = f'"[" ws {inner} "]"'
        return self._rule(hint, body)


def json_schema_grammar(schema: dict | str) -> str:
    """Compile a JSON schema (dict or JSON text) to GBNF source."""
    if isinstance(schema, str):
        try:
            schema = json.loads(schema)
        except json.JSONDecodeError as e:
            raise GrammarError(f"schema is not valid JSON: {e}") from None
    return _Compiler(schema).compile()
