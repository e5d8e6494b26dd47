"""Sandboxed expression scripting — the painless analog.

The reference sandboxes scripts by compiling a custom language to JVM
bytecode against per-context allowlists (ref: modules/lang-painless
Compiler.java, ScriptContext allowlists). Without a JVM the TPU build gets
the same guarantee by *structural* sandboxing: scripts are parsed with
Python's `ast` module and only an explicitly allowlisted node set is
interpreted — no attribute access, no calls except allowlisted functions,
no imports, no subscripts except on provided mappings, no comprehensions.
Everything else raises at compile time, like painless' compile-time
allowlist errors.

Contexts (score, aggs, update, ingest, …) differ only in the variables they
bind (`_score`, `doc`, `ctx`, `params`, bucket paths), matching the
reference's ScriptContext design (ref: script/ScriptContext.java).

The port's copy of elasticsearch_tpu/script/expressions.py, as it is (the
`bucket_script` and `bucket_selector` pipelines compile with it).
"""

from __future__ import annotations

import ast
import math
import re
from typing import Any, Callable, Dict, Mapping

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError


class ScriptException(ElasticsearchTpuError):
    status = 400
    error_type = "script_exception"


_ALLOWED_FUNCS: Dict[str, Callable] = {
    "abs": abs, "min": min, "max": max, "round": round, "len": len,
    "floor": math.floor, "ceil": math.ceil, "sqrt": math.sqrt,
    "log": math.log, "log10": math.log10, "exp": math.exp,
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "saturation": lambda v, k: v / (v + k),
    "sigmoid": lambda v, k, a: v ** a / (k ** a + v ** a),
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.IfExp, ast.Constant, ast.Name, ast.Load, ast.Call, ast.Subscript,
    ast.Index, ast.Tuple, ast.List,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
    ast.Attribute,  # validated separately: only .value / .length on doc fields
)

_ALLOWED_ATTRS = {"value", "values", "length", "empty"}


def _safe_pow(a, b):
    """Bounded exponentiation: painless-style compute limiting — an eval'd
    expression cannot be interrupted, so astronomically-large powers are
    rejected up front."""
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        if abs(b) > 1024 or (isinstance(a, int) and abs(a) > 1 and abs(b) > 256):
            raise ScriptException("power operand too large")
    return a ** b


def _safe_mult(a, b):
    """Bounded multiplication: rejects huge sequence repetition."""
    for seq, n in ((a, b), (b, a)):
        if isinstance(seq, (str, list, tuple)) and isinstance(n, int):
            if len(seq) * max(n, 0) > 100_000:
                raise ScriptException("sequence repetition too large")
    return a * b


# pow() must go through the same compute bound as the ** operator — the raw
# builtin would let pow(2, 10**9) bypass the _GuardOps rewrite entirely
_ALLOWED_FUNCS["pow"] = _safe_pow


class _GuardOps(ast.NodeTransformer):
    """Rewrite Pow/Mult into guarded calls at compile time."""

    _MAP = {ast.Pow: "__safe_pow__", ast.Mult: "__safe_mult__"}

    def visit_BinOp(self, node):
        self.generic_visit(node)
        fname = self._MAP.get(type(node.op))
        if fname is None:
            return node
        return ast.copy_location(
            ast.Call(func=ast.Name(id=fname, ctx=ast.Load()),
                     args=[node.left, node.right], keywords=[]), node)


class _AttrDict(dict):
    """params dict supporting both params['x'] and painless params.x."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise ScriptException(f"missing script parameter [{name}]") from None


_STRING_RE = re.compile(r"'[^']*'|\"[^\"]*\"")


def _normalize_code(code: str) -> str:
    for pat, py in ((r"&&", " and "), (r"\|\|", " or "), (r"!(?!=)", " not "),
                    (r"\?:", " or "), (r"\bnull\b", "None"), (r"\btrue\b", "True"),
                    (r"\bfalse\b", "False"), (r"\bMath\.", "")):
        code = re.sub(pat, py, code)
    return code


def _normalize(source: str) -> str:
    """Translate the painless-isms that appear in common scripts.

    Rewrites only code outside string literals, on word boundaries, so field
    names or strings containing e.g. "null" are untouched.
    """
    src = source.strip().rstrip(";")
    out = []
    last = 0
    for m in _STRING_RE.finditer(src):
        out.append(_normalize_code(src[last: m.start()]))
        out.append(m.group(0))
        last = m.end()
    out.append(_normalize_code(src[last:]))
    return "".join(out)


class ExpressionScript:
    """A compiled, structurally-sandboxed expression."""

    def __init__(self, source: str):
        self.source = source
        normalized = _normalize(source)
        try:
            tree = ast.parse(normalized, mode="eval")
        except SyntaxError as e:
            raise ScriptException(f"compile error in script [{source}]: {e}") from None
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ScriptException(
                    f"illegal construct [{type(node).__name__}] in script [{source}]")
            if isinstance(node, ast.Attribute) and node.attr not in _ALLOWED_ATTRS:
                # painless params.x is allowed; all other attributes are not
                if not (isinstance(node.value, ast.Name) and node.value.id == "params"):
                    raise ScriptException(
                        f"unknown attribute [.{node.attr}] in script [{source}]")
            if isinstance(node, ast.Call):
                if not isinstance(node.func, ast.Name) or node.func.id not in _ALLOWED_FUNCS:
                    raise ScriptException(
                        f"unknown function in script [{source}]")
        tree = ast.fix_missing_locations(_GuardOps().visit(tree))
        self._code = compile(tree, "<script>", "eval")

    def execute(self, variables: Mapping[str, Any] | None = None) -> Any:
        env: Dict[str, Any] = dict(_ALLOWED_FUNCS)
        env["None"] = None
        env["__safe_pow__"] = _safe_pow
        env["__safe_mult__"] = _safe_mult
        if variables:
            env.update(variables)
        if isinstance(env.get("params"), dict):
            env["params"] = _AttrDict(env["params"])
        try:
            return eval(self._code, {"__builtins__": {}}, env)  # noqa: S307 — AST-allowlisted
        except ScriptException:
            raise
        except Exception as e:  # noqa: BLE001 — runtime errors surface as script errors
            raise ScriptException(f"runtime error in script [{self.source}]: {e}") from None


class _DocField:
    """painless-style doc['field'] accessor."""

    __slots__ = ("_values",)

    def __init__(self, values):
        self._values = values if isinstance(values, list) else (
            [] if values is None else [values])

    @property
    def value(self):
        if not self._values:
            raise ScriptException("A document doesn't have a value for a field")
        return self._values[0]

    @property
    def values(self):
        return self._values

    @property
    def length(self):
        return len(self._values)

    @property
    def empty(self):
        return not self._values

    def __getitem__(self, i):
        return self._values[i]


def doc_map(field_values: Mapping[str, Any]) -> Dict[str, _DocField]:
    return {f: _DocField(v) for f, v in field_values.items()}


_cache: Dict[str, ExpressionScript] = {}


def compile_script(spec) -> ExpressionScript:
    """Compile {"source": ...} | str, with a compile cache
    (ref: script/ScriptService.java compile-rate limiting + cache)."""
    source = spec.get("source") if isinstance(spec, dict) else spec
    if not isinstance(source, str):
        raise ScriptException("script source must be a string")
    script = _cache.get(source)
    if script is None:
        script = ExpressionScript(source)
        if len(_cache) > 2048:
            _cache.clear()
        _cache[source] = script
    return script
