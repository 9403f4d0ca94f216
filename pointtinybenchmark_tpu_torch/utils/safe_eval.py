"""Whitelisted evaluation of config-supplied expression strings.

The port's own copy of pointtinybenchmark_tpu/utils/safe_eval.py
(`safe_eval_expr`, `safe_eval_lambda`), for the location evaluator's
`recThrs` strings such as 'np.linspace(.0, 1.00, 101)' and the tiny COCO
evaluation's `iod_th_of_iou_f` such as 'lambda iou: iou': the string is
parsed with `ast` and only a fixed arithmetic subset is admitted (numeric
literals, min / max / abs and a few numpy functions, arithmetic,
comparisons and conditionals, tuples and lists); anything else raises
ValueError.
"""
from __future__ import annotations

import ast
from typing import Callable, Sequence

import numpy as np

__all__ = ["safe_eval_expr", "safe_eval_lambda"]

_ALLOWED_BUILTINS = {"min": min, "max": max, "abs": abs, "float": float,
                     "int": int, "round": round}
_ALLOWED_NP = {"linspace", "arange", "array", "log", "exp", "sqrt",
               "clip", "minimum", "maximum", "pi", "inf"}

_ALLOWED_BINOPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod,
                   ast.FloorDiv)
_ALLOWED_UNARY = (ast.UAdd, ast.USub, ast.Not)
_ALLOWED_CMP = (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq)


def _validate(node: ast.AST, arg_names: frozenset) -> None:
    if isinstance(node, ast.Expression):
        _validate(node.body, arg_names)
    elif isinstance(node, ast.Constant):
        if not isinstance(node.value, (int, float, bool)):
            raise ValueError(f"disallowed constant {node.value!r}")
    elif isinstance(node, ast.Name):
        if node.id not in arg_names and node.id not in _ALLOWED_BUILTINS:
            raise ValueError(f"disallowed name {node.id!r}")
    elif isinstance(node, ast.BinOp):
        if not isinstance(node.op, _ALLOWED_BINOPS):
            raise ValueError("disallowed operator")
        _validate(node.left, arg_names)
        _validate(node.right, arg_names)
    elif isinstance(node, ast.UnaryOp):
        if not isinstance(node.op, _ALLOWED_UNARY):
            raise ValueError("disallowed unary operator")
        _validate(node.operand, arg_names)
    elif isinstance(node, ast.BoolOp):
        for v in node.values:
            _validate(v, arg_names)
    elif isinstance(node, ast.Compare):
        for op in node.ops:
            if not isinstance(op, _ALLOWED_CMP):
                raise ValueError("disallowed comparison")
        _validate(node.left, arg_names)
        for c in node.comparators:
            _validate(c, arg_names)
    elif isinstance(node, ast.IfExp):
        _validate(node.test, arg_names)
        _validate(node.body, arg_names)
        _validate(node.orelse, arg_names)
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            _validate(e, arg_names)
    elif isinstance(node, ast.Attribute):
        if not (isinstance(node.value, ast.Name) and node.value.id == "np"
                and node.attr in _ALLOWED_NP):
            raise ValueError(f"disallowed attribute {ast.dump(node)}")
    elif isinstance(node, ast.Call):
        if node.keywords:
            for kw in node.keywords:
                if kw.arg is None:  # **kwargs
                    raise ValueError("disallowed **kwargs")
                _validate(kw.value, arg_names)
        _validate(node.func, arg_names)
        if not (isinstance(node.func, ast.Attribute)
                or (isinstance(node.func, ast.Name)
                    and node.func.id in _ALLOWED_BUILTINS)):
            raise ValueError("disallowed call target")
        for a in node.args:
            _validate(a, arg_names)
    else:
        raise ValueError(f"disallowed syntax {type(node).__name__}")


class _SafeNp:
    """np namespace restricted to the whitelist (no dunder escape)."""

    def __getattr__(self, name):
        if name in _ALLOWED_NP:
            return getattr(np, name)
        raise AttributeError(name)


def _compile(expr: str, arg_names: Sequence[str] = ()):
    tree = ast.parse(expr, mode="eval")
    _validate(tree, frozenset(arg_names))
    code = compile(tree, "<safe_eval>", "eval")
    glb = {"__builtins__": {}, "np": _SafeNp(), **_ALLOWED_BUILTINS}
    return code, glb


def safe_eval_expr(expr: str):
    """Evaluate a whitelisted arithmetic/numpy expression string."""
    code, glb = _compile(expr)
    return eval(code, glb)  # noqa: S307 — AST-validated whitelist


def safe_eval_lambda(expr: str) -> Callable:
    """Parse ``"lambda x[, y...]: <arith>"`` into a callable; only the
    lambda's own arguments and the whitelist may appear in its body."""
    tree = ast.parse(expr, mode="eval")
    if not isinstance(tree.body, ast.Lambda):
        raise ValueError("expected a lambda expression")
    a = tree.body.args
    if (a.posonlyargs or a.kwonlyargs or a.vararg or a.kwarg or a.defaults
            or a.kw_defaults):
        raise ValueError("only plain positional lambda args allowed")
    _validate(tree.body.body, frozenset(arg.arg for arg in a.args))
    code = compile(tree, "<safe_eval>", "eval")
    glb = {"__builtins__": {}, "np": _SafeNp(), **_ALLOWED_BUILTINS}
    return eval(code, glb)  # noqa: S307 — AST-validated whitelist
