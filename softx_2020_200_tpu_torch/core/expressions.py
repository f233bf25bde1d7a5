"""muparser-compatible expression language, evaluated with PyTorch.

Counterpart of ``softx_2020_200_tpu.core.expressions``: the tokenizer and
the recursive-descent parser are the reference's, unchanged; the
evaluator runs over ``torch`` tensors, so expressions evaluate on the
device that holds the coordinates and differentiate under ``torch.func``
(the MMS source term).

Supported syntax:
  literals           1, 2.5, 1e-3
  constants          pi, e
  variables          x, y, z, t  (and any names supplied at evaluation)
  operators          + - * / ^ (power), unary -, comparison == != < > <= >=,
                     logical && ||, ternary via if(cond, then, else)
  functions          sin cos tan asin acos atan sinh cosh tanh exp log log2
                     log10 sqrt abs ceil floor sign min max pow atan2 if
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import torch

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>==|!=|<=|>=|&&|\|\||[-+*/^(),<>!])"
    r")"
)

_FUNCS_1 = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "ln": torch.log,
    "log2": torch.log2, "log10": torch.log10,
    "sqrt": torch.sqrt, "abs": torch.abs, "ceil": torch.ceil,
    "floor": torch.floor, "sign": torch.sign,
}
_FUNCS_2 = {
    "min": torch.minimum, "max": torch.maximum,
    "pow": torch.pow, "atan2": torch.atan2,
}
_CONSTANTS = {"pi": math.pi, "e": math.e}

def _tokenize(src: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise ValueError(f"cannot tokenize expression at: {rest!r}")
        pos = m.end()
        if m.lastgroup == "num":
            tokens.append(("num", m.group("num")))
        elif m.lastgroup == "name":
            tokens.append(("name", m.group("name")))
        else:
            tokens.append(("op", m.group("op")))
    tokens.append(("end", ""))
    return tokens


# AST nodes are tuples: ("num", v) ("var", name) ("call", fn_name, [args])
# ("bin", op, lhs, rhs) ("neg", arg)


class _Parser:
    """Pratt-style recursive-descent parser for the muparser grammar."""

    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, op: str) -> None:
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ValueError(f"expected {op!r}, got {val!r}")

    def parse(self):
        node = self.parse_or()
        if self.peek()[0] != "end":
            raise ValueError(f"trailing tokens at {self.peek()[1]!r}")
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek() == ("op", "||"):
            self.next()
            node = ("bin", "||", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_cmp()
        while self.peek() == ("op", "&&"):
            self.next()
            node = ("bin", "&&", node, self.parse_cmp())
        return node

    def parse_cmp(self):
        node = self.parse_addsub()
        while self.peek()[0] == "op" and self.peek()[1] in ("==", "!=", "<", ">", "<=", ">="):
            op = self.next()[1]
            node = ("bin", op, node, self.parse_addsub())
        return node

    def parse_addsub(self):
        node = self.parse_muldiv()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = ("bin", op, node, self.parse_muldiv())
        return node

    def parse_muldiv(self):
        node = self.parse_unary()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = ("bin", op, node, self.parse_unary())
        return node

    def parse_unary(self):
        if self.peek() == ("op", "-"):
            self.next()
            return ("neg", self.parse_unary())
        if self.peek() == ("op", "+"):
            self.next()
            return self.parse_unary()
        return self.parse_power()

    def parse_power(self):
        base = self.parse_atom()
        if self.peek() == ("op", "^"):
            self.next()
            # right-associative; binds tighter than unary minus on the rhs
            return ("bin", "^", base, self.parse_unary())
        return base

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", float(val))
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = [self.parse_or()]
                while self.peek() == ("op", ","):
                    self.next()
                    args.append(self.parse_or())
                self.expect(")")
                return ("call", val, args)
            if val in _CONSTANTS:
                return ("num", _CONSTANTS[val])
            return ("var", val)
        if kind == "op" and val == "(":
            node = self.parse_or()
            self.expect(")")
            return node
        raise ValueError(f"unexpected token {val!r}")


def _free_vars(node, out: set[str]) -> None:
    tag = node[0]
    if tag == "var":
        out.add(node[1])
    elif tag == "neg":
        _free_vars(node[1], out)
    elif tag == "bin":
        _free_vars(node[2], out)
        _free_vars(node[3], out)
    elif tag == "call":
        for a in node[2]:
            _free_vars(a, out)


def _tensor(v, like):
    """Python scalars -> tensors with the dtype/device of ``like``."""
    if torch.is_tensor(v):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _eval(node, env: Mapping[str, object], like):
    """Evaluate an AST node; ``like`` is a float tensor that fixes the
    dtype and device of constants that reach a torch function."""
    tag = node[0]
    if tag == "num":
        return node[1]
    if tag == "var":
        try:
            return env[node[1]]
        except KeyError:
            raise NameError(f"unknown variable {node[1]!r} in expression") from None
    if tag == "neg":
        return -_eval(node[1], env, like)
    if tag == "bin":
        op = node[1]
        lhs, rhs = _eval(node[2], env, like), _eval(node[3], env, like)
        if op == "+":
            return lhs + rhs
        if op == "-":
            return lhs - rhs
        if op == "*":
            return lhs * rhs
        if op == "/":
            return lhs / rhs
        if op == "^":
            if isinstance(rhs, float) and rhs == int(rhs):
                return lhs ** int(rhs)
            return torch.pow(_tensor(lhs, like), rhs)
        if op == "==":
            return (lhs == rhs)
        if op == "!=":
            return (lhs != rhs)
        if op == "<":
            return (lhs < rhs)
        if op == ">":
            return (lhs > rhs)
        if op == "<=":
            return (lhs <= rhs)
        if op == ">=":
            return (lhs >= rhs)
        if op == "&&":
            return torch.logical_and(_tensor(lhs, like), _tensor(rhs, like))
        if op == "||":
            return torch.logical_or(_tensor(lhs, like), _tensor(rhs, like))
        raise ValueError(f"unknown operator {op}")
    if tag == "call":
        name = node[1]
        args = [_eval(a, env, like) for a in node[2]]
        if name == "if":
            if len(args) != 3:
                raise ValueError("if() takes exactly 3 arguments")
            cond = _tensor(args[0], like)
            return torch.where(cond.to(torch.bool), _tensor(args[1], like),
                               _tensor(args[2], like))
        if name in _FUNCS_1:
            if len(args) != 1:
                raise ValueError(f"{name}() takes exactly 1 argument")
            return _FUNCS_1[name](_tensor(args[0], like))
        if name in _FUNCS_2:
            if len(args) != 2:
                raise ValueError(f"{name}() takes exactly 2 arguments")
            return _FUNCS_2[name](_tensor(args[0], like),
                                  _tensor(args[1], like))
        raise ValueError(f"unknown function {name!r}")
    raise ValueError(f"bad AST node {node!r}")


def _like(env: Mapping[str, object]):
    for v in env.values():
        if torch.is_tensor(v) and v.is_floating_point():
            return v
    return torch.zeros((), dtype=torch.float64)


class Expression:
    """A compiled expression f(x, y[, z], t) evaluated over tensors.

    ``__call__`` takes keyword tensors or floats (broadcastable) and
    returns a tensor.  ``spatial(points, t)`` evaluates on an
    ``[..., dim]`` coordinate tensor at the float (or 0-d tensor) time t.
    """

    def __init__(self, source: str):
        self.source = source
        self.ast = _Parser(_tokenize(source)).parse()
        vs: set[str] = set()
        _free_vars(self.ast, vs)
        self.variables = sorted(vs)

    def __call__(self, **env):
        like = _like(env)
        val = _eval(self.ast, env, like)
        return _tensor(val, like).to(like.dtype)

    def spatial(self, points, t=0.0):
        """Evaluate on points[..., dim] with names x,y(,z) and time t."""
        dim = points.shape[-1]
        env = {"x": points[..., 0], "t": t}
        if dim >= 2:
            env["y"] = points[..., 1]
        if dim >= 3:
            env["z"] = points[..., 2]
        else:
            env["z"] = torch.zeros_like(points[..., 0])
        out = _tensor(_eval(self.ast, env, points), points)
        return torch.broadcast_to(out.to(points.dtype), points.shape[:-1])

    def __repr__(self) -> str:
        return f"Expression({self.source!r})"


class VectorExpression:
    """A tuple of expressions (one per component), e.g. a (u,v,w,p) field.

    Matches deal.II's ``Function expression = expr0; expr1; expr2`` syntax
    where components are separated by ';'.
    """

    def __init__(self, source: str, n_components: int | None = None):
        parts = [p.strip() for p in source.split(";")]
        if n_components is not None and len(parts) != n_components:
            raise ValueError(
                f"expected {n_components} components, got {len(parts)} in {source!r}")
        self.components = [Expression(p if p else "0") for p in parts]

    def spatial(self, points, t=0.0):
        """points[..., dim] -> values[..., n_components]."""
        vals = [c.spatial(points, t) for c in self.components]
        return torch.stack(vals, dim=-1)

    def __len__(self) -> int:
        return len(self.components)
