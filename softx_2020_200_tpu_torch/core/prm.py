"""deal.II-compatible ``.prm`` parameter deck parser.

The reference drives every run from deal.II ``ParameterHandler`` decks
(SURVEY.md §5.6): nested ``subsection <name> ... end`` blocks containing
``set <key> = <value>`` lines, ``#`` comments, and ``\\`` line
continuations.  This module parses that exact grammar into a nested
dict-like :class:`ParameterDeck` so that reference decks run unmodified.

No deal.II code is used or translated; this is a fresh implementation of
the documented file format.
"""

from __future__ import annotations


class ParameterDeck:
    """A nested parameter tree: values are strings, children are decks.

    Mirrors the observable behavior of deal.II's ParameterHandler tree
    (case-sensitive section & key names, whitespace-stripped values).
    """

    def __init__(self) -> None:
        self.values: dict[str, str] = {}
        self.children: dict[str, "ParameterDeck"] = {}

    # -- construction -----------------------------------------------------
    def subsection(self, name: str) -> "ParameterDeck":
        return self.children.setdefault(name, ParameterDeck())

    def set(self, key: str, value: str) -> None:
        self.values[key] = value

    # -- lookup ------------------------------------------------------------
    def sub(self, name: str) -> "ParameterDeck":
        """Get a subsection; returns an empty deck if absent."""
        return self.children.get(name, _EMPTY)

    def has_sub(self, name: str) -> bool:
        return name in self.children

    def get(self, key: str, default: str | None = None) -> str | None:
        return self.values.get(key, default)

    def get_str(self, key: str, default: str = "") -> str:
        return self.values.get(key, default)

    def get_double(self, key: str, default: float = 0.0) -> float:
        v = self.values.get(key)
        return default if v is None else float(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.values.get(key)
        return default if v is None else int(float(v))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.values.get(key)
        if v is None:
            return default
        v = v.strip().lower()
        if v in ("true", "yes", "on", "1"):
            return True
        if v in ("false", "no", "off", "0"):
            return False
        raise ValueError(f"cannot parse boolean parameter {key!r} = {v!r}")

    # -- debugging ----------------------------------------------------------
    def to_dict(self) -> dict:
        d: dict = dict(self.values)
        for name, child in self.children.items():
            d[name] = child.to_dict()
        return d

    def dump(self, indent: int = 0) -> str:
        """Render back to .prm text (round-trip aid & template generator)."""
        pad = "  " * indent
        out = []
        for k, v in self.values.items():
            out.append(f"{pad}set {k} = {v}")
        for name, child in self.children.items():
            out.append(f"{pad}subsection {name}")
            out.append(child.dump(indent + 1))
            out.append(f"{pad}end")
        return "\n".join(out)


_EMPTY = ParameterDeck()


def _strip_comment(line: str) -> str:
    """Remove '#'-to-end-of-line comments (deal.II convention)."""
    idx = line.find("#")
    if idx >= 0:
        line = line[:idx]
    return line


def parse_prm(text: str) -> ParameterDeck:
    """Parse .prm text into a ParameterDeck.

    Grammar (deal.II ParameterHandler, as used by the reference's decks):
      - ``subsection <name>`` / ``end`` blocks, arbitrarily nested
      - ``set <key> = <value>`` (value = rest of line, stripped)
      - ``#`` starts a comment
      - a trailing ``\\`` continues the logical line
      - blank lines ignored
    """
    root = ParameterDeck()
    stack = [root]

    # join continuation lines first
    logical_lines: list[str] = []
    pending = ""
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.endswith("\\"):
            pending += line[:-1].rstrip() + " " if pending else line[:-1].rstrip() + " "
            continue
        logical_lines.append(pending + (line.strip() if pending else line))
        pending = ""
    if pending:
        logical_lines.append(pending)

    for lineno, line in enumerate(logical_lines, 1):
        stripped = line.strip()
        if not stripped:
            continue
        lowered = stripped.lower()
        if lowered.startswith("subsection"):
            name = stripped[len("subsection"):].strip()
            if not name:
                raise ValueError(f"line {lineno}: subsection without a name")
            stack.append(stack[-1].subsection(name))
        elif lowered == "end":
            if len(stack) == 1:
                raise ValueError(f"line {lineno}: 'end' without open subsection")
            stack.pop()
        elif lowered.startswith("set ") or lowered.startswith("set\t"):
            body = stripped[4:]
            if "=" not in body:
                raise ValueError(f"line {lineno}: 'set' without '='")
            key, _, value = body.partition("=")
            stack[-1].set(key.strip(), value.strip())
        elif lowered.startswith("include "):
            raise ValueError(f"line {lineno}: 'include' directives not supported")
        else:
            raise ValueError(f"line {lineno}: cannot parse {stripped!r}")

    if len(stack) != 1:
        raise ValueError("unterminated subsection(s) at end of file")
    return root


def parse_prm_file(path: str) -> ParameterDeck:
    with open(path, "r") as fh:
        return parse_prm(fh.read())
