"""The trainer's ``--config`` files: flat YAML of ``key: scalar`` lines.

Counterpart of the YAML step of ``recnext_tpu/train/main.py:parse_args`` (which
calls ``yaml.safe_load``), without PyYAML, which the port does not depend on. It reads
the subset that ``configs/*.yaml`` use and resolves each plain scalar as PyYAML's
YAML 1.1 resolver does: comments (a ``#`` at a line's start or after a space),
decimal integers, floats with a dot (``1.0e-3``; ``1e-3`` without a dot is a string,
as in PyYAML), booleans (true/false, yes/no, on/off in three cases), null (``~``,
``null``, an empty value), quoted and plain strings. Anything else (indentation,
lists, flow collections, anchors, tags, block scalars, several documents, octal,
hex or sexagesimal numbers) raises ``ValueError``.

``apply_config`` is the JAX parser's rule: the file gives the parser's defaults, the
command line overrides them, and a key the parser does not know is a ``SystemExit``.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Any, Dict

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                  "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
_BOOL = {s: v for words, v in ((("yes", "true", "on"), True), (("no", "false", "off"), False))
         for w in words for s in (w, w.capitalize(), w.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML resolves these as numbers the reader does not take
_OTHER_NUMBER = re.compile(r"[-+]?0[0-7_]+$|[-+]?0[bx][0-9a-fA-F_]+$"
                           r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after whitespace, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def scalar(text: str, where: str = "") -> Any:
    """One plain or quoted scalar, resolved as PyYAML's safe loader does."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        if "\\" in t:
            raise ValueError(f"{where}: escapes in double-quoted strings are not read")
        return t[1:-1]
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if t in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[t]
    if _OTHER_NUMBER.match(t):
        raise ValueError(f"{where}: {t!r} is an octal, binary, hex or sexagesimal number, "
                         "which the config reader does not take")
    if t[0] in "[]{}&*!|>%@`'\"" or t.startswith(("- ", "? ")) or ": " in t or " #" in t:
        raise ValueError(f"{where}: {t!r} is not a plain scalar the config reader takes")
    return t


def read_config(path: str | Path) -> Dict[str, Any]:
    """The ``key: scalar`` mapping of a flat YAML file (``{}`` for an empty one)."""
    out: Dict[str, Any] = {}
    for n, raw in enumerate(Path(path).read_text().splitlines(), 1):
        where = f"{path}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: nested or indented YAML is not read")
        if line.startswith(("---", "...", "%")):
            raise ValueError(f"{where}: YAML directives and documents are not read")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line: {raw!r}")
        if m.group(1) in out:
            raise ValueError(f"{where}: key {m.group(1)!r} given twice")
        out[m.group(1)] = scalar(m.group(2) or "", where)
    return out


def apply_config(parser: argparse.ArgumentParser, path: str | Path) -> None:
    """Make the file's values ``parser``'s defaults; a key that is not one of the
    parser's destinations exits, as the JAX CLI does."""
    defaults = read_config(path)
    known = {a.dest for a in parser._actions}
    unknown = set(defaults) - known
    if unknown:
        raise SystemExit(f"unknown config keys: {sorted(unknown)}")
    parser.set_defaults(**defaults)
