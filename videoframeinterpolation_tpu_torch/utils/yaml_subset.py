"""A reader and a writer for the subset of YAML the repository's configs use.

The card's machine has no ``yaml`` package, so the port reads and writes
config files with this module. The reader gives what ``yaml.safe_load``
gives (PyYAML's YAML 1.1 rules for plain scalars) for:

  * comments and blank lines;
  * ``key: scalar``, a scalar being an int (``600000``), a float
    (``2.0e-4``, ``1.0e-05``, ``0.0002``, ``.inf``), a bool (``true``,
    ``yes``, ``off``, ...), null (``null``, ``~`` or nothing), or a plain,
    single-quoted or double-quoted string;
  * flow lists of scalars, nested or not (``[8, 8, 2]``), and ``[]``/``{}``;
  * block lists of scalars or flow lists, indented under their key
    (``  - vimeo90k``) or at the key's own indent (``- 16``, as
    ``yaml.safe_dump`` writes them);
  * nested maps of the same (``teacher_overrides:`` / ``  dat_samples:`` /
    ``  - 8``).

Anything else (anchors, tags, block scalars, flow maps, maps inside lists,
multi-line scalars, octal or hexadecimal ints, timestamps) raises
:class:`YamlSubsetError`, naming the file and the line. The writer writes
a mapping as ``yaml.safe_dump(data, sort_keys=False)`` lays it out, and
its output reads back equal in both readers.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, NamedTuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)\Z")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?\Z"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# Plain scalars that PyYAML resolves to a type this subset does not read:
# other int forms (binary, octal, hexadecimal, sexagesimal), sexagesimal
# floats, timestamps, the merge key and the value key.
_OTHER = re.compile(r"[-+]?0b[0-1_]+\Z|[-+]?0[0-7_]+\Z|[-+]?0x[0-9a-fA-F_]+\Z"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?\Z"
                    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?|<<\Z|=\Z")
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
# A block map's line: a plain key, a colon, and an inline value or nothing.
_KEY = re.compile(r"([^\s'\"\[\]{},#&*!|>%@`][^:#]*?)\s*:(?:\s+(.*))?\Z")


class YamlSubsetError(ValueError):
    """The text is not in the YAML subset this module reads."""


class _Line(NamedTuple):
    number: int      # 1-based
    indent: int
    text: str        # without indentation and comment


def _fail(source: str, number: int, what: str):
    raise YamlSubsetError(f"{source}, line {number}: {what} (outside the YAML subset "
                          "the port reads)")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _lines(text: str, source: str) -> list[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            _fail(source, number, "a tab in the indentation")
        if number == 1 and stripped.startswith("%") or stripped in ("---", "..."):
            _fail(source, number, "a directive or document marker")
        out.append(_Line(number, len(body) - len(stripped), stripped))
    return out


def resolve(text: str, source: str = "<value>", number: int = 1) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 rules."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER.match(text):
        _fail(source, number, f"the scalar {text!r}")
    if text[0] in _INDICATORS and not (text[0] in "-?:" and len(text) > 1
                                       and text[1] not in " \t"):
        _fail(source, number, f"the scalar {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(source, number, f"the scalar {text!r}")
    return text


class _Flow:
    """A cursor over one line's inline value: a scalar or a flow list."""

    def __init__(self, text: str, source: str, number: int):
        self.text, self.pos, self.source, self.number = text, 0, source, number

    def fail(self, what: str):
        _fail(self.source, self.number, what)

    def skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def value(self, in_flow: bool) -> Any:
        self.skip()
        rest = self.text[self.pos:]
        if rest.startswith("["):
            return self.flow_list()
        if rest.startswith("{"):
            self.pos += 1
            self.skip()
            if self.text[self.pos:self.pos + 1] != "}":
                self.fail("a flow map")
            self.pos += 1
            return {}
        if rest.startswith("'"):
            return self.single_quoted()
        if rest.startswith('"'):
            return self.double_quoted()
        end = len(self.text)
        if in_flow:
            m = re.search(r"[,\]]", rest)
            end = self.pos + (m.start() if m else len(rest))
            if "[" in self.text[self.pos:end] or "{" in self.text[self.pos:end]:
                self.fail("a bracket inside a plain scalar")
        plain = self.text[self.pos:end].strip()
        self.pos = end
        if in_flow and not plain:
            self.fail("an empty entry in a flow list")
        return resolve(plain, self.source, self.number)

    def flow_list(self) -> list:
        self.pos += 1
        out = []
        self.skip()
        if self.text[self.pos:self.pos + 1] == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.value(in_flow=True))
            self.skip()
            ch = self.text[self.pos:self.pos + 1]
            self.pos += 1
            if ch == "]":
                return out
            if ch != ",":
                self.fail("an unterminated flow list")

    def single_quoted(self) -> str:
        out, i = [], self.pos + 1
        while True:
            j = self.text.find("'", i)
            if j < 0:
                self.fail("an unterminated quoted string")
            out.append(self.text[i:j])
            if self.text[j + 1:j + 2] == "'":
                out.append("'")
                i = j + 2
                continue
            self.pos = j + 1
            return "".join(out)

    def double_quoted(self) -> str:
        escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
        out, i = [], self.pos + 1
        while i < len(self.text):
            ch = self.text[i]
            if ch == '"':
                self.pos = i + 1
                return "".join(out)
            if ch == "\\":
                nxt = self.text[i + 1:i + 2]
                if nxt not in escapes:
                    self.fail(f"the escape \\{nxt}")
                out.append(escapes[nxt])
                i += 2
                continue
            out.append(ch)
            i += 1
        self.fail("an unterminated quoted string")

    def end(self) -> None:
        self.skip()
        if self.pos != len(self.text):
            self.fail(f"text after a value: {self.text[self.pos:]!r}")


def parse_value(text: str, source: str = "<value>", number: int = 1) -> Any:
    """One inline value: a scalar or a flow list (what ``yaml.safe_load``
    gives for the same text, within the subset)."""
    cur = _Flow(text.strip(), source, number)
    if not cur.text:
        return None
    out = cur.value(in_flow=False)
    cur.end()
    return out


class _Block:
    def __init__(self, lines: list[_Line], source: str):
        self.lines, self.i, self.source = lines, 0, source

    def peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def is_item(line: _Line) -> bool:
        return line.text == "-" or line.text.startswith("- ")

    def node(self, indent: int) -> Any:
        line = self.peek()
        return self.sequence(indent) if self.is_item(line) else self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self.peek()) is not None and line.indent == indent and self.is_item(line):
            item = line.text[1:].strip()
            if not item or self.is_item(_Line(0, 0, item)):
                _fail(self.source, line.number, "a nested block inside a list item")
            if re.match(r"[^'\"\[{][^#]*?:( |$)", item):
                _fail(self.source, line.number, "a map inside a list")
            out.append(parse_value(item, self.source, line.number))
            self.i += 1
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self.peek()) is not None and line.indent >= indent:
            if line.indent > indent:
                _fail(self.source, line.number, "unexpected indentation")
            if self.is_item(line):
                _fail(self.source, line.number, "a list item where a key was expected")
            m = _KEY.match(line.text)
            if not m:
                _fail(self.source, line.number, f"not a 'key: value' line: {line.text!r}")
            key, rest = m.group(1), m.group(2)
            if resolve(key, self.source, line.number) != key:
                _fail(self.source, line.number, f"the key {key!r} is not a string")
            self.i += 1
            if rest:
                out[key] = parse_value(rest, self.source, line.number)
                continue
            nxt = self.peek()
            if nxt is not None and (nxt.indent > indent
                                    or (nxt.indent == indent and self.is_item(nxt))):
                out[key] = self.node(nxt.indent)
            else:
                out[key] = None
        return out


def loads(text: str, source: str = "<string>") -> Any:
    """The document in ``text`` (``None`` when it holds nothing but
    comments and blank lines)."""
    lines = _lines(text, source)
    if not lines:
        return None
    block = _Block(lines, source)
    first = lines[0]
    if len(lines) == 1 and not block.is_item(first) and not _KEY.match(first.text):
        return parse_value(first.text, source, first.number)
    out = block.node(first.indent)
    if (extra := block.peek()) is not None:
        _fail(source, extra.number, "unexpected indentation")
    return out


def load(path: str | Path) -> Any:
    """The document in the file at ``path``."""
    return loads(Path(path).read_text(), str(path))


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if not v.isprintable():
            raise YamlSubsetError(f"cannot write the string {v!r}")
        try:
            plain = v == v.strip() and resolve(v) == v
        except YamlSubsetError:
            plain = False
        if plain and v[0] not in _INDICATORS:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise YamlSubsetError(f"cannot write a {type(v).__name__}")


def _dump_into(out: list[str], data: dict, indent: int) -> None:
    pad = " " * indent
    for key, v in data.items():
        if not isinstance(key, str):
            raise YamlSubsetError(f"the key {key!r} is not a string")
        head = f"{pad}{_scalar(key)}:"
        if isinstance(v, dict):
            if not v:
                out.append(f"{head} {{}}")
            else:
                out.append(head)
                _dump_into(out, v, indent + 2)
        elif isinstance(v, (list, tuple)):
            if not v:
                out.append(f"{head} []")
                continue
            out.append(head)
            for item in v:
                if isinstance(item, (list, tuple, dict)):
                    raise YamlSubsetError(f"{key}: a nested list or map in a list")
                out.append(f"{pad}- {_scalar(item)}")
        else:
            out.append(f"{head} {_scalar(v)}")


def dumps(data: dict) -> str:
    """``data`` (str keys; scalars, lists of scalars and maps of the same
    as values) laid out as ``yaml.safe_dump(data, sort_keys=False)`` lays
    it out."""
    out: list[str] = []
    _dump_into(out, data, 0)
    return "".join(line + "\n" for line in out)
