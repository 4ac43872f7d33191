"""The YAML the repo's configs use, read and written without PyYAML.

`loads` / `load` read block mappings and block sequences (a sequence may sit
at its key's indent, as PyYAML writes it, and an entry may open a compact
mapping or sequence: `- key: value`, `- - a`), comments, plain,
single-quoted and double-quoted scalars, the empty flow collections `[]`
and `{}`, and anchors with aliases (`&id001` / `*id001`: the alias is the
anchored value itself, as `yaml.safe_load` gives it).  A plain scalar
resolves as PyYAML's YAML 1.1 resolver resolves it: bool, int, float,
null or str (`resolve_plain`).  Whatever else YAML has raises ValueError
naming the file and line: tags, block scalars (`|`, `>`), flow collections
with content, merge keys (`<<`), complex keys, several documents,
directives, timestamps, tabs in indentation, and multi-line plain or quoted
scalars.

`dumps` / `dump` write block style that `yaml.safe_load` and `loads` both
read back to the same value; a string that would resolve to another type,
or that a plain scalar cannot hold, is quoted.
"""

from __future__ import annotations

import math
import re
from typing import Any

# PyYAML's implicit resolvers (yaml/resolver.py), for plain scalars only
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": "\u2028", "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters a plain scalar may not start with (YAML's indicators)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _sexagesimal(digits: str) -> int | float:
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += float(part) * base if "." in part else int(part) * base
        base *= 60
    return value


def resolve_plain(text: str, where: str = "<string>") -> Any:
    """The value of a plain scalar, as `yaml.safe_load` resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * float(_sexagesimal(value))
        return sign * float(value)
    if _TIMESTAMP.match(text):
        raise ValueError(f"{where}: timestamps are not supported: {text!r}")
    if text == "=":
        raise ValueError(f"{where}: the value key '=' is not supported")
    return text


def _strip_comment(text: str) -> str:
    """`text` up to a comment: a `#` at its start or after whitespace."""
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.anchors: dict = {}
        self.lines = []  # (indent, content, line number)
        started = False
        for number, raw in enumerate(text.split("\n"), 1):
            raw = raw.rstrip("\r")
            stripped = raw.lstrip(" ")
            if stripped.lstrip(" \t") == "" or stripped.lstrip(" \t").startswith("#"):
                continue
            if "\t" in stripped:
                raise self.error(number, "tabs are not supported (as indentation or inside a line)")
            if raw.startswith("%"):
                raise self.error(number, "directives are not supported")
            if raw.rstrip() in ("---", "...") or raw.startswith(("--- ", "... ")):
                if started or raw.rstrip() != "---":
                    raise self.error(number, "only one document is supported")
                started = True
                continue
            started = True
            self.lines.append([len(raw) - len(stripped), stripped, number])

    def error(self, number: int, msg: str) -> ValueError:
        return ValueError(f"{self.name}:{number}: {msg}")

    # --- scalars -----------------------------------------------------------

    def _quoted(self, text: str, number: int) -> tuple:
        """(string, rest of the line) of the quoted scalar `text` starts with."""
        quote, out, i = text[0], [], 1
        while i < len(text):
            ch = text[i]
            if quote == "'" and ch == "'":
                if text[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), text[i + 1 :]
            if quote == '"' and ch == '"':
                return "".join(out), text[i + 1 :]
            if quote == '"' and ch == "\\":
                code = text[i + 1 : i + 2]
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    i += 2
                    continue
                if code in _HEX_ESCAPES:
                    digits = text[i + 2 : i + 2 + _HEX_ESCAPES[code]]
                    if len(digits) != _HEX_ESCAPES[code] or not all(c in "0123456789abcdefABCDEF" for c in digits):
                        raise self.error(number, f"bad escape \\{code}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + len(digits)
                    continue
                raise self.error(number, f"unknown escape \\{code}" if code else "multi-line quoted scalars are not supported")
            out.append(ch)
            i += 1
        raise self.error(number, "multi-line quoted scalars are not supported")

    def scalar(self, text: str, number: int) -> Any:
        """The value of an inline scalar, `[]` or `{}` (comment not yet stripped)."""
        if text[0] in "'\"":
            value, rest = self._quoted(text, number)
            if _strip_comment(rest).strip():
                raise self.error(number, f"unexpected text after a quoted scalar: {rest.strip()!r}")
            return value
        text = _strip_comment(text)
        if text.replace(" ", "") in ("[]", "{}"):
            return [] if text[0] == "[" else {}
        head = text[0]
        if head in "[{":
            raise self.error(number, "flow collections other than [] and {} are not supported")
        if head == "!":
            raise self.error(number, "tags are not supported")
        if head in "|>":
            raise self.error(number, "block scalars (| and >) are not supported")
        if head in "%@`" or (head in "?:-" and text[1:2] in ("", " ")):
            raise self.error(number, f"a plain scalar cannot start with {head!r}")
        if ": " in text or text.endswith(":"):
            raise self.error(number, "mapping values are not allowed here")
        return resolve_plain(text, f"{self.name}:{number}")

    # --- structure ----------------------------------------------------------

    def _split_key(self, content: str, number: int):
        """(key, rest) if `content` opens a mapping entry, else None."""
        if content.startswith("? ") or content == "?":
            raise self.error(number, "complex keys are not supported")
        if content[0] in "'\"":
            key, rest = self._quoted(content, number)
            rest = rest.lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                return None
            return key, rest[1:].strip(" ")
        for i, ch in enumerate(content):
            if ch == "#" and i > 0 and content[i - 1] == " ":
                return None
            if ch == ":" and content[i + 1 : i + 2] in ("", " "):
                raw = content[:i].rstrip(" ")
                if raw == "<<":
                    raise self.error(number, "merge keys (<<) are not supported")
                if raw[:1] in ("&", "*", "!", "[", "{", "|", ">"):
                    raise self.error(number, f"keys starting with {raw[0]!r} are not supported")
                return resolve_plain(raw, f"{self.name}:{number}"), content[i + 1 :].strip(" ")
        return None

    def node(self, i: int, indent: int) -> tuple:
        """(value, next line) of the block node at line i, whose indent is `indent`."""
        content, number = self.lines[i][1], self.lines[i][2]
        if content == "-" or content.startswith("- "):
            return self.sequence(i, indent)
        if self._split_key(content, number) is not None:
            return self.mapping(i, indent)
        value = self.inline(content, number)
        if i + 1 < len(self.lines) and self.lines[i + 1][0] > indent:
            raise self.error(self.lines[i + 1][2], "multi-line plain scalars are not supported")
        return value, i + 1

    def inline(self, text: str, number: int) -> Any:
        """An inline value: alias, or scalar."""
        if text.startswith("*"):
            name = _strip_comment(text[1:])
            if name not in self.anchors:
                raise self.error(number, f"unknown alias *{name}")
            return self.anchors[name]
        return self.scalar(text, number)

    def value_after(self, rest: str, i: int, indent: int, allow_same_indent_seq: bool) -> tuple:
        """(value, next line) of what follows `key:` or `-` on line i: `rest`
        inline, or a block below it."""
        number = self.lines[i][2]
        anchor = None
        if rest.startswith("&"):
            name, _, rest = rest[1:].partition(" ")
            if not name:
                raise self.error(number, "an anchor needs a name")
            anchor, rest = name, rest.strip(" ")
        if rest[:1] not in ("'", '"'):
            rest = _strip_comment(rest)
        if rest:
            value, nxt = self.inline(rest, number), i + 1
            if nxt < len(self.lines) and self.lines[nxt][0] > indent:
                raise self.error(self.lines[nxt][2], "multi-line plain scalars are not supported")
        else:
            nxt = i + 1
            below = self.lines[nxt] if nxt < len(self.lines) else None
            if below is not None and below[0] > indent:
                value, nxt = self.node(nxt, below[0])
            elif (below is not None and allow_same_indent_seq and below[0] == indent
                  and (below[1] == "-" or below[1].startswith("- "))):
                value, nxt = self.sequence(nxt, indent)
            else:
                value = None
        if anchor is not None:
            self.anchors[anchor] = value
        return value, nxt

    def mapping(self, i: int, indent: int) -> tuple:
        out: dict = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            content, number = self.lines[i][1], self.lines[i][2]
            split = self._split_key(content, number)
            if split is None:
                raise self.error(number, "expected a 'key: value' line")
            key, rest = split
            try:
                hash(key)
            except TypeError:
                raise self.error(number, "unhashable key") from None
            out[key], i = self.value_after(rest, i, indent, allow_same_indent_seq=True)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise self.error(self.lines[i][2], "bad indentation")
        return out, i

    def sequence(self, i: int, indent: int) -> tuple:
        out: list = []
        while i < len(self.lines) and self.lines[i][0] == indent:
            content, number = self.lines[i][1], self.lines[i][2]
            if not (content == "-" or content.startswith("- ")):
                break
            rest = content[1:].lstrip(" ")
            if rest and not rest.startswith(("&", "*", "#")) and (
                    rest == "-" or rest.startswith("- ") or self._split_key(rest, number) is not None):
                # a compact nested node: read it as a block at the column it starts in
                self.lines[i] = [indent + len(content) - len(rest), rest, number]
                value, i = self.node(i, self.lines[i][0])
                out.append(value)
                continue
            value, i = self.value_after(rest, i, indent, allow_same_indent_seq=False)
            out.append(value)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise self.error(self.lines[i][2], "bad indentation")
        return out, i

    def document(self) -> Any:
        if not self.lines:
            return None
        indent = self.lines[0][0]
        value, i = self.node(0, indent)
        if i < len(self.lines):
            raise self.error(self.lines[i][2], "bad indentation")
        return value


def loads(text: str, name: str = "<string>") -> Any:
    """The value of a YAML document in the supported subset; ValueError
    naming `name` and the line for anything outside it."""
    return _Reader(text, name).document()


def load(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read(), str(path))


# --- writer -------------------------------------------------------------------


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip(" ") or s[0] in _INDICATORS or s == "<<":
        return False
    if any(c in s for c in "\n\r\t") or ": " in s or " #" in s or s.endswith(":") or not s.isprintable():
        return False
    try:
        return resolve_plain(s) == s and isinstance(resolve_plain(s), str)
    except ValueError:
        return False


def _scalar_text(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, str):
        if _plain_ok(value):
            return value
        if value.isprintable():
            return "'" + value.replace("'", "''") + "'"
        out = []
        for ch in value:
            if ch in ('"', "\\"):
                out.append("\\" + ch)
            elif ch.isprintable():
                out.append(ch)
            elif ord(ch) < 0x100:
                out.append(f"\\x{ord(ch):02x}")
            elif ord(ch) < 0x10000:
                out.append(f"\\u{ord(ch):04x}")
            else:
                out.append(f"\\U{ord(ch):08x}")
        return '"' + "".join(out) + '"'
    raise TypeError(f"cannot write a {type(value).__name__} as YAML: {value!r}")


def _emit(value: Any, indent: int, out: list, prefix: str, sort_keys: bool) -> None:
    """Append the lines of `value`; `prefix` is what opens its first line
    (`key:` or `-` markers), already indented."""
    pad = " " * indent
    if isinstance(value, dict) and value:
        first = True
        items = list(value.items())
        if sort_keys:
            try:
                items = sorted(items, key=lambda kv: kv[0])
            except TypeError:  # keys of mixed types stay in order, as PyYAML leaves them
                pass
        for key, item in items:
            if isinstance(key, (dict, list)):
                raise TypeError(f"cannot write a {type(key).__name__} key as YAML")
            head = (prefix if first else pad) + _scalar_text(key) + ":"
            first = False
            if isinstance(item, dict) and item:
                out.append(head)
                _emit(item, indent + 2, out, " " * (indent + 2), sort_keys)
            elif isinstance(item, list) and item:
                out.append(head)
                _emit(item, indent, out, pad, sort_keys)
            else:
                out.append(head + " " + _inline(item))
    elif isinstance(value, list) and value:
        first = True
        for item in value:
            head = (prefix if first else pad) + "- "
            first = False
            if isinstance(item, (dict, list)) and item:
                _emit(item, indent + 2, out, head, sort_keys)
            else:
                out.append(head + _inline(item))
    else:
        out.append(prefix + _inline(value))


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar_text(value)


def dumps(value: Any, sort_keys: bool = False) -> str:
    """Block-style YAML of `value` (dicts, lists, str, int, float, bool,
    None) that `loads` and `yaml.safe_load` both read back to `value`;
    mapping keys in order, or sorted as `yaml.safe_dump` sorts them."""
    out: list = []
    _emit(value, 0, out, "", sort_keys)
    return "\n".join(out) + "\n"


def dump(value: Any, path, sort_keys: bool = False) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(value, sort_keys))
