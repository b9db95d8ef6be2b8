"""The subset of YAML that ``config/*.yaml`` uses, read as PyYAML's
``safe_load`` reads it (the card's machine has no PyYAML).

Block mappings nested by indentation, ``#`` comments, plain, single- and
double-quoted scalars, ``null`` / ``~`` / an empty value, YAML 1.1 booleans
(``true`` / ``yes`` / ``on`` and their opposites, in PyYAML's three
spellings), decimal ints, floats (with a dot, as PyYAML's resolver wants
them; ``.inf`` and ``.nan`` too) and the empty flow mapping ``{}``.
Anything outside that subset raises ``YAMLError`` naming the line: a
sequence, a flow collection with content, an anchor, a tag, a block
scalar, a multi-line scalar, a tab in the indentation, an octal, hex,
binary or sexagesimal number, a timestamp. It never guesses."""

import re


class YAMLError(ValueError):
    pass


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_OTHER_FLOAT = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0", " ": " "}


def _fail(lineno: int, what: str):
    raise YAMLError(f"line {lineno}: {what} is outside the YAML subset this reader takes")


def _resolve_plain(text: str, lineno: int):
    if _NULL.match(text):
        return None
    if _BOOL_TRUE.match(text):
        return True
    if _BOOL_FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _OTHER_INT.match(text) or _OTHER_FLOAT.match(text):
        _fail(lineno, f"the number {text!r}")
    if _TIMESTAMP.match(text):
        _fail(lineno, f"the timestamp {text!r}")
    if text in ("<<", "="):
        _fail(lineno, f"the key {text!r}")
    return text


def _quoted(text: str, lineno: int) -> tuple[str, str]:
    """(the quoted scalar at the start of ``text``, what follows it)."""
    quote = text[0]
    out = []
    i = 1
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), text[i + 1 :]
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), text[i + 1 :]
        if c == "\\":
            nxt = text[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt == "u" and re.match(r"^[0-9a-fA-F]{4}$", text[i + 2 : i + 6]):
                out.append(chr(int(text[i + 2 : i + 6], 16)))
                i += 6
                continue
            _fail(lineno, f"the escape \\{nxt}")
        out.append(c)
        i += 1
    _fail(lineno, "a multi-line quoted scalar")


def _after_scalar(rest: str, lineno: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        _fail(lineno, f"text after a quoted scalar ({rest!r})")


def _strip_comment(text: str) -> str:
    m = re.search(r"(^|\s)#", text)
    return (text[: m.start()] if m else text).rstrip()


def _scalar(text: str, lineno: int):
    """The value of ``text`` (a comment may follow it)."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        _after_scalar(rest, lineno)
        return value
    text = _strip_comment(text)
    if re.match(r"^\{\s*\}$", text):
        return {}
    if not text:
        return None
    first = text[0]
    if first in "[]{},#&*!|>%@`" or (first in "-?:" and (len(text) == 1 or text[1] == " ")):
        _fail(lineno, f"the value {text!r}")
    if ": " in text or text.endswith(":"):
        _fail(lineno, f"a mapping inside the value {text!r}")
    return _resolve_plain(text, lineno)


def _split_key(content: str, lineno: int) -> tuple[str, str]:
    if content[:1] in ("'", '"'):
        key, rest = _quoted(content, lineno)
        if not (rest.startswith(": ") or rest.rstrip() == ":" or rest.startswith(":\t")):
            _fail(lineno, f"the line {content!r}")
        return key, rest[1:].strip()
    m = re.search(r":(\s|$)", content)
    if m is None:
        _fail(lineno, f"the line {content!r}")
    key = content[: m.start()]
    if not key or key[0] in "[]{},#&*!|>%@`'\"" or (key[0] in "-?:" and (len(key) == 1 or key[1] == " ")):
        _fail(lineno, f"the key {key!r}")
    if "#" in key:
        _fail(lineno, f"the key {key!r}")
    resolved = _resolve_plain(key, lineno)
    if not isinstance(resolved, str):
        _fail(lineno, f"the non-string key {key!r}")
    return resolved, content[m.end() :].strip()


def _block(lines, i: int, indent: int):
    mapping: dict = {}
    while i < len(lines):
        lineno, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "an indentation that opens no mapping")
        key, rest = _split_key(content, lineno)
        i += 1
        if _strip_comment(rest) == "" and rest[:1] not in ("'", '"'):
            if i < len(lines) and lines[i][1] > indent:
                value, i = _block(lines, i, lines[i][1])
            else:
                value = None
        else:
            value = _scalar(rest, lineno)
        mapping[key] = value
    return mapping, i


def safe_load(stream):
    """The mapping a YAML document of the subset holds (None when it holds
    nothing), as ``yaml.safe_load`` gives it."""
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    if text.startswith("﻿"):
        text = text[1:]
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or (body.strip() and "\t" in raw[: len(raw) - len(body)]):
            _fail(lineno, "a tab in the indentation")
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        if body.startswith(("---", "...", "%")):
            _fail(lineno, "a document marker or directive")
        lines.append((lineno, len(raw) - len(body), body.rstrip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        _fail(lines[i][0], "an indentation that closes no mapping")
    return value
