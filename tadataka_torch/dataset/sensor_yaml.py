"""A reader for the subset of YAML that EuRoC's ``sensor.yaml`` files use,
so the port needs no YAML package.

The subset: ``#`` comments (at a line's start or after whitespace),
block mappings nested by indentation (spaces), plain scalars, and flow
sequences of plain scalars (``[a, b, ...]``) that may run over several
lines.  Scalars resolve as ``yaml.safe_load`` resolves them: null, bool,
decimal int and float by YAML 1.1's patterns (so ``5e-05``, with no
dot, stays a string there and here), anything else a string.  Every
other construct raises ``ValueError``: quotes, anchors, aliases, tags,
block scalars, block sequences, flow mappings, nested flow sequences,
documents and directives, tabs in indentation, duplicate keys, keys that
are not strings, and the scalar forms YAML 1.1 reads as a number or a
date that this reader does not convert (``0x1f``, ``1_000``, ``1:30``,
``2001-12-14``).
"""

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# YAML 1.1's implicit int, float and timestamp patterns; of these the
# reader converts decimal ints, and floats written with neither "_" nor
# ":", and raises on the rest
_YAML_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+"
                       r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_YAML_TIMESTAMP = re.compile(
    r"[0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}"
    r":[0-9]{2}(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?")
_DECIMAL_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INDICATORS = tuple("\"'&*!|>%@`{}[]")


def _fail(lineno, message):
    raise ValueError(f"sensor yaml line {lineno}: {message}")


def _scalar(text, lineno):
    """A plain scalar resolved as yaml.safe_load resolves it."""
    if text.startswith(_INDICATORS) or text == "-" or text.startswith("- "):
        _fail(lineno, f"unsupported value {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(lineno, f"unsupported value {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _YAML_INT.fullmatch(text):
        if not _DECIMAL_INT.fullmatch(text):
            _fail(lineno, f"unsupported int form {text!r}")
        return int(text)
    if _YAML_FLOAT.fullmatch(text):
        if "_" in text or ":" in text:
            _fail(lineno, f"unsupported float form {text!r}")
        body = text.lstrip("+-").lower()
        sign = -1.0 if text.startswith("-") else 1.0
        if body == ".inf":
            return sign * float("inf")
        return float("nan") if body == ".nan" else sign * float(body)
    if _YAML_TIMESTAMP.fullmatch(text) or text in ("=", "<<"):
        _fail(lineno, f"unsupported value {text!r}")
    return text


def _strip_comment(line):
    for i, c in enumerate(line):
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_sequence(text, lineno):
    """[a, b, ...] of plain scalars."""
    inner = text[1:-1].strip()
    if not inner:
        return []
    if any(c in inner for c in "[]{}"):
        _fail(lineno, "nested flow collections are not supported")
    items = [item.strip() for item in inner.split(",")]
    if any(not item for item in items):
        _fail(lineno, "empty item in a flow sequence")
    return [_scalar(item, lineno) for item in items]


def _lines(text):
    """(line number, indent, content) of every line that holds more than
    a comment; a flow sequence's lines are joined into its first."""
    out = []
    pending = None                   # [lineno, indent, text] of an open [
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending[2] += " " + line.strip()
            if pending[2].count("[") == pending[2].count("]"):
                out.append(tuple(pending))
                pending = None
            continue
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
            _fail(lineno, "tabs in indentation")
        if body.startswith(("%", "---", "...")):
            _fail(lineno, "directives and document markers are not "
                  "supported")
        entry = [lineno, len(line) - len(body), body]
        if body.count("[") > body.count("]"):
            pending = entry
        else:
            out.append(tuple(entry))
    if pending is not None:
        _fail(pending[0], "unclosed flow sequence")
    return out


def _mapping(lines, i, indent):
    """The block mapping of the lines at ``indent`` from ``i``; returns
    (dict, index of the first line after it)."""
    result = {}
    while i < len(lines):
        lineno, line_indent, body = lines[i]
        if line_indent < indent:
            break
        if line_indent > indent:
            _fail(lineno, "unexpected indentation")
        if body.startswith("-"):
            _fail(lineno, "block sequences are not supported")
        key, sep, value = body.partition(":")
        if not sep or (value and not value.startswith(" ")):
            _fail(lineno, f"expected 'key: value', got {body!r}")
        if not _KEY.fullmatch(key) or not isinstance(_scalar(key, lineno),
                                                     str):
            _fail(lineno, f"unsupported key {key!r}")
        if key in result:
            _fail(lineno, f"duplicate key {key!r}")
        value = value.strip()
        i += 1
        if value.startswith("["):
            if not value.endswith("]"):
                _fail(lineno, f"text after a flow sequence: {value!r}")
            result[key] = _flow_sequence(value, lineno)
        elif value:
            result[key] = _scalar(value, lineno)
        elif i < len(lines) and lines[i][1] > indent:
            result[key], i = _mapping(lines, i, lines[i][1])
        else:
            result[key] = None
    return result, i


def loads(text):
    """The mapping a sensor.yaml text holds, as yaml.safe_load gives it."""
    lines = _lines(text)
    if not lines:
        raise ValueError("sensor yaml: empty document")
    result, i = _mapping(lines, 0, lines[0][1])
    if i < len(lines):
        _fail(lines[i][0], "unexpected indentation")
    return result


def load(path):
    with open(path) as f:
        return loads(f.read())
