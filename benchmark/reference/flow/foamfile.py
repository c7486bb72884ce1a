"""A frozen copy of the port's ``io/foamfile.py``, for the flow reference.

OpenFOAM dictionary-format parser/writer.

Replaces the OpenFOAM ``IOdictionary`` machinery the reference solvers lean
on (``applications/*/createFields.H``) with a standalone parser for the
ascii subset the cases use: ``FoamFile`` headers, nested ``{}`` dicts,
``( )`` lists, ``[ ]`` dimension sets, ``$macro`` references, ``uniform`` /
``nonuniform List<T>`` fields, ``//`` and ``/* */`` comments.

A copy of ``cudaparticlesfoam_tpu/io/foamfile.py`` (pure Python), kept so
that the PyTorch port never imports the JAX package; the written header
names the same program, so both packages write the same bytes
(``tests/test_torch_io.py``).
"""

from __future__ import annotations

import re

_TOKEN_RE = re.compile(
    r"""
    "[^"]*"            |   # quoted string
    [(){};\[\]]        |   # structural
    [^\s(){};\[\]]+        # word / number
    """,
    re.VERBOSE,
)

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)


def strip_comments(text: str) -> str:
    return _COMMENT_RE.sub(" ", text)


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(strip_comments(text))


def _atom(tok: str):
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    try:
        i = int(tok)
        return i
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


class _Stream:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def eof(self):
        return self.i >= len(self.toks)


def _parse_list(s: _Stream):
    out = []
    while True:
        t = s.peek()
        if t is None:
            raise ValueError("unterminated list")
        if t == ")":
            s.next()
            return out
        out.append(_parse_value_item(s))


def _parse_value_item(s: _Stream):
    t = s.next()
    if t == "(":
        return _parse_list(s)
    if t == "[":
        dims = []
        while s.peek() != "]":
            dims.append(_atom(s.next()))
        s.next()
        return ("dimensions", dims)
    if t == "{":
        return _parse_dict_body(s)
    return _atom(t)


def _parse_dict_body(s: _Stream) -> dict:
    d = {}
    while not s.eof():
        t = s.peek()
        if t == "}":
            s.next()
            return d
        key = s.next()
        key = _atom(key)
        nxt = s.peek()
        if nxt == "{":
            s.next()
            d[key] = _parse_dict_body(s)
            continue
        # value tokens until ';'
        vals = []
        while True:
            t = s.peek()
            if t is None:
                raise ValueError(f"unterminated entry for key {key!r}")
            if t == ";":
                s.next()
                break
            vals.append(_parse_value_item(s))
        d[key] = vals[0] if len(vals) == 1 else vals
    return d


def parse(text: str) -> dict:
    """Parse a full FoamFile document into a nested dict.

    The FoamFile header block (if present) is kept under key 'FoamFile'.
    """
    s = _Stream(tokenize(text))
    return _parse_dict_body(s)


def read(path: str) -> dict:
    with open(path) as fh:
        return parse(fh.read())


def expand_macros(value, scope: dict):
    """Resolve ``$name`` references against a scope dict (blockMeshDict
    style variable substitution)."""
    if isinstance(value, str) and value.startswith("$"):
        return scope[value[1:]]
    if isinstance(value, list):
        return [expand_macros(v, scope) for v in value]
    return value


def get_or_default(d: dict, key: str, default):
    """OpenFOAM ``getOrDefault`` semantics (``src/initCuda.H:50-57``)."""
    if key not in d:
        return default
    v = d[key]
    if isinstance(default, (int, float)) and isinstance(v, (int, float)):
        return type(default)(v)
    return v


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_HEADER = """\
/*--------------------------------*- C++ -*----------------------------------*\\
| =========                 |                                                 |
| \\\\      /  F ield         | cudaparticlesfoam_tpu                           |
|  \\\\    /   O peration     |                                                 |
|   \\\\  /    A nd           |                                                 |
|    \\\\/     M anipulation  |                                                 |
\\*---------------------------------------------------------------------------*/
"""


def _fmt_value(v, indent=0) -> str:
    pad = "    " * indent
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "dimensions":
        return "[" + " ".join(str(x) for x in v[1]) + "]"
    if isinstance(v, list):
        inner = " ".join(_fmt_value(x) for x in v)
        return f"({inner})"
    if isinstance(v, float):
        return f"{v:.12g}"
    return str(v)


def _write_dict(fh, d: dict, indent=0):
    pad = "    " * indent
    for k, v in d.items():
        if isinstance(v, dict):
            fh.write(f"{pad}{k}\n{pad}{{\n")
            _write_dict(fh, v, indent + 1)
            fh.write(f"{pad}}}\n")
        else:
            fh.write(f"{pad}{k} {_fmt_value(v, indent)};\n")


def write(path: str, d: dict, obj_name: str | None = None, cls: str = "dictionary"):
    """Write a dict as a FoamFile document."""
    out = dict(d)
    if "FoamFile" not in out:
        out = {
            "FoamFile": {
                "version": 2.0,
                "format": "ascii",
                "class": cls,
                "object": obj_name or "dictionary",
            },
            **out,
        }
    with open(path, "w") as fh:
        fh.write(_HEADER)
        _write_dict(fh, out)
