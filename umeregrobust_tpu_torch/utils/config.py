"""Config system: flat YAML files merged into an argparse namespace, and
--set key=value overrides (the port's own copy of
umeregrobust_tpu/utils/config.py).

The benchmark and training configs are flat `key: value` files, so
`load_yaml_config` reads them with a small reader of its own instead of
PyYAML: scalars resolve as PyYAML's safe_load resolves them (YAML 1.1
booleans, null, ints, floats, quoted and plain strings), comments and
blank lines are skipped, and anything else (nesting, lists, flow
collections) raises ValueError.
"""
from __future__ import annotations

import argparse
import ast
import re
from typing import Any, Dict

__all__ = ["load_yaml_config", "update_namespace_from_yaml",
           "apply_overrides"]

_BOOL = {w: v for v, words in ((True, "yes true on"),
                               (False, "no false off"))
         for base in words.split()
         for w in (base, base.capitalize(), base.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
_KEY = re.compile(r"([A-Za-z_][\w.-]*)\s*:(\s|$)")


def _scalar(text: str, where: str) -> Any:
    """A plain or quoted YAML scalar, comment already stripped."""
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated quoted string")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"{where}: unterminated quoted string")
        return ast.literal_eval(text)
    if text and text[0] in "[{&*!|>%@`":
        raise ValueError(f"{where}: only flat scalar values are read")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    plain = text.replace("_", "")
    if _INT.match(text):
        return int(plain)
    if _OCT.match(text):
        return int(plain, 8)
    if _HEX.match(text):
        return int(plain, 16)
    if _FLOAT.match(text):
        return float(plain)
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _strip_comment(value: str) -> str:
    """The value without a trailing ` # comment` outside quotes."""
    quote, i = None, 0
    while i < len(value):
        ch = value[i]
        if quote == "'" and value.startswith("''", i):
            i += 1  # an escaped quote inside single quotes
        elif quote == '"' and ch == "\\":
            i += 1  # an escaped character inside double quotes
        elif quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and (i == 0 or value[i - 1].isspace()):
            quote = ch
        elif ch == "#" and (i == 0 or value[i - 1].isspace()):
            return value[:i]
        i += 1
    return value


def load_yaml_config(path: str) -> Dict[str, Any]:
    """The flat `key: value` mapping of a YAML config file."""
    out: Dict[str, Any] = {}
    with open(path, "r") as f:
        for n, line in enumerate(f, 1):
            where = f"{path}:{n}"
            body = line.rstrip("\r\n")
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            if body[0].isspace() or body.startswith(("- ", "---", "...")):
                raise ValueError(f"{where}: only a flat mapping is read")
            m = _KEY.match(body)
            if m is None:
                raise ValueError(f"{where}: expected `key: value`")
            key = m.group(1)
            if key in out:
                raise ValueError(f"{where}: duplicate key {key!r}")
            out[key] = _scalar(_strip_comment(body[m.end():]).strip(), where)
    return out


def update_namespace_from_yaml(args: argparse.Namespace, yaml_path: str):
    for key, value in load_yaml_config(yaml_path).items():
        setattr(args, key, value)
    return args


def apply_overrides(args: argparse.Namespace, overrides: list[str]):
    """--set key=value pairs; values parsed as python literals when
    possible, with YAML-style booleans/null accepted ('--set flag=false'
    must NOT become the truthy string \"false\")."""
    _YAML_WORDS = {"true": True, "false": False,
                   "null": None, "none": None}
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        if raw.strip().lower() in _YAML_WORDS:
            val = _YAML_WORDS[raw.strip().lower()]
        else:
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
        setattr(args, key.strip(), val)
    return args
