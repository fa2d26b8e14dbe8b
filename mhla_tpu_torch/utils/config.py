"""Config system: dataclass tree + optional YAML + dotted CLI overrides
(counterpart of ``mhla_tpu/utils/config.py``).

``parse_cli(cls, argv)`` builds ``cls()`` from its defaults, then a YAML file
if one is named, then ``--a.b.c=value`` overrides. A config file is read by
:func:`read_simple_yaml` on every machine (the card has no PyYAML): the
block mappings, scalars and flow lists the files in ``configs/`` are made
of, and an error for anything else. ``dump_config`` writes YAML where
PyYAML is installed and JSON where it is not.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import typing
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _coerce(value: str) -> Any:
    """Parse a CLI string into a Python literal when possible."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none"):
            return None
        return value


def _from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Recursively build a dataclass from a dict (unknown keys rejected)."""
    try:  # resolve string annotations (from __future__ import annotations)
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = hints.get(k, fields[k].type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[k] = _from_dict(ftype, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_dict(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)  # dtypes and other objects YAML has no type for


def _apply_override(obj: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    target = obj
    for p in parts[:-1]:
        target = getattr(target, p)
    if not hasattr(target, parts[-1]):
        raise KeyError(f"unknown config path {dotted!r}")
    setattr(target, parts[-1], value)


_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")
_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")


def _yaml_error(n: int, raw: str, what: str) -> ValueError:
    return ValueError(f"config line {n}: {what} is outside the YAML subset read here: {raw!r}")


def _strip_comment(raw: str) -> str:
    """``raw`` up to a ``#`` that starts the line or follows a blank,
    outside a quoted scalar."""
    quote = None
    for i, ch in enumerate(raw):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and (i == 0 or raw[i - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
    return raw


def _yaml_scalar(text: str, n: int, raw: str) -> Any:
    """null / ~, true / false, an int, a float (``1e-4`` too), a quoted or a
    plain string, or a flow list of such scalars."""
    if not text:
        raise _yaml_error(n, raw, "an empty list item")
    if text[0] in "&*!|>{%@`" or text in ("-", "?"):
        raise _yaml_error(n, raw, "an anchor, alias, tag, block scalar or flow mapping")
    if text[0] == "[":
        inner = text[1:-1].strip() if text.endswith("]") else "["
        if any(c in inner for c in "[]{}'\""):
            raise _yaml_error(n, raw, "a nested or quoted flow list")
        return [_yaml_scalar(item.strip(), n, raw) for item in inner.split(",")] if inner else []
    if text[0] in "'\"":
        if len(text) < 2 or text[-1] != text[0]:
            raise _yaml_error(n, raw, "an unterminated quoted string")
        return json.loads(text) if text[0] == '"' else text[1:-1].replace("''", "'")
    lowered = text.lower()
    if lowered in ("null", "~"):
        return None
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("yes", "no", "on", "off", "y", "n"):
        raise _yaml_error(n, raw, "a YAML 1.1 boolean word")
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) or lowered in (".inf", "-.inf", "+.inf", ".nan"):
        return float(text.replace(".inf", "inf").replace(".nan", "nan"))
    if ": " in text or text.endswith(":"):
        raise _yaml_error(n, raw, "a second mapping on one line")
    if re.match(r"[-+]?\.?[0-9]", text):
        raise _yaml_error(n, raw, "a number, date or time form not read here (quote a string)")
    return text


def read_simple_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of the shipped configs: nested block mappings
    by indentation (spaces), ``key: scalar`` (see :func:`_yaml_scalar`),
    ``key:`` with an indented mapping or nothing (null) below, and ``#``
    comments. Anything else raises ``ValueError``: block sequences, several
    documents, anchors, tags, multi-line scalars, flow mappings, duplicate
    or quoted keys, uneven indentation. A float may be written ``1e-4``,
    which PyYAML would read as a string."""
    root: Dict[str, Any] = {}
    stack = [(0, root)]  # (indent of the mapping's keys, mapping)
    opened = None  # (mapping, key, indent) of a ``key:`` line
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body[0] == "\t":
            raise _yaml_error(n, raw, "a tab in the indentation")
        if body.startswith(("- ", "---", "...", "? ")) or body == "-":
            raise _yaml_error(n, raw, "a block sequence, document marker or complex key")
        if opened is not None:
            mapping, key, key_indent = opened
            if indent > key_indent:
                mapping[key] = {}
                stack.append((indent, mapping[key]))
            opened = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise _yaml_error(n, raw, "uneven indentation")
        key, sep, value = body.partition(":")
        if not sep or not _PLAIN_KEY.match(key) or (value and value[0] != " "):
            raise _yaml_error(n, raw, "a line that is not 'key: value' with a plain key")
        mapping = stack[-1][1]
        if key in mapping:
            raise _yaml_error(n, raw, f"a second {key!r}")
        value = value.strip()
        if value:
            mapping[key] = _yaml_scalar(value, n, raw)
        else:
            mapping[key] = None  # a mapping if indented lines follow
            opened = (mapping, key, indent)
    return root


def load_config(
    cls: Type[T], yaml_path: Optional[str] = None, overrides: Sequence[str] = ()
) -> T:
    """Build a config: defaults <- YAML <- ``--a.b=v`` CLI overrides."""
    data = read_simple_yaml(Path(yaml_path).read_text()) if yaml_path else {}
    cfg = _from_dict(cls, data)
    for ov in overrides:
        if not ov.startswith("--"):
            raise ValueError(f"override must look like --a.b=v, got {ov!r}")
        key, _, raw = ov[2:].partition("=")
        _apply_override(cfg, key, _coerce(raw))
    return cfg


def parse_cli(cls: Type[T], argv: Sequence[str]) -> T:
    """argv = [maybe config.yaml] + ["--a.b=v", ...]."""
    yaml_path = None
    overrides: List[str] = []
    for a in argv:
        if a.startswith("--config_path="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--"):
            overrides.append(a)
        elif yaml_path is None and a.endswith((".yaml", ".yml")):
            yaml_path = a
        else:
            raise ValueError(f"unrecognized argument {a!r}")
    return load_config(cls, yaml_path, overrides)


def dump_config(cfg: Any, path: str) -> None:
    """Write the resolved config to ``path``: YAML when PyYAML is there,
    JSON otherwise."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    try:
        import yaml

        p.write_text(yaml.safe_dump(_to_dict(cfg), sort_keys=False))
    except ImportError:
        p.write_text(json.dumps(_to_dict(cfg), indent=2, default=str))
