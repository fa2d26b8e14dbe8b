"""Config system: dataclass tree + optional YAML + dotted CLI overrides
(counterpart of ``mhla_tpu/utils/config.py``).

``parse_cli(cls, argv)`` builds ``cls()`` from its defaults, then a YAML file
if one is named, then ``--a.b.c=value`` overrides. ``yaml`` is imported only
when a YAML path is given or a config is dumped, so a machine without
PyYAML runs from the dataclass defaults plus overrides, and ``dump_config``
falls back to JSON there.
"""

from __future__ import annotations

import ast
import dataclasses
import json
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


def load_config(
    cls: Type[T], yaml_path: Optional[str] = None, overrides: Sequence[str] = ()
) -> T:
    """Build a config: defaults <- YAML <- ``--a.b=v`` CLI overrides."""
    data: Dict[str, Any] = {}
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
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
