"""Config system, port of ``iuvl_tpu/config.py``: stacked YAML -> nested
dict with dotted-key CLI overrides.

Later YAML files override earlier ones key by key (a recursive dict merge),
and ``--overrides KEY VALUE ...`` pairs apply dotted-path updates whose
string values are coerced to the type of the value they replace. The
loaded config is a plain nested dict.
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Any, Iterable, Mapping

import yaml


def deep_merge(base: dict, extra: Mapping) -> dict:
    """Recursively merge ``extra`` into ``base`` (in place), returning base.

    Scalar/list values in ``extra`` replace those in ``base``; nested dicts
    merge key-by-key.
    """
    for k, v in extra.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def set_dotted(cfg: dict, key: str, value: Any) -> None:
    """Set ``cfg['a']['b']['c'] = value`` for key ``'a.b.c'``, creating
    intermediate dicts as needed."""
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise TypeError(f"override path {key!r} hits non-dict at {p!r}")
    node[parts[-1]] = value


def get_dotted(cfg: Mapping, key: str, default: Any = None) -> Any:
    node: Any = cfg
    for p in key.split("."):
        if not isinstance(node, Mapping) or p not in node:
            return default
        node = node[p]
    return node


def coerce_like(old: Any, raw: str) -> Any:
    """Coerce a string override to the type of the existing value.

    bool accepts true/false/1/0/yes/no strings; int/float parsed;
    lists/dicts parsed as YAML; a None value takes a JSON literal when the
    string is one; otherwise kept as string.
    """
    if isinstance(old, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot coerce {raw!r} to bool")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, (list, dict)):
        return yaml.safe_load(raw)
    if old is None:
        # Best effort: try JSON literal, else string.
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            return raw
    return raw


def load_config(
    conf_files: Iterable[str] = (),
    overrides: Iterable[str] = (),
    base: dict | None = None,
) -> dict:
    """Load stacked YAML files and apply paired dotted-key overrides."""
    cfg: dict = dict(base) if base else {}
    for path in conf_files:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        deep_merge(cfg, loaded)

    ov = list(overrides)
    if len(ov) % 2 != 0:
        raise ValueError("--overrides expects KEY VALUE pairs")
    for key, raw in zip(ov[::2], ov[1::2]):
        old = get_dotted(cfg, key)
        set_dotted(cfg, key, coerce_like(old, str(raw)))
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    """The command line: a command, stacked YAML files and paired dotted
    overrides."""
    p = argparse.ArgumentParser(description="iuvl_tpu_torch entry")
    p.add_argument("command", choices=["train", "evaluate", "bench"])
    p.add_argument("--conf_files", nargs="+", default=[], help="stacked YAML configs")
    p.add_argument(
        "--overrides",
        nargs=argparse.REMAINDER,
        default=[],
        help="paired dotted-key overrides: KEY VALUE [KEY VALUE ...]",
    )
    return p


def load_opt_command(argv: list[str] | None = None):
    """Parse CLI args and return (cfg, args)."""
    args = build_arg_parser().parse_args(argv)
    cfg = load_config(args.conf_files, args.overrides)
    return cfg, args
