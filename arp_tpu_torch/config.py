"""Plain configuration tree for the port (stands in for ``ml_collections.ConfigDict``).

``Config`` is a dict with attribute access; :func:`update_config` merges an
update tree into it, nested mappings into nested ``Config``s, as
``ConfigDict.update`` does.  :func:`parse_flag_tree` reads a CLI's flags into
such a tree, as the JAX package's absl flags with dotted nested names.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional


class Config(dict):
    """A dict whose keys read and write as attributes; nested mappings become ``Config``s."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for key, value in dict(*args, **kwargs).items():
            self[key] = value

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    def copy(self) -> "Config":
        return Config({k: v.copy() if isinstance(v, Config) else v for k, v in self.items()})


def update_config(config: Config, updates: Optional[Mapping]) -> Config:
    """Apply a (possibly None) update tree to a default config, merging nested mappings."""
    if updates is not None:
        for key, value in updates.items():
            if isinstance(value, Mapping) and isinstance(config.get(key), Config):
                update_config(config[key], value)
            else:
                config[key] = value.copy() if isinstance(value, Config) else value
    return config


def _parse_bool(text: str) -> bool:
    low = text.lower()
    if low in ("true", "1", "yes"):
        return True
    if low in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def flag_leaves(tree: Mapping, prefix: str = ""):
    """(dotted name, value) of every leaf of a flag tree."""
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from flag_leaves(value, name + ".")
        else:
            yield name, value


def _converter(default):
    if isinstance(default, bool):
        return _parse_bool
    if isinstance(default, int):
        return int
    if isinstance(default, float):
        return float
    return str


def parse_flag_tree(defaults: Mapping, argv=None, description: str = "") -> Config:
    """``defaults`` as a Config tree with every ``--name[.sub]=value`` (or ``--name value``) of
    ``argv`` applied, each converted to its default's type; a bare boolean flag means True."""
    flags = Config(defaults)
    parser = argparse.ArgumentParser(description=description)
    for name, default in flag_leaves(flags):
        kind = _converter(default)
        extra = dict(nargs="?", const=True) if kind is _parse_bool else {}
        parser.add_argument(f"--{name}", dest=name, type=kind, default=argparse.SUPPRESS, **extra)
    for name, value in vars(parser.parse_args(argv)).items():
        *path, leaf = name.split(".")
        node = flags
        for part in path:
            node = node[part]
        node[leaf] = value
    return flags
