"""Plain configuration tree for the port (stands in for ``ml_collections.ConfigDict``).

``Config`` is a dict with attribute access; :func:`update_config` merges an
update tree into it, nested mappings into nested ``Config``s, as
``ConfigDict.update`` does.
"""

from __future__ import annotations

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
