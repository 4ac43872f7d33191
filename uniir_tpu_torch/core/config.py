"""Hierarchical config with ``${a.b.c}`` interpolation (counterpart of uniir_tpu/core/config.py).

Same surface and semantics as the JAX package's `Config`; the difference is
that files are read and written by `core.yaml_subset`, not PyYAML, which
the GPU host does not have.  The JAX module cannot be imported as it is:
`uniir_tpu/core/__init__.py` pulls in jax and the module imports yaml at
the top.
"""

from __future__ import annotations

import copy
import re
from typing import Any

from uniir_tpu_torch.core import yaml_subset

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config:
    """A nested attribute-accessible config node."""

    def __init__(self, data: dict | None = None, root: "Config | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", root)
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    def _wrap(self, v: Any) -> Any:
        root = self._root or self
        if isinstance(v, dict):
            return Config(v, root=root)
        if isinstance(v, list):
            return [self._wrap(x) for x in v]
        return v

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        for k, v in d.items():
            cfg._data[k] = cfg._wrap(v)
        cfg._rebind_root(cfg)
        return cfg

    def _rebind_root(self, root: "Config") -> None:
        object.__setattr__(self, "_root", root)
        for v in self._data.values():
            if isinstance(v, Config):
                v._rebind_root(root)
            elif isinstance(v, list):
                for x in v:
                    if isinstance(x, Config):
                        x._rebind_root(root)

    def _resolve_path(self, dotted: str) -> Any:
        node: Any = self._root or self
        for part in dotted.split("."):
            if isinstance(node, Config):
                node = node._data[part]
            else:
                raise KeyError(dotted)
        return node

    def _interp(self, v: Any) -> Any:
        if isinstance(v, str) and "${" in v:
            m = _INTERP_RE.fullmatch(v)
            if m:  # a lone "${x}" keeps the referenced value's type
                return self._interp(self._resolve_path(m.group(1)))

            def repl(match: re.Match) -> str:
                out = self._interp(self._resolve_path(match.group(1)))
                return "" if out is None else str(out)

            return _INTERP_RE.sub(repl, v)
        return v

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return self._interp(data[name])
        raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self.__getattr__(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self.__setattr__(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self.__getattr__(key)
        except AttributeError:
            return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self.__getattr__(k)) for k in self._data]

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __deepcopy__(self, memo):
        return Config.from_dict(copy.deepcopy(self.to_dict(resolve=False), memo))

    def to_dict(self, resolve: bool = True) -> dict:
        out = {}
        for k, v in self._data.items():
            if isinstance(v, Config):
                out[k] = v.to_dict(resolve=resolve)
            elif isinstance(v, list):
                out[k] = [x.to_dict(resolve=resolve) if isinstance(x, Config) else (self._interp(x) if resolve else x) for x in v]
            else:
                out[k] = self._interp(v) if resolve else v
        return out

    def to_yaml(self, resolve: bool = False) -> str:
        return yaml_subset.dumps(self.to_dict(resolve=resolve))


def load_config(path: str) -> Config:
    """Load a YAML file into a Config."""
    return Config.from_dict(yaml_subset.load(path) or {})


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(cfg.to_yaml(resolve=False))


def parse_image_size(v) -> tuple:
    """Parse the reference's `image_size: 224, 224` YAML value (string or int)."""
    if isinstance(v, int):
        return (v, v)
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    parts = [p.strip() for p in str(v).split(",") if p.strip()]
    if len(parts) == 1:
        return (int(parts[0]), int(parts[0]))
    return tuple(int(p) for p in parts)
