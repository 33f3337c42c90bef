"""Global configuration tree (the port's own copy).

Counterpart of ``veles_tpu/config.py``, trimmed to what the port
reads: a global ``root`` Config with dot-notation access, auto-vivified
sub-trees, deep ``update``, and the command line's ``root.x.y=value``
overrides (:func:`parse_overrides`).  Config files are plain Python
executed for their side effect on ``root``
(:func:`launcher.apply_config_file`).  ``root.common.data_dir`` is where
``datasets.py`` looks for data files (default ``~/.veles_tpu/data``).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterator, List


class Config:
    """A node of the configuration tree.  Reads of a missing attribute
    create an empty sub-Config, so config files may write
    ``root.a.b.c = 1`` without declaring intermediates."""

    __slots__ = ("__dict__", "_name")

    def __init__(self, name: str = "root", **kwargs: Any) -> None:
        object.__setattr__(self, "_name", name)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        child = Config(f"{self._name}.{name}")
        self.__dict__[name] = child
        return child

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "_name":   # the slot (copy.deepcopy restores it here)
            object.__setattr__(self, name, value)
            return
        if isinstance(value, dict):
            node = Config(f"{self._name}.{name}")
            node.update(value)
            value = node
        self.__dict__[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def __iter__(self) -> Iterator[str]:
        return iter(self.__dict__)

    def __bool__(self) -> bool:
        return bool(self.__dict__)

    def __repr__(self) -> str:
        return f"Config({self._name}: {list(self.__dict__)})"

    def update(self, tree: Dict[str, Any]) -> "Config":
        """Deep-merge a nested dict (or another Config) into this node."""
        items = tree.__dict__.items() if isinstance(tree, Config) \
            else tree.items()
        for k, v in items:
            if isinstance(v, (dict, Config)) and isinstance(
                    self.__dict__.get(k), Config):
                self.__dict__[k].update(v)
            else:
                setattr(self, k, v)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        """Read without auto-vivifying."""
        return self.__dict__.get(name, default)

    def todict(self) -> Dict[str, Any]:
        return {k: v.todict() if isinstance(v, Config) else v
                for k, v in self.__dict__.items()}

    def apply_override(self, dotted: str, value: str) -> None:
        """Apply one ``path.to.key=value`` override (the value parsed as
        a Python literal when it is one, else kept as a string)."""
        *path, leaf = dotted.split(".")
        node: Config = self
        for p in path:
            node = getattr(node, p)
        try:
            parsed = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            parsed = value
        setattr(node, leaf, parsed)

    def print_(self, indent: int = 0, file=None) -> None:
        """Print the tree, keys sorted, as the reference's
        ``--dump-config`` does."""
        for k, v in sorted(self.__dict__.items()):
            if isinstance(v, Config):
                print("  " * indent + f"{k}:", file=file)
                v.print_(indent + 1, file=file)
            else:
                print("  " * indent + f"{k} = {v!r}", file=file)


#: The global configuration tree every workflow/config file mutates.
root = Config("root")


def is_override(arg: str) -> bool:
    """Whether a command-line argument is a ``root.x.y=value`` override."""
    return arg.startswith("root.") and "=" in arg


def parse_overrides(args: List[str]) -> List[str]:
    """Apply every ``root.x.y=value`` argument to ``root``; return the
    other arguments."""
    remaining = []
    for a in args:
        if is_override(a):
            dotted, _, value = a.partition("=")
            root.apply_override(dotted[len("root."):], value)
        else:
            remaining.append(a)
    return remaining
