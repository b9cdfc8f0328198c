"""Lazy package exports (PEP 562), as ``nfs_tpu/__init__.py`` has them:
a package names what it exports and from which module, and a name's
module is imported when the name is first read, so importing the
package stays light and starts no import cycle."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple


def lazy_exports(package: str, exports: Dict[str, Tuple[str, str]]):
    """``(__all__, __getattr__)`` for ``package``: ``exports`` maps each
    exported name to (module, attribute)."""
    def __getattr__(name):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module, attr = exports[name]
        return getattr(importlib.import_module(module), attr)

    return list(exports), __getattr__
