"""Lazy re-exports for the package's ``__init__`` files.

A package's public names resolve on first access (PEP 562), so importing
`ray_lightning_tpu_torch` or a subpackage imports no torch and no module
of its own beyond the one asked for. A JAX name that the port does not
have raises `NotPortedError` naming its ROADMAP item or its reason.
"""
from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, Optional, Tuple


class NotPortedError(AttributeError, NotImplementedError):
    """A public name of the JAX package that the port does not have (yet).
    An `AttributeError`, so ``hasattr`` reads False, and a
    `NotImplementedError`, which is what it means."""


def lazy_exports(package: str, names: Dict[str, str],
                 missing: Optional[Dict[str, str]] = None
                 ) -> Tuple[Callable, Callable]:
    """(``__getattr__``, ``__dir__``) for ``package``.

    ``names`` maps a public name to ``"module"`` (the attribute of the
    same name in ``package.module``), ``"module:attr"`` or ``"module:"``
    (the submodule itself); ``missing`` maps a name to why it raises."""
    missing = dict(missing or {})

    def __getattr__(name: str):
        target = names.get(name)
        if target is None:
            if name in missing:
                raise NotPortedError(
                    f"{package}.{name} is not in the port: {missing[name]}")
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        mod, _, attr = target.partition(":")
        module = importlib.import_module(f"{package}.{mod}")
        if ":" in target and not attr:
            value = module
        else:
            value = getattr(module, attr or name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(names))

    return __getattr__, __dir__
