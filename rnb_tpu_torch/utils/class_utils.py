"""Dynamic class loading: the plugin mechanism behind string-named
stages and path iterators in the JSON configs."""

from __future__ import annotations

import importlib

PACKAGE = "rnb_tpu_torch"


def load_class(full_class_path: str):
    """Load a class from a dotted path like ``pkg.module.ClassName``.
    Only classes of this package load: a config naming anything else
    has not been ported."""
    module_path, _, class_name = full_class_path.rpartition(".")
    if not module_path:
        raise ValueError("expected a dotted class path, got %r"
                         % full_class_path)
    if module_path.split(".")[0] != PACKAGE:
        raise ValueError("%r is not a class of %s" % (full_class_path,
                                                      PACKAGE))
    module = importlib.import_module(module_path)
    try:
        return getattr(module, class_name)
    except AttributeError as e:
        raise ImportError("%r is not yet ported to %s: module %r has no "
                          "class %r" % (full_class_path, PACKAGE,
                                        module_path, class_name)) from e
