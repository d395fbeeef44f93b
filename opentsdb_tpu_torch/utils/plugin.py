"""Plugin loading (ref: ``src/utils/PluginLoader.java:66``; the JAX
package's ``utils/plugin.py``).

A plugin is a Python class named by its dotted path in a config key,
e.g.::

    tsd.rtpublisher.plugin = mypkg.mymod.MyPublisher
    tsd.rtpublisher.enable = true

Each class is built with no arguments, then ``initialize(arg)`` is
called once when the instance has it. Every plugin ABI of
:mod:`opentsdb_tpu_torch.plugins`, the HTTP serializer and the
histogram codecs load through here.
"""

from __future__ import annotations

import importlib
from typing import Any


def load_class(dotted_path: str) -> type:
    """The class at ``package.module.Class``; ValueError for a path
    without a module, ImportError for a missing module or class."""
    module_name, _, class_name = dotted_path.rpartition(".")
    if not module_name:
        raise ValueError(f"invalid plugin path {dotted_path!r}")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, class_name)
    except AttributeError:
        raise ImportError(
            f"module {module_name!r} has no class {class_name!r}") from None


# the reference's plugin slots, by config key prefix: the TSDB loads
# the first six when it is built (TSDB.initialize_plugins), the command
# line's ``tsd`` the startup and RPC plugins, the HTTP router the
# /plugin endpoints
PLUGIN_SLOTS = ("tsd.rtpublisher", "tsd.search",
                "tsd.core.storage_exception_handler",
                "tsd.core.write_filter", "tsd.uid.filter",
                "tsd.core.meta.cache", "tsd.startup", "tsd.rpc",
                "tsd.http.rpc")

_MISSING = object()


def load_plugin_instances(config, prefix: str, single: bool = False,
                          init_arg: Any = _MISSING) -> Any:
    """The plugins named at ``<prefix>.plugin`` (comma-separated) when
    ``<prefix>.enable`` is true: one instance or None with ``single``,
    else a list. ``initialize`` gets ``init_arg``: the TSDB for the
    runtime ABIs, the config for a startup plugin, which runs before
    the TSDB exists (ref: TSDMain.java:251); by default the config.

    The keys under an enabled slot's prefix belong to its plugin:
    :meth:`Config.unknown_keys` does not warn of them."""
    if not config.get_bool(f"{prefix}.enable", False):
        return None if single else []
    spec = config.get_string(f"{prefix}.plugin", "")
    if not spec:
        return None if single else []
    target = config if init_arg is _MISSING else init_arg
    instances = []
    for path in spec.split(","):
        inst = load_class(path.strip())()
        if hasattr(inst, "initialize"):
            inst.initialize(target)
        instances.append(inst)
    if single:
        return instances[0] if instances else None
    return instances
