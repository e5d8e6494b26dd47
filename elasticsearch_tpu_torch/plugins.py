"""Plugin SPI: load extension modules into a node.

Re-designs the reference's plugin architecture (ref: plugins/Plugin.java,
plugins/PluginsService.java — classpath jars implementing extension
points) as importable Python modules: `plugins: ["pkg.module", ...]` in
node settings (or ES_TPU_PLUGINS env, comma-separated) names modules
exposing `install(node)`. Extension points are the live registries the
node already exposes:

    node.ingest (PROCESSORS registry)       — ingest processors
    analysis.AnalysisRegistry._BUILTIN      — analyzers
    rest controller via install(node, rc)   — REST handlers (optional 2-arg)
    search.queries parse table              — query types (module-level)

A plugin that raises at install time fails node startup loudly (the
reference's policy: a broken plugin must not half-load).
"""

from __future__ import annotations

import importlib
from typing import List

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError
from elasticsearch_tpu_torch.common.settings import knob


class PluginError(ElasticsearchTpuError):
    status = 500
    error_type = "plugin_exception"


def plugin_modules(settings) -> List[str]:
    names = []
    raw = settings.raw("plugins") if settings is not None else None
    if isinstance(raw, str):
        names.extend(p for p in raw.split(",") if p)
    elif isinstance(raw, (list, tuple)):
        names.extend(raw)
    env = knob("ES_TPU_PLUGINS")
    names.extend(p for p in env.split(",") if p)
    return names


def load_plugins(node, rest_controller=None) -> List[str]:
    """Import + install every configured plugin; returns their names."""
    loaded = []
    for name in plugin_modules(getattr(node, "settings", None)):
        try:
            module = importlib.import_module(name)
        except ImportError as e:
            raise PluginError(f"failed to load plugin [{name}]: {e}")
        install = getattr(module, "install", None)
        if install is None:
            raise PluginError(
                f"plugin [{name}] does not define install(node)")
        try:
            if rest_controller is not None and \
                    install.__code__.co_argcount >= 2:
                install(node, rest_controller)
            else:
                install(node)
        except Exception as e:  # noqa: BLE001 — fail startup loudly
            raise PluginError(f"plugin [{name}] failed to install: {e}")
        loaded.append(name)
    node.plugins = loaded
    return loaded
