"""Plugin discovery via package entry points (copy of
``pybitmessage_tpu.core.plugins``).

Reference: src/plugins/plugin.py:1-46 + setup.py:157-180 — frontends
and integrations register under ``bitmessage.*`` entry-point groups
(gui.menu, notification.message, notification.sound, indicator,
desktop, proxyconfig) and the app loads the first one that imports
cleanly.  Re-design on ``importlib.metadata`` (pkg_resources is gone
in modern Python); the group vocabulary is kept so existing plugin
packages port by renaming only their entry-point module.
"""

from __future__ import annotations

import logging
from importlib.metadata import entry_points

logger = logging.getLogger("pybitmessage_tpu_torch.plugins")

GROUP_PREFIX = "bitmessage"
#: the JAX package, whose entry points this package never loads
JAX_PACKAGE = "pybitmessage_tpu"

#: groups the reference declares (setup.py:157-180)
KNOWN_GROUPS = (
    "gui.menu", "notification.message", "notification.sound",
    "indicator", "desktop", "proxyconfig",
)


def iter_plugins(group: str):
    """Yield (name, loaded object) for every plugin in a group:
    entry-point-registered packages first (but the JAX package's), then
    the shipped builtins
    (..plugins.BUILTIN — available even from a bare checkout where no
    dist metadata exists)."""
    seen = set()
    try:
        eps = entry_points().select(group=f"{GROUP_PREFIX}.{group}")
    except Exception:
        eps = ()
    for ep in eps:
        if ep.value.split(".", 1)[0].split(":", 1)[0] == JAX_PACKAGE:
            # the JAX package's shipped plugins: this package has its
            # own copies among the builtins
            continue
        try:
            obj = ep.load()
        except Exception:
            logger.warning("plugin %s.%s failed to load",
                           group, ep.name, exc_info=True)
            continue
        seen.add(ep.name)
        yield ep.name, obj
    from ..plugins import iter_builtin
    for name, obj in iter_builtin(group):
        if name not in seen:
            yield name, obj


def get_plugin(group: str, name: str | None = None):
    """First working plugin in a group, optionally by name
    (reference plugin.get_plugin semantics)."""
    for ep_name, obj in iter_plugins(group):
        if name is None or ep_name == name:
            return obj
    return None


def start_proxyconfig(settings) -> bool:
    """Run the configured proxyconfig plugin and return True when one
    ran successfully (reference helper_startup.start_proxyconfig).

    The reference overloads ``socksproxytype``: values other than the
    literal protocols name a proxyconfig plugin ('stem' launches a
    private Tor and rewrites the socks settings).  Our ``sockstype``
    key follows the same convention."""
    ptype = settings.get("sockstype", "")
    if not ptype or ptype in ("none", "SOCKS5", "SOCKS4a"):
        return False
    plugin = get_plugin("proxyconfig", ptype)
    if plugin is None:
        logger.warning("no proxyconfig plugin named %r", ptype)
        return False
    try:
        # reference-convention plugins return None on success — only an
        # explicit False (or an exception) means the proxy is NOT up
        return plugin(settings) is not False
    except Exception:
        logger.exception("proxyconfig plugin %r failed", ptype)
        return False
