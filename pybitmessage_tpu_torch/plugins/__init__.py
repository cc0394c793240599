"""Shipped plugins (copy of ``pybitmessage_tpu.plugins``; role of the
reference's ``src/plugins/`` package).

The reference distributes ~10 small integrations (stem/Tor proxy
config, notification sounds, qrcode dialog, desktop autostart,
indicators) registered as ``bitmessage.*`` entry points
(setup.py:157-180).  This package is the in-tree analog: the same
group vocabulary, loadable through :mod:`..core.plugins` either via
installed entry-point metadata or — because this framework is often
run straight from a checkout where no dist metadata exists — via the
:data:`BUILTIN` registry below.

Each value is an import path ``module:attr`` relative to this package,
resolved lazily so an unimportable plugin (missing optional dependency,
platform mismatch) never breaks the others.
"""

from __future__ import annotations

import importlib
import logging

logger = logging.getLogger("pybitmessage_tpu_torch.plugins")

#: group -> name -> "module:attr" (same groups as core.plugins
#: KNOWN_GROUPS / reference setup.py:157-180)
BUILTIN: dict[str, dict[str, str]] = {
    "proxyconfig": {
        "stem": "proxyconfig_stem:connect_plugin",
    },
    "notification.sound": {
        "bell": "sound_bell:connect_plugin",
    },
    "gui.menu": {
        "qrcode": "qrcode_menu:connect_plugin",
    },
    "desktop": {
        "autostart": "desktop_autostart:connect_plugin",
    },
}


def load_builtin(group: str, name: str):
    """Resolve a BUILTIN registry entry; None when absent/unimportable."""
    spec = BUILTIN.get(group, {}).get(name)
    if spec is None:
        return None
    modname, _, attr = spec.partition(":")
    try:
        mod = importlib.import_module(f"{__name__}.{modname}")
        return getattr(mod, attr)
    except Exception:
        logger.warning("builtin plugin %s.%s failed to load",
                       group, name, exc_info=True)
        return None


def iter_builtin(group: str):
    """Yield (name, loaded object) for the group's builtin plugins."""
    for name in BUILTIN.get(group, {}):
        obj = load_builtin(group, name)
        if obj is not None:
            yield name, obj
