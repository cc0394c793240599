"""Desktop autostart plugin (copy of
``pybitmessage_tpu.plugins.desktop_autostart``, starting the port's
daemon; role of the reference's
``plugins/desktop_xdg.py`` + the Qt settings' start-on-login toggle).

Writes/removes an XDG autostart entry
(``~/.config/autostart/pybitmessage-tpu.desktop``) so the daemon starts
with the user session.  Non-XDG platforms simply report False.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ENTRY_NAME = "pybitmessage-tpu.desktop"

_TEMPLATE = """[Desktop Entry]
Type=Application
Name=PyBitmessage-TPU
Comment=Bitmessage node (TPU-native)
Exec={exec_line}
Terminal=false
X-GNOME-Autostart-enabled=true
"""


def _autostart_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return Path(base) / "autostart"


def connect_plugin(enable: bool = True, exec_line: str | None = None) -> bool:
    """Install (or remove, ``enable=False``) the autostart entry.
    Returns True when the filesystem reflects the requested state."""
    if not sys.platform.startswith(("linux", "freebsd")):
        return False
    path = _autostart_dir() / ENTRY_NAME
    if not enable:
        try:
            path.unlink(missing_ok=True)
            return True
        except OSError:
            return False
    exec_line = exec_line or f"{sys.executable} -m pybitmessage_tpu_torch -d"
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(_TEMPLATE.format(exec_line=exec_line))
        return True
    except OSError:
        return False
