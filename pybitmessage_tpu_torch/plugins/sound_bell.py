"""Notification sound plugin (copy of ``pybitmessage_tpu.plugins.sound_bell``;
role of the reference's
``plugins/sound_playfile.py`` / ``sound_canberra.py``).

The reference tries winsound, then external players picked by file
extension.  Headless/server images rarely have audio at all, so the
fallback chain here ends at the terminal bell — which still reaches
the user over SSH.  ``connect_plugin(sound_file)`` keeps the reference
entry-point signature; pass "" to just ring.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

#: external players by extension (reference sound_playfile.py order)
_PLAYERS = {
    ".wav": ("paplay", "aplay", "gst-play-1.0", "gst123"),
    ".mp3": ("paplay", "mpg123", "mpg321", "gst-play-1.0", "gst123"),
    ".ogg": ("paplay", "gst-play-1.0", "gst123"),
}


def connect_plugin(sound_file: str = "") -> bool:
    """Play the file if a player exists, else ring the terminal bell.
    Returns True when some audible action was taken."""
    if sound_file and os.path.exists(sound_file):
        ext = os.path.splitext(sound_file)[1].lower()
        for player in _PLAYERS.get(ext, ("paplay",)):
            exe = shutil.which(player)
            if exe is None:
                continue
            try:
                subprocess.Popen([exe, sound_file],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
                return True
            except OSError:
                continue
    try:
        sys.stdout.write("\a")
        sys.stdout.flush()
        return True
    except Exception:
        return False
