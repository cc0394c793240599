"""Address-QR plugin (copy of ``pybitmessage_tpu.plugins.qrcode_menu``;
role of the reference's ``plugins/menu_qrcode.py``).

The reference renders a Qt dialog with a QR of ``bitmessage:<address>``
via the third-party ``qrcode`` package.  This analog sits on the
in-tree :mod:`..utils.qr` encoder and returns *renderings* — terminal
text and SVG — so every frontend (TUI, tkinter GUI, API client) can
show the same QR without a Qt dependency.
"""

from __future__ import annotations

from ..utils.qr import encode, render_svg, render_text


def connect_plugin(address: str) -> dict:
    """QR renderings for an address; the ``bitmessage:`` URI scheme
    matches the reference dialog's payload."""
    matrix = encode("bitmessage:" + address)
    return {
        "uri": "bitmessage:" + address,
        "text": render_text(matrix),
        "svg": render_svg(matrix),
        "modules": len(matrix),
    }
