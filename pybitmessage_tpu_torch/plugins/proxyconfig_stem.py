"""Tor proxy auto-configuration (copy of
``pybitmessage_tpu.plugins.proxyconfig_stem``; analog of the reference's
``plugins/proxyconfig_stem.py:1-157``).

The reference uses the ``stem`` library to launch a private Tor and
optionally publish an ephemeral hidden service.  stem is not a
dependency here; this analog covers the same decision tree with the
standard library only:

- a REMOTE ``sockshostname`` is respected: just force SOCKS5 on;
- something already listening on ``socksport`` locally (a system Tor)
  is adopted as the proxy;
- otherwise, when a ``tor`` binary is on PATH, a private instance is
  launched with its own DataDirectory and adopted once bootstrapped;
- with ``sockslisten`` enabled and a control port reachable
  (``torcontrolport``, or the one a private launch opens), an
  EPHEMERAL HIDDEN SERVICE is created over the Tor control protocol
  (the stem ``create_ephemeral_hidden_service`` role,
  reference:110-155): a saved key from the settings is reused,
  otherwise ``ADD_ONION NEW:BEST`` runs and the returned key persists
  for the next start.

In every successful case the session settings are rewritten so the
connection pool dials through SOCKS5 at the configured endpoint
(remote DNS — hostname CONNECTs — is the default in network/socks.py,
so no lookups leak around Tor).  Note: v3 onion hostnames exceed the
protocol's 16-byte addr field, so the service address is reachable by
peers that know it (manual/trustedpeer dialing through Tor) but is not
flooded as an ONIONPEER object — the wire codec refuses to truncate
it (network/messages.py).
"""

from __future__ import annotations

import atexit
import logging
import shutil
import socket
import subprocess
import tempfile
import threading
import time

logger = logging.getLogger("pybitmessage_tpu_torch.plugins.stem")

#: private Tor child, kept for teardown
_tor_process: subprocess.Popen | None = None
#: control endpoint of the private tor (set only when we launch one)
_tor_control_port: int | None = None
_tor_cookie_path: str | None = None

BOOTSTRAP_TIMEOUT = 90.0


def _port_listening(host: str, port: int) -> bool:
    try:
        with socket.create_connection((host, port), timeout=2):
            return True
    except OSError:
        return False


class TorControlError(ConnectionError):
    """Control port refused a command."""


class TorControl:
    """Line-oriented Tor control-port client — the stem subset this
    plugin needs (AUTHENTICATE + ADD_ONION), spoken directly per
    control-spec.txt."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9051,
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout)
        self.f = self.sock.makefile("rwb")

    def close(self) -> None:
        try:
            self._cmd("QUIT")
        except Exception:
            pass
        self.sock.close()

    def _cmd(self, line: str) -> list[str]:
        """Send one command; return the reply lines (without codes).
        Raises on any non-250 final status."""
        self.f.write(line.encode() + b"\r\n")
        self.f.flush()
        lines = []
        while True:
            raw = self.f.readline()
            if not raw:
                raise TorControlError("control connection closed")
            text = raw.decode().rstrip("\r\n")
            code, sep, rest = text[:3], text[3:4], text[4:]
            lines.append(rest)
            if sep == " ":                       # terminal line
                if code != "250":
                    raise TorControlError(f"{code} {rest}")
                return lines

    def cookie_file(self) -> str | None:
        """Cookie path advertised by PROTOCOLINFO (pre-auth command) —
        how a cookie-authenticated system Tor is discovered."""
        try:
            for ln in self._cmd("PROTOCOLINFO 1"):
                if 'COOKIEFILE="' in ln:
                    return ln.split('COOKIEFILE="', 1)[1].split('"', 1)[0]
        except TorControlError:
            pass
        return None

    def authenticate(self, cookie_path: str | None = None) -> None:
        """Cookie auth when a cookie file is given or PROTOCOLINFO
        advertises one (the default for packaged system Tors), else
        NULL auth."""
        cookie_path = cookie_path or self.cookie_file()
        if cookie_path:
            with open(cookie_path, "rb") as f:
                cookie = f.read()
            self._cmd("AUTHENTICATE " + cookie.hex())
        else:
            self._cmd("AUTHENTICATE")

    def add_onion(self, ports: dict[int, int],
                  key: str = "NEW:BEST") -> tuple[str, str | None]:
        """Create an ephemeral hidden service; returns (service_id,
        private_key or None when a saved key was reused).

        ``Flags=Detach``: without it the service dies the moment this
        control connection closes (control-spec ADD_ONION semantics)."""
        mapping = " ".join(f"Port={virt},{real}"
                           for virt, real in ports.items())
        lines = self._cmd(f"ADD_ONION {key} Flags=Detach {mapping}")
        service_id = private_key = None
        for ln in lines:
            if ln.startswith("ServiceID="):
                service_id = ln[len("ServiceID="):]
            elif ln.startswith("PrivateKey="):
                private_key = ln[len("PrivateKey="):]
        if not service_id:
            raise TorControlError("ADD_ONION reply lacked ServiceID")
        return service_id, private_key


def _publish_hidden_service(settings, control_port: int,
                            cookie_path: str | None) -> bool:
    """stem create_ephemeral_hidden_service role (reference:110-155):
    reuse the persisted key when one exists, else NEW:BEST and persist
    the returned key; onionhostname lands in the session settings."""
    try:
        ctl = TorControl(port=control_port)
    except OSError as exc:
        logger.warning("cannot reach tor control port %d: %r",
                       control_port, exc)
        return False
    try:
        ctl.authenticate(cookie_path)
        saved_key = settings.get("onionservicekey", "")
        saved_type = settings.get("onionservicekeytype", "")
        key = f"{saved_type}:{saved_key}" if saved_key and saved_type \
            else "NEW:BEST"
        onion_port = settings.getint("onionport") or 8444
        local_port = settings.getint("port") or onion_port
        service_id, private_key = ctl.add_onion(
            {onion_port: local_port}, key)
        settings.set_temp("onionhostname", service_id + ".onion")
        if private_key and not (saved_key and saved_type):
            # persist so restarts keep the same onion address (also
            # repairs a half-saved key/type pair)
            ktype, _, kdata = private_key.partition(":")
            settings.set("onionservicekeytype", ktype)
            settings.set("onionservicekey", kdata)
            settings.save()
        logger.info("hidden service %s.onion -> local port %d",
                    service_id, local_port)
        return True
    except (TorControlError, OSError) as exc:
        logger.warning("hidden service setup failed: %r", exc)
        return False
    finally:
        ctl.close()


def _stop_tor() -> None:
    global _tor_process
    if _tor_process is not None and _tor_process.poll() is None:
        _tor_process.terminate()
        try:
            _tor_process.wait(10)
        except subprocess.TimeoutExpired:
            _tor_process.kill()
    _tor_process = None


def _launch_private_tor(port: int, control: bool = False) -> bool:
    """Start ``tor --SocksPort port`` (optionally with a control port
    for the hidden-service step) and wait for bootstrap.

    A daemon thread drains tor's stdout for the child's whole lifetime
    (a full pipe would block tor's log writes and wedge the proxy) and
    flags the bootstrap line; the deadline is enforced on an Event, not
    on a blocking readline."""
    global _tor_process, _tor_control_port, _tor_cookie_path
    tor = shutil.which("tor")
    if tor is None:
        return False
    datadir = tempfile.mkdtemp(prefix="bmtor-")
    argv = [tor, "--SocksPort", str(port), "--DataDirectory", datadir,
            "--Log", "notice stdout"]
    if control:
        # a control port (cookie-authenticated) lets the hidden-service
        # step run against this private instance (reference tor_config
        # ControlSocket role).  'auto' + WriteToFile: a fixed port+1
        # could collide and abort the whole proxy setup
        _tor_cookie_path = f"{datadir}/control_auth_cookie"
        argv += ["--ControlPort", "auto",
                 "--ControlPortWriteToFile", f"{datadir}/controlport",
                 "--CookieAuthentication", "1"]
    try:
        _tor_process = subprocess.Popen(
            argv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError:
        return False
    atexit.register(_stop_tor)
    proc = _tor_process
    bootstrapped = threading.Event()

    def drain() -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            logger.debug("(tor) %s", line.rstrip())
            if "Bootstrapped 100%" in line:
                bootstrapped.set()

    threading.Thread(target=drain, daemon=True,
                     name="bmtpu-tor-log-drain").start()
    if bootstrapped.wait(BOOTSTRAP_TIMEOUT):
        logger.info("private tor bootstrapped on port %d", port)
        if control:
            try:
                text = open(f"{datadir}/controlport").read()
                # format: "PORT=127.0.0.1:NNNN"
                _tor_control_port = int(text.strip().rsplit(":", 1)[1])
            except (OSError, ValueError, IndexError):
                logger.warning("could not read tor's auto control "
                               "port; hidden service unavailable")
                _tor_control_port = None
        return True
    if proc.poll() is not None:
        logger.warning("private tor exited during bootstrap")
    else:
        logger.warning("private tor bootstrap timed out")
    _stop_tor()
    return False


def connect_plugin(settings) -> bool:
    """Configure (or launch) a Tor SOCKS5 proxy per the settings —
    mirrors the reference connect_plugin's decision tree."""
    host = settings.get("sockshostname", "")
    if host not in ("", "localhost", "127.0.0.1"):
        # remote proxy chosen for outbound connections: nothing to
        # launch, but the dial path must treat it as SOCKS5
        settings.set_temp("sockstype", "SOCKS5")
        logger.info("remote sockshostname set; using it as SOCKS5 proxy")
        return True
    port = settings.getint("socksport") or 9050
    want_service = settings.getbool("sockslisten")
    launched = False
    if not _port_listening("127.0.0.1", port):
        if not _launch_private_tor(port, control=want_service):
            logger.warning(
                "no SOCKS proxy on 127.0.0.1:%d and no tor binary to "
                "launch one; leaving proxy settings untouched", port)
            return False
        launched = True
    else:
        logger.info("adopting already-running SOCKS proxy on port %d", port)
    settings.set_temp("sockshostname", "127.0.0.1")
    settings.set_temp("socksport", port)
    settings.set_temp("sockstype", "SOCKS5")
    if want_service:
        # inbound reachability: ephemeral hidden service over the
        # control port — ours if we launched tor, else the configured
        # torcontrolport of the adopted instance (0 = unavailable)
        if launched and _tor_control_port:
            _publish_hidden_service(settings, _tor_control_port,
                                    _tor_cookie_path)
        elif settings.getint("torcontrolport"):
            _publish_hidden_service(settings,
                                    settings.getint("torcontrolport"),
                                    None)
        else:
            logger.warning(
                "sockslisten requested but no control port for the "
                "adopted tor (set torcontrolport); no hidden service")
    return True
