"""Process/application environment plumbing (copy of
``pybitmessage_tpu.core.appenv``: the same appdata directory and the same
``singleton.lock``, so a JAX daemon and a port daemon never hold one data
directory at once).

Reference counterparts: ``paths.py`` (BITMESSAGE_HOME / XDG appdata
resolution), ``singleinstance.py`` (pid lockfile so two daemons never
share one data directory), and the daemonize double-fork in
``bitmessagemain.py:289-341``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def appdata_dir() -> Path:
    """Default data directory (reference paths.lookupAppdataFolder).

    Order: $BITMESSAGE_HOME, $XDG_CONFIG_HOME/pybitmessage-tpu,
    ~/.config/pybitmessage-tpu.
    """
    env = os.environ.get("BITMESSAGE_HOME")
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CONFIG_HOME")
    base = Path(xdg) if xdg else Path.home() / ".config"
    return base / "pybitmessage-tpu"


class SingleInstanceError(RuntimeError):
    pass


class SingleInstance:
    """Advisory pid lockfile (reference singleinstance.py:1-105).

    Guarantees one daemon per data directory; the lock dies with the
    process, so a crashed daemon never needs manual cleanup.
    """

    def __init__(self, data_dir: str | os.PathLike):
        self.path = Path(data_dir) / "singleton.lock"
        self._fd: int | None = None

    def acquire(self) -> None:
        import fcntl

        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            # flock, not lockf: flock conflicts between separate opens
            # even within one process, so tests (and a buggy double
            # construction) behave the same as two real daemons
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            pid = ""
            try:
                pid = self.path.read_text().strip()
            except OSError:
                pass
            raise SingleInstanceError(
                "another instance%s already holds %s"
                % (f" (pid {pid})" if pid else "", self.path))
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._fd = fd

    def release(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
                self.path.unlink(missing_ok=True)
            except OSError:
                pass
            self._fd = None

    def __enter__(self) -> "SingleInstance":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def daemonize() -> None:  # pragma: no cover - forks away from pytest
    """Classic double-fork detach (reference bitmessagemain.py:289-341)."""
    if os.fork() > 0:
        os._exit(0)
    os.setsid()
    if os.fork() > 0:
        os._exit(0)
    os.chdir("/")
    os.umask(0o077)
    sys.stdout.flush()
    sys.stderr.flush()
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(devnull, fd)
