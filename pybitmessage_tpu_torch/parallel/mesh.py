"""Shard meshes for the multi-device PoW tiers (twin of
``parallel/mesh.py``).

A :class:`DeviceMesh` lays shard devices out over named axes as the JAX
``Mesh`` does: 1D ``("nonce",)`` or 2D ``(obj_axis, "nonce")``, read
through ``axis_names``, ``shape[name]`` and ``devices.size``.  A shard
is one place a slab runs: its device and, on CUDA, its own
``torch.cuda.Stream``.  A device may repeat, so several shards can share
one card, each on its own stream; ``"cpu"`` shards run the kernels'
plain versions.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Shard:
    """One place of the mesh: ``index`` in row-major order, its
    coordinate on the object axis (0 on a 1D mesh) and on the nonce
    axis, its device and its CUDA stream (``None`` on the CPU)."""

    index: int
    obj: int
    nonce: int
    device: torch.device
    stream: "torch.cuda.Stream | None"

    def scope(self):
        """Context in which the shard's launches and allocations go to
        its own stream, so the caching allocator never hands one
        shard's buffer to another stream still reading it."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


class DeviceMesh:
    """Shard devices over named axes (what the PoW tiers read of a JAX
    ``Mesh``)."""

    def __init__(self, devices: list, axis_names: tuple, grid: tuple):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid))
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = devices
        self.devices = self.devices.reshape(grid)
        nonce_devs = grid[-1]
        self.shards = [
            Shard(i, i // nonce_devs, i % nonce_devs, dev,
                  torch.cuda.Stream(device=dev) if dev.type == "cuda"
                  else None)
            for i, dev in enumerate(devices)]

    def __repr__(self) -> str:
        return "DeviceMesh(%s, %s)" % (
            dict(self.shape), [str(d) for d in self.devices.flat])


def _shard_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, axis: str = "nonce",
              obj_axis: str | None = None, obj_size: int = 1,
              devices=None) -> DeviceMesh:
    """A mesh over the first ``n_devices`` of ``devices``.

    ``devices`` defaults to every CUDA card (``cuda:0`` ...), and without
    a card that raises ``RuntimeError``.  A device may repeat: four
    shards of ``cuda:0`` run on one card, each on its own stream.  1D by
    default (every shard on the nonce axis); with ``obj_axis`` the
    shards form ``obj_size`` rows, objects split over the rows and each
    object's nonce range over a row.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu', ...] to run the "
                "plain torch versions of the kernels")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devices = [_shard_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError("%d shards asked of %d devices"
                         % (n_devices, len(devices)))
    devices = devices[:n_devices]
    if obj_axis is None:
        return DeviceMesh(devices, (axis,), (n_devices,))
    if n_devices % obj_size:
        raise ValueError("%d shards do not split into %d object rows"
                         % (n_devices, obj_size))
    return DeviceMesh(devices, (obj_axis, axis),
                      (obj_size, n_devices // obj_size))
