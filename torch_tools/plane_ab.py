#!/usr/bin/env python3
"""What the network plane costs the node over sockets and the PoW farm.

    python3 torch_tools/plane_ab.py [--phase sockets|farm]
                                    [--order on,off,off,on] [--seed N]
                                    [--report PATH]

Runs one phase of ``chip_smoke.py`` once per entry of ``--order``,
every run on the same inputs (a generator seeded with ``--seed``).
``on`` runs every node with its defaults (sync, the wire trace and
federation on); ``off`` with all three off, the wire format and the
work of a node without the plane.

- ``sockets``: ``phase_sockets`` (phase 6: (k) B dials A and runs
  getpubkey -> pubkey -> msg -> ack and a broadcast; (l) a line
  A - R - B carrying 256 + 64 1 KB messages and their acks), its
  ``Node()``s built with ``sync_enabled``, ``wiretrace_enabled`` and
  ``federation_enabled`` false when off.  Per run: (k)'s message and
  broadcast walls and (l)'s walls (B's first object, B's inbox
  complete, the acks back at A), B's ingest rate and R's rate from A.
- ``farm``: ``phase_farm`` (phase 8: farm F serving 8 tenants' storm,
  E delegating to it, F's SIGKILL and resume), every daemon started
  with ``--set syncenabled=false --set wiretrace=false --set
  federation=off`` when off.  Per run: the storm's wall, the bulk
  lane's jobs/s, E's delegated send and the resumed answer's wall.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from pybitmessage_tpu_torch.powfarm.protocol import LANE_BULK  # noqa: E402

OFF = {"sync_enabled": False, "wiretrace_enabled": False,
       "federation_enabled": False}
#: the same three switches, for a daemon
OFF_FLAGS = ("--set", "syncenabled=false", "--set", "wiretrace=false",
             "--set", "federation=off")


def run_farm(plane: str, seed: int) -> dict:
    """One phase 8 with every daemon's network plane ``on`` or ``off``."""
    argv = chip_smoke._Daemon.argv

    def argv_for_plane(self, *extra):
        return argv(self, *extra, *(OFF_FLAGS if plane == "off" else ()))
    chip_smoke._Daemon.argv = argv_for_plane
    try:
        out = chip_smoke.phase_farm(np.random.default_rng([seed, 7]))
    finally:
        chip_smoke._Daemon.argv = argv
    storm = out["phases"]["storm"]
    return {"plane": plane, "storm_s": storm["wall_s"],
            "bulk_jobs_per_s": storm["lanes"][LANE_BULK]["jobs_per_s"],
            "delegated_s": out["phases"]["delegation"]["wall_s"],
            "resumed_s": out["phases"]["resume"]["resumed_s"],
            "launches": out["launches"]}


def run(plane: str, seed: int, device=None) -> dict:
    """One phase 6 with every node's network plane ``on`` or ``off``."""
    make = chip_smoke._NodeKit.make

    def make_for_plane(self, **kw):
        if plane == "off":
            kw.update(OFF)
        return make(self, **kw)
    chip_smoke._NodeKit.make = make_for_plane
    try:
        out = chip_smoke.phase_sockets(np.random.default_rng([seed, 5]),
                                       device=device)
    finally:
        chip_smoke._NodeKit.make = make
    k, line = out["phases"]["k_message"], out["phases"]["l_line"]
    return {"plane": plane,
            "k_message_s": k["wall_s"],
            "k_broadcast_s": out["phases"]["k_broadcast"]["wall_s"],
            "l_b_first_object_s": line["b_first_object_s"],
            "l_b_inbox_s": line["b_inbox_wall_s"],
            "l_acks_at_a_s": line["acks_wall_s"],
            "l_b_ingest_objects_per_s": line["b_ingest_objects_per_s"],
            "l_r_from_a_objects_per_s": line["r_from_a_objects_per_s"],
            "launches": out["launches"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=("sockets", "farm"),
                        default="sockets")
    parser.add_argument("--order", default="on,off,off,on")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("plane_ab: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi("name,power.limit"))
    chip_smoke.phase_environment()
    runs = []
    for plane in args.order.split(","):
        if args.phase == "farm":
            result = run_farm(plane, args.seed)
            runs.append(result)
            print("plane_ab farm %s: storm %.3f s, bulk %.1f jobs/s, E's "
                  "delegated send %.3f s, resumed answer %.3f s"
                  % (plane, result["storm_s"], result["bulk_jobs_per_s"],
                     result["delegated_s"], result["resumed_s"]))
            continue
        result = run(plane, args.seed)
        runs.append(result)
        print("plane_ab %s: (k) msg %.3f s, broadcast %.3f s; (l) B's "
              "first object %.3f s, inbox %.3f s, acks at A %.3f s, B "
              "ingests %.2f obj/s, R takes A's at %.2f obj/s"
              % (plane, result["k_message_s"], result["k_broadcast_s"],
                 result["l_b_first_object_s"], result["l_b_inbox_s"],
                 result["l_acks_at_a_s"],
                 result["l_b_ingest_objects_per_s"],
                 result["l_r_from_a_objects_per_s"]))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(runs, fh, indent=1, default=repr)
    print(json.dumps(runs, default=repr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
