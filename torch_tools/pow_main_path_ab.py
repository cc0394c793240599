#!/usr/bin/env python3
"""Drive the send path of two checkouts in turns on one card.

    python3 torch_tools/pow_main_path_ab.py --parent DIR [--seed N]
                                            [--rounds N] [--report PATH]

Runs ``chip_smoke.phase_main_path`` (shapes (a)-(d) through
``PowService(PowDispatcher())``, every nonce re-checked) of an earlier
checkout of the repo (``--parent``) and of this one, each in a process
of its own started in that checkout (so each builds and runs its own
kernels, before the timed path), ``--rounds`` times in the order
parent, this, this, parent.  Every run gets the same inputs (a
generator seeded with ``--seed``).  Prints the card's name and power
limit first, then each shape's wall time for each run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

RUN = """
import json, sys
import numpy as np
sys.path.insert(0, ".")
import chip_smoke
from pybitmessage_tpu_torch.ops import _build
_build.load()
out = chip_smoke.phase_main_path(np.random.default_rng(%d))
walls = {k: v["wall_s"] for k, v in out["phases"].items()}
print("WALLS " + json.dumps(walls))
"""


def run(tree: Path, seed: int) -> dict:
    """One process driving the send path from ``tree``: its walls."""
    proc = subprocess.run([sys.executable, "-c", RUN % seed], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    chip_smoke.require(proc.returncode == 0, "main path in %s failed:\n%s"
                       % (tree, proc.stdout[-4000:] + proc.stderr[-4000:]))
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("WALLS ")]
    return json.loads(line[-1][len("WALLS "):])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--report", default=None)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("pow_main_path_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi)
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    walls: dict = {name: [] for name in trees}
    for name in ("parent", "this", "this", "parent") * args.rounds:
        walls[name].append(run(trees[name], args.seed))
        print("%s: %s" % (name, json.dumps(walls[name][-1])))
    for shape in walls["this"][0]:
        print("%s: parent %s s; this %s s" % (
            shape, " / ".join(repr(w[shape]) for w in walls["parent"]),
            " / ".join(repr(w[shape]) for w in walls["this"])))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump({"smi": smi, "seed": args.seed, "walls": walls}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
