#!/usr/bin/env python3
"""Sample sharding over several cards: N nccl ranks, one a card, against one process.

    python3 scripts/torch_mesh_parity.py [--ranks 2,4] [--chains 12] [--timeout 600]

Runs ``chip_smoke.py``'s mesh phase body (``mesh_run``: the bench scene at
full width through ``ModellingSequence(mesh=...)``: MAP 500 x 50, SVI 1000
x 20, HMC (20 + 20) ChEES, SMC 1000 particles x 3 stages) in this
process on cuda:0, then in N spawned ``nccl`` ranks on cuda:0..N-1 for
each N of ``--ranks``, and checks each N by ``chip_smoke.mesh_report``
(HMC from the in-process run's surrogate, ``--chains`` chains a rank, 12
by default: N x 12 in all, and the in-process run at the same count):
results equal to the one-process run at tests/test_sharding.py's
tolerances, every rank's results bitwise equal to rank 0's, every rank's
launch counters as the pipeline's phases require. Prints the cards' names
and power limits, each configuration's walls and busy shares, and one
JSON line. Needs as many CUDA devices as the largest N; builds the
kernels first, so the ranks only load them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="2,4", help="comma-separated rank counts")
    ap.add_argument("--chains", type=int, default=12, help="HMC chains a rank")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for each configuration's ranks")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from gigalens_tpu_torch.ops.cuda import _build
    from gigalens_tpu_torch.parallel import spawn_ranks

    counts = [int(n) for n in args.ranks.split(",")]
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(counts):
        print(f"torch_mesh_parity: needs {max(counts)} CUDA devices", file=sys.stderr)
        return 1
    cards = chip_smoke.card_line()
    print(f"cards: {cards} (x{torch.cuda.device_count()})", flush=True)
    _build.build()
    obs = chip_smoke.mesh_observation()
    summary, refs = {}, {}
    for n in counts:
        # each chain count has its in-process reference
        chains = n * args.chains
        if chains not in refs:
            label = f"in-process, {chains} chains"
            t0 = time.time()
            refs[chains] = chip_smoke.mesh_run(None, obs, chains)
            summary[label] = chip_smoke.mesh_report(label, [refs[chains]],
                                                    refs[chains]["out"], t0, cards)
        label = f"{n} nccl ranks"
        t0 = time.time()
        ranks = spawn_ranks(chip_smoke.mesh_run, n, "nccl", [f"cuda:{r}" for r in range(n)],
                            args=(obs, chains, (refs[chains]["out"]["mean"],
                                                refs[chains]["out"]["scale_tril"])),
                            timeout=args.timeout)
        summary[label] = chip_smoke.mesh_report(label, ranks, refs[chains]["out"], t0, cards)
    print(json.dumps(dict(summary, cards=cards, torch=torch.__version__)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
