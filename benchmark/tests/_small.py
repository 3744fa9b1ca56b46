"""Small sizes of the cells for CPU tests: the same configurations and
traffic at a few pixels, rows and steps; and the entries of the cells whose
files the benchmark keeps but whose entries ``BENCHMARK.json`` does not hold
yet."""
import torch

import harness

SMALL = {
    "epl80_lstsq.map": {"cfg": {"num_pix": 12},
                        "traffic": {"starts": 8, "steps": 10, "check_rows": 6}},
    "inversion64.map": {"cfg": {"num_pix": 12, "source_grid": {"n_side": 6, "extent": 0.4}},
                        "traffic": {"starts": 6, "steps": 10, "check_rows": 6}},
}
KEPT = {
    "inversion64.map": {"name": "inversion64.map", "config": "inversion64",
                        "traffic": "map_pixelated", "chips": 1,
                        "why": "the demo's stage-2 joint pixelated MAP, 32 starts x 200 steps"},
}
CPU = torch.device("cpu")


def load(workload):
    return harness.load_cell(workload, KEPT.get(workload))


def small_ctx(workload, seed):
    return harness.prepare(load(workload), seed, CPU, SMALL[workload])
