"""One run of one benchmark cell of the PyTorch/CUDA port on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's configuration on the card from ``--seed`` (truth, data and
starts; no file is read but this folder's and BENCHMARK.json), warms up its
shapes, runs the cell's traffic through the program for ``--seconds`` by the
traffic's driver (``drivers/<name>.py``; multi-start MAP through ``fit_map``),
then checks what the timed path produced against the plain float64
reference on rows drawn from the seed. With
``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
torch.profiler trace of a stretch of the window. The set-up's parts
(imports, the kernel library, the data, the warm-up) are printed beside
``setup_s`` and carried in the result line under ``setup_parts``. The
numbers the check compared, with their limits, end standard error and the
result line.

Exits 3, printing no result, without a CUDA card; exits 4 if the JAX
package, JAX or flax was loaded, or a reference file imports the program.
The kernel library and every cache stay under ``build/`` in the checkout.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / "build" / "bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
# one host thread for PyTorch's CPU work: the run drives the card from one
# process, and idle pool threads only add jitter to its launches
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(CHECKOUT))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    import harness

    cell = harness.load_cell(args.workload)
    need = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(3)
    card = power_limit()
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda"), T_START)
    result["device"]["card"] = card
    bad = harness.banned_modules()
    leaks = harness.reference_imports_program()
    if bad or leaks:
        print(f"loaded in this run: {bad}; reference files importing the program: {leaks}",
              file=sys.stderr)
        sys.exit(4)
    check = result.pop("check")
    result["check"] = check  # last key of the line
    print(f"card: {card}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
