"""Run one cell of the benchmark of nfs_tpu_torch once, on this machine's
cards, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout that holds ``BENCHMARK.json``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a traced stretch after the
window. The numbers compared with the plain reference, each beside its
limit, close standard error and the line. Without the cards the cell
asks for, or with JAX or the JAX package loaded in this process, it exits
with a code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    args = harness.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    out = harness.kind_module(cell).run(cell, args, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 3
    line = harness.result(cell, out, bool(args.trace),
                          torch.cuda.get_device_name(0), cell.chips,
                          harness.power_limit())
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
