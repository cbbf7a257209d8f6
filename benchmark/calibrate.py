"""Readings that the output check's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...
        --control-seeds 7,8,9 [--seconds 3] [--keep-one-in 6]

For each of ``--seeds``: a short window of the served pump at the cell's
own load, keeping about as many blocks for the check as a run of the
benchmark keeps, and the numbers ``check.numbers`` compares (the lower
readings). For each of ``--control-seeds``: the same numbers for the
control, the reference computed in bfloat16 put in the program's place
(the upper readings). One JSON line per seed on standard output, then a
summary line: per number, the largest program reading and the smallest
control reading. Needs the GPU, as a run of the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import check, run, traffic  # noqa: E402


def as_program_output(tr, out: dict) -> dict:
    """Reference outputs in the shape the harness keeps the program's:
    USB audio is the in-phase output only."""
    usb = {r.name for r in tr.radios if r.demod == "USB"}
    return {k: {"bb": v["bb"], "line": v["line"],
                "audio": {n: (a[0] if n in usb else a)
                          for n, a in v["audio"].items()}}
            for k, v in out.items()}


def control_numbers(tr, config, block: int, keys) -> dict:
    kept = dict.fromkeys(keys)
    ref = check.reference_outputs(tr, config, block, kept)
    ctl = check.reference_outputs(tr, config, block, kept, control=True)
    return check.numbers(tr, config, as_program_output(tr, ctl), ref, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--keep-one-in", type=int, default=6)
    args = ap.parse_args(argv)
    cell, config, spec = traffic.load_cell(args.workload)
    jax, devs, compiles = run.init_jax(int(cell["chips"]), False)
    low, high, keys, block = {}, {}, None, None
    for seed in [int(s) for s in args.seeds.split(",")]:
        tr = traffic.build(config, spec, seed)
        ctx, kept, missing, _, _ = run.serve(
            jax, devs, compiles, config, tr, seed, args.seconds,
            keep_one_in=args.keep_one_in)
        block = ctx["block_len"]
        keys = keys or sorted(kept)
        ref = check.reference_outputs(tr, config, block, kept)
        values = check.numbers(tr, config, kept, ref, missing)
        print(json.dumps({"seed": seed, "side": "program",
                          "blocks_kept": len(kept), **values}), flush=True)
        for k, v in values.items():
            low[k] = max(low.get(k, v), v)
    for seed in [int(s) for s in args.control_seeds.split(",")]:
        tr = traffic.build(config, spec, seed)
        values = control_numbers(tr, config, block, keys)
        print(json.dumps({"seed": seed, "side": "control",
                          "blocks_kept": len(keys), **values}), flush=True)
        for k, v in values.items():
            high[k] = min(high.get(k, v), v)
    print(json.dumps({"summary": args.workload,
                      "program_max": low, "control_min": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
