"""Readings that the limits of `correct` are set from, at a cell's own size:

    python3 portbench/control.py --workload tpch-sf30.q15 --seeds 1,2,3 --queries 3

For each seed it makes the cell's tables, answers the query with the
program (`--queries` answers through the compiled plan, planned once for
all seeds), with the plain reference and with the query's control (the
reference put in the program's place, computed as `queries/<q>.py`'s
`control` says), and prints one JSON line a seed: the numbers of the
program's worst answer and of the control's, against the reference.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, judge, program, spec

    cell = spec.cell(args.workload)
    dev = torch.device(args.device)
    query, rows = cell.query(), cell.rows()
    if dev.type == "cuda":
        program.build_kernels()
    plan = None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        padded, tables = harness.make_tables(query, rows, seed, dev)
        if plan is None:
            plan, order = program.plan(cell.flow().build(rows), dev)
            print(f"plan: {order}", file=sys.stderr)
        masked = program.bind(padded, rows)
        answers = []
        for _ in range(args.queries):
            answers.append(program.answer(plan.run_device(masked)))
        del masked
        want = query.reference(tables)
        got = judge.worst(judge.compare(a, want, query.KEYS)
                          for a in answers)
        del answers
        ctl = judge.compare(query.control(tables), want, query.KEYS)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": got, "control": ctl,
                          "seconds": time.perf_counter() - t}), flush=True)
        del padded, tables, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
