"""A markdown table of dry-run records (launch/dryrun.py's JSON under
experiments/dryrun_torch/): per rank, argument and temp bytes against one
card's 80 GB, and the collectives on each mesh dim.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k --mesh single --device cpu
    python tools/dryrun_table.py --mesh pod32x8 gemma-7b h2o-danube-1.8b

Rows follow the archs given, then SHAPES' order; a cell without a record
reads "no record".
"""

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CARD_BYTES = 80e9  # launch/mesh.HW["hbm_bytes"]


def _size(n) -> str:
    return f"{n / 2**30:.2f} GiB" if n >= 2**30 else f"{n / 2**20:.2f} MiB"


def row(rec) -> str:
    args, temp = rec["argument_size_in_bytes"], rec["temp_size_in_bytes"]
    counts = rec.get("collective_counts_by_dim", {})
    by_dim = rec["collective_bytes_by_dim"]
    coll = ", ".join(f"{d} {counts.get(d, '?')} ({_size(by_dim[d])})"
                     for d in sorted(by_dim)) or "none"
    return (f"| {rec['arch']} | {rec['shape']} | {args / 2**30:.2f} | {temp / 2**30:.2f} | "
            f"{(args + temp) / 2**30:.2f} | {'yes' if args + temp <= CARD_BYTES else 'no'} | "
            f"{coll} | {rec['run_s']} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="+")
    ap.add_argument("--mesh", default="pod32x8")
    ap.add_argument("--dir", default=str(ROOT / "experiments" / "dryrun_torch"))
    args = ap.parse_args(argv)
    print("| arch | cell | arguments GiB | temp GiB | sum GiB | fits 80 GB | collectives a step "
          "(by mesh dim) | dry run s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for arch in args.archs:
        for shape in SHAPES:
            path = Path(args.dir) / f"{arch}_{shape}_{args.mesh}.json"
            if path.exists():
                print(row(json.loads(path.read_text())))
            elif shape != "long_500k":
                print(f"| {arch} | {shape} | no record | | | | | |")


if __name__ == "__main__":
    main()
