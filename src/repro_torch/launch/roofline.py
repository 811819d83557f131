"""Roofline per (arch x shape) cell, from a dry-run record
(launch/dryrun.py) and the card's rates (launch/mesh.HW).

    PYTHONPATH=src python -m repro_torch.launch.roofline --arch h2o-danube-1.8b \\
        --shape train_4k --mesh mesh4x1
    PYTHONPATH=src python -m repro_torch.launch.roofline --all --mesh pod32x8

Terms per rank:
    compute    = bf16 FLOPs / peak_flops_bf16 + other FLOPs / peak_flops_f32
    memory     = bytes / hbm_bw
    collective = bytes on "model" groups / nvlink_bw
                 + bytes on the other groups / net_bw

The dry run executes the step eagerly, every period and microbatch of it,
so its counts are the whole step's as it runs. The reference lowers one
scan period's body on its own (`lower_period_body`) and scales it by the
trip count, because XLA's cost analysis visits a while-loop body once; that
has no counterpart here, and a record has no "body".

MODEL_FLOPS are the reference's formulas: counting.train_step_flops (6 x
N_active x tokens), the prefill's 2 x N_active x B x S plus its attention
term, counting.decode_step_flops. useful_ratio = MODEL_FLOPS / counted
FLOPs exposes remat and redundancy; roofline_fraction = (MODEL_FLOPS /
peak_flops_bf16) / the largest term.
"""

from __future__ import annotations

import argparse
import json
import traceback

from repro_torch.configs import SHAPES, cells_for, get_config, list_configs
from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.launch.mesh import HW
from repro_torch.models import counting

ROOF_DIR = OUT_DIR.parent / "roofline_torch"


def model_flops(cfg, cell) -> float:
    """The step's MODEL_FLOPS over the whole global batch."""
    if cell.kind == "train":
        return counting.train_step_flops(cfg, cell.global_batch, cell.seq_len)
    if cell.kind == "prefill":
        flops = 2.0 * cfg.active_param_count() * cell.global_batch * cell.seq_len
        attn_layers = sum(1 for s in cfg.layer_kinds() if s.mixer in ("attn", "swa", "mla"))
        win = cfg.sliding_window or 0
        s_eff = min(cell.seq_len, win) if win else cell.seq_len
        return flops + (2.0 * attn_layers * cell.global_batch * cell.seq_len * s_eff
                        * cfg.num_heads * cfg.head_dim)
    return counting.decode_step_flops(cfg, cell.global_batch, cell.seq_len)


def terms(rec: dict, hw: dict = HW) -> dict:
    """{"compute", "memory", "collective"}: seconds of one rank's counts (a
    dry-run record, launch/costs.measure's keys) on the rates `hw`."""
    return {
        "compute": (rec["flops"]["bf16"] / hw["peak_flops_bf16"]
                    + rec["flops"]["f32"] / hw["peak_flops_f32"]),
        "memory": rec["hlo_bytes"] / hw["hbm_bw"],
        "collective": sum(b / (hw["nvlink_bw"] if dim == "model" else hw["net_bw"])
                          for dim, b in rec["collective_bytes_by_dim"].items()),
    }


def roofline(rec: dict, cfg, cell, hw: dict = HW) -> dict:
    """The roofline of a dry-run record (one rank's counts on a mesh of
    rec["devices"] ranks) on the rates `hw`."""
    chips = rec["devices"]
    t = terms(rec, hw)
    t_compute, t_memory, t_coll = t["compute"], t["memory"], t["collective"]
    by_dim = rec["collective_bytes_by_dim"]
    model_flops_dev = model_flops(cfg, cell) / chips
    bound = max(t.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "chips": chips,
        "n_micro": rec.get("n_micro", 1),
        "flops_dev": rec["hlo_flops"],
        "bytes_dev": rec["hlo_bytes"],
        "coll_bytes_dev": sum(by_dim.values()),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": max(t, key=t.get),
        "model_flops_dev": model_flops_dev,
        "useful_ratio": model_flops_dev / rec["hlo_flops"] if rec["hlo_flops"] else 0.0,
        "roofline_fraction": (model_flops_dev / hw["peak_flops_bf16"]) / bound if bound else 0.0,
        "fits_hbm": rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"] <= hw["hbm_bytes"],
    }


def analyze_cell(arch: str, shape: str, mesh_tag: str = "pod32x8") -> dict:
    """The roofline of a cell from its dry-run record
    (experiments/dryrun_torch/<arch>_<shape>_<mesh_tag>.json) on HW."""
    path = OUT_DIR / f"{arch}_{shape}_{mesh_tag}.json"
    if not path.exists():
        raise FileNotFoundError(f"no dry-run record {path}: run launch.dryrun for the cell first")
    return roofline(json.loads(path.read_text()), get_config(arch), SHAPES[shape])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="pod32x8")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    ROOF_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        jobs = [(a, s) for a in list_configs() for s, ok in cells_for(get_config(a)).items() if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in jobs:
        out = ROOF_DIR / f"{arch}_{shape}_{args.mesh}.json"
        if out.exists() and not args.force:
            print(f"skip cached {out.name}")
            continue
        try:
            rec = analyze_cell(arch, shape, args.mesh)
        except Exception as e:  # noqa: BLE001 (a failing cell is reported, the sweep goes on)
            failures += 1
            print(f"FAIL {arch} {shape}: {e}")
            traceback.print_exc(limit=4)
            continue
        out.write_text(json.dumps(rec, indent=1))
        print(
            f"{arch:26s} {shape:12s} compute={rec['t_compute_s']:.3e}s "
            f"memory={rec['t_memory_s']:.3e}s coll={rec['t_collective_s']:.3e}s "
            f"dominant={rec['dominant']:10s} useful={rec['useful_ratio']:.2f} "
            f"roofline={rec['roofline_fraction']:.2%}"
        )
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
