"""Training launcher (the reference's launch/train.py, its flags plus --device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --reduced --steps 100 --batch 8 --seq 128 --device cpu

Without --reduced the model trains at its full published width (on the
card: --device cuda, the default). Resume is automatic: rerunning the same
command continues from the latest checkpoint in --ckpt-dir, so the command
runs under the watchdog as it is (python -m repro_torch.train.watchdog
--heartbeat CKPT_DIR/heartbeat.json -- python -m repro_torch.launch.train
...).

`--mesh DxM` trains data-parallel on a ("data", "model") mesh (`PxDxM`:
("pod", "data", "model")), one process a rank under torchrun, which sets
RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous address:

    torchrun --standalone --nproc-per-node=4 -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b --mesh 4x1 --batch 16 --seq 512

Each rank takes the card of its LOCAL_RANK and NCCL (gloo with --device
cpu). A model axis wider than 1 is refused (ROADMAP queue 1 item 13b,
tensor-parallel training). The reference's --virtual-devices (an XLA flag
that splits the host into virtual devices) has no torch counterpart and is
refused.
"""

import argparse
import math
import os
import tempfile


def _mesh_axes(dims):
    return ("data", "model")[: len(dims)] if len(dims) <= 2 else ("pod", "data", "model")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="e.g. 4x1 => (data=4, model=1), under torchrun")
    ap.add_argument("--virtual-devices", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # failure injection for watchdog/restart testing
    ap.add_argument("--fail-at-step", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.virtual_devices:
        ap.error("--virtual-devices is an XLA flag (virtual host devices) with no torch "
                 "counterpart: run one process a rank under torchrun with --mesh")
    dims = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
        if missing:
            ap.error(f"--mesh needs torchrun's environment ({', '.join(missing)} unset): "
                     f"torchrun --nproc-per-node={math.prod(dims)} -m repro_torch.launch.train ...")
        if dict(zip(_mesh_axes(dims), dims)).get("model", 1) > 1:
            from repro_torch.distributed.sharding import TP_TODO

            ap.error(f"--mesh {args.mesh}: {TP_TODO}")

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import LoopConfig, train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)

    device = torch.device(args.device)
    mesh = None
    if dims is not None:
        world = int(os.environ["WORLD_SIZE"])
        if math.prod(dims) != world:
            ap.error(f"--mesh {args.mesh} needs {math.prod(dims)} ranks; WORLD_SIZE is {world}")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]), world_size=world)
        axes = _mesh_axes(dims)
        mesh = make_mesh(dims, axes, device.type)
        print(f"mesh: {dict(zip(axes, dims))} over {world} ranks", flush=True)

    loop = LoopConfig(
        total_steps=args.steps,
        seq_len=args.seq,
        global_batch=args.batch,
        microbatch=args.microbatch,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        optimizer=args.optimizer,
        grad_compression=args.grad_compression,
        lr=args.lr,
        fail_at_step=args.fail_at_step,
    )
    try:
        hist = train(cfg, loop, mesh=mesh, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if hist:
        print(f"done: final loss {hist[-1]['loss']:.4f} at step {hist[-1]['step']}")
    else:
        print(f"done: nothing to run, the checkpoint in {args.ckpt_dir} is at the last step")


if __name__ == "__main__":
    main()
