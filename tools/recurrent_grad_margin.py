"""The readings behind RECURRENT_GRAD_RTOL: how far the recurrent archs'
gradient leaves move for sound causes, and how far planted faults move them.

    python3 tools/recurrent_grad_margin.py [--device cuda|cpu] [--seeds N]

Reduced jamba-1.5-large-398b (Mamba, attention, MoE) and xlstm-125m (mLSTM,
sLSTM), f32. Seed s draws the weights (model.init(s)) and the data
(SyntheticTokens seed s), and the two steps of chip_smoke.py's phase 5e(e)
are taken on the host CPU. Every reading is the worst gradient leaf, each
leaf relative to its largest magnitude, as the checks measure it. Per arch
and seed it prints:
  - "1-ulp": the host CPU's gradients against the same with every parameter
    changed by one f32 rounding (relative noise 2^-24), the sensitivity of
    the gradient itself;
  - with --device cuda, "card": the card's gradients against the host
    CPU's, from the same weights at each of the two steps.
Then, for each planted fault (a textual change to a copy of src/repro_torch
in a temporary directory, run in a child process on --device), the faulty
gradients at seed 0, step 0, against the sound host-CPU ones. Exits 1 if a
fault reads at most the largest sound reading. The checkout itself is never
changed.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ("jamba-1.5-large-398b", "xlstm-125m")
# name -> (arch, file under repro_torch/models, text, replacement)
FAULTS = {
    "mamba: the D skip term dropped": (
        "jamba-1.5-large-398b", "mamba.py",
        'y = y + p["d_skip"].float() * xc.float()', "y = y"),
    "mamba: the state not carried from chunk to chunk": (
        "jamba-1.5-large-398b", "mamba.py",
        "h_all = _chunk_states(da, dbx, h)", "h_all = _chunk_states(da, dbx, torch.zeros_like(h))"),
    "mlstm: the input gate dropped from the parallel form": (
        "xlstm-125m", "xlstm.py",
        "ld = cumf_c[:, :, None, :] - cumf[:, None, :, :] + i_pre[:, None, :, :]",
        "ld = cumf_c[:, :, None, :] - cumf[:, None, :, :]"),
    "slstm: the normaliser's clamp at 1 dropped": (
        "xlstm-125m", "xlstm.py",
        "h_new = o * c_new / torch.clamp(n_new, min=1.0)", "h_new = o * c_new / n_new"),
    "slstm: the output gate dropped": (
        "xlstm-125m", "xlstm.py",
        "h_new = o * c_new / torch.clamp(n_new, min=1.0)",
        "h_new = c_new / torch.clamp(n_new, min=1.0)"),
}


def _setup(arch, seed):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import DataConfig, SyntheticTokens

    cfg = reduce_config(get_config(arch))
    return cfg, SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=seed))


def _grads(model, params, batch, device):
    from repro_torch import tree
    from repro_torch.data import to_device
    from repro_torch.launch import steps

    p = tree.tree_map(lambda t: t.to(device), params)
    _, g = steps.loss_and_grads(model, p, to_device(batch, device))
    return tree.tree_map(lambda t: t.detach().cpu(), g)


def _worst(got, want):
    from repro_torch import tree

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    return max((rel(a, b), tree.keystr(p))
               for (p, a), b in zip(tree.leaves_with_path(got), tree.leaves(want)))


def sound(arch, seed, device):
    """[(step, 1-ulp reading, card reading or None)] over the two steps."""
    import torch

    from repro_torch import tree
    from repro_torch.data import to_device
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    cfg, data = _setup(arch, seed)
    step, opt, model = steps.make_train_step(cfg, device="cpu", lr=1e-3, warmup=2,
                                             total_steps=100)
    model_dev = build_model(cfg, device=device) if device != "cpu" else None
    params = model.init(seed)
    state = opt.init(params, device="cpu")
    gen = torch.Generator().manual_seed(1000 + seed)
    out = []
    for s in range(2):
        batch = data.batch(s)
        g = _grads(model, params, batch, "cpu")
        noisy = tree.tree_map(
            lambda t: t * (1 + 2.0**-24 * torch.randn(t.shape, generator=gen)), params)
        ulp = _worst(_grads(model, noisy, batch, "cpu"), g)
        card = _worst(_grads(model_dev, params, batch, device), g) if model_dev else None
        out.append((s, ulp, card))
        params, state, _ = step(params, state, to_device(batch, "cpu"), torch.tensor(s))
    return out


def child(arch, device, out):
    """The faulty package's gradients at seed 0, step 0, saved to `out`."""
    import torch

    from repro_torch.models import build_model

    cfg, data = _setup(arch, 0)
    params = build_model(cfg, device="cpu").init(0)
    torch.save(_grads(build_model(cfg, device=device), params, data.batch(0), device), out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--child", nargs=3, metavar=("ARCH", "DEVICE", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.models import build_model

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("--device cuda needs a CUDA card")
        name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {name.stdout.strip()}", flush=True)
    worst_sound = 0.0
    for arch in ARCHS:
        for seed in range(args.seeds):
            for s, ulp, card in sound(arch, seed, args.device):
                worst_sound = max(worst_sound, ulp[0], card[0] if card else 0.0)
                print(f"{arch} seed {seed} step {s}: 1-ulp {ulp[0]:.3e} ({ulp[1]})"
                      + (f"; card {card[0]:.3e} ({card[1]})" if card else ""), flush=True)
    print(f"largest sound reading: {worst_sound:.3e}", flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (arch, fname, text, repl) in FAULTS.items():
            pkg = pathlib.Path(tmp) / "faulty" / "repro_torch"
            shutil.rmtree(pkg.parent, ignore_errors=True)
            shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                            ignore=shutil.ignore_patterns("__pycache__", "build"))
            path = pkg / "models" / fname
            src = path.read_text()
            assert src.count(text) == 1, (name, src.count(text))
            path.write_text(src.replace(text, repl))
            out = pathlib.Path(tmp) / "grads.pt"
            subprocess.run([sys.executable, __file__, "--child", arch, args.device, str(out)],
                           check=True, env=dict(os.environ, PYTHONPATH=str(pkg.parent)))
            cfg, data = _setup(arch, 0)
            model = build_model(cfg, device="cpu")
            want = _grads(model, model.init(0), data.batch(0), "cpu")
            reading = _worst(torch.load(out), want)
            ok &= not reading[0] <= worst_sound  # a NaN fails the checks too
            print(f"fault '{name}' ({arch}): {reading[0]:.3e} ({reading[1]}); "
                  f"{reading[0] / worst_sound:.1f} x the largest sound reading", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
