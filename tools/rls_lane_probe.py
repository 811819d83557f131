"""Does an online learner's arithmetic on the card depend on which lane it
occupies? (A fleet migration moves a learner into another lane.)

    python3 tools/rls_lane_probe.py [--src OTHER_CHECKOUT/src] [--e 8] [--s 2501] [--k 8]

Every lane of a width-E batch holds the same numbers (one lane's P, W,
features and targets, copied), so a lane-position-independent computation
gives every lane lane 0's bits. At S = N + 1 = 2501 features (odd), lane e's
rows start e * S floats in, so lanes fall into four 16-byte alignment
classes. The probe prints, for each piece, the lanes whose result is not
bit-equal to lane 0's (with the largest difference relative to lane 0's
largest magnitude):
1. primitives on (E, S) rows: a trailing torch.sum of a product, the same
   sum over rows padded to a multiple of four elements, a bmm dot product;
   and a middle-axis sum over (E, t, S);
2. kernels/rls.py's rls_chunk (K ticks, and K = 1) and lms_chunk, from this
   checkout or, with --src, from another checkout's repro_torch.
Prints one JSON object per line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch


def lanes_off(out: torch.Tensor):
    """{lane: max |lane - lane 0| / max |lane 0|} over lanes not bit-equal to
    lane 0 (axis 0 is the lane)."""
    ref = out[0]
    scale = ref.abs().max().clamp_min(1e-30)
    return {
        e: float(((out[e] - ref).abs().max() / scale).item())
        for e in range(1, out.shape[0])
        if not torch.equal(out[e], ref)
    }


def inputs(e, s, k, dev):
    """Width-e copies of one lane: P = I / 1e-2 plus a small symmetric part,
    W, features and targets from one generator."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((s, s), generator=g, device=dev)
    p = torch.eye(s, device=dev) / 1e-2 + 1e-3 * (a + a.T)
    w = 0.1 * torch.randn((s, 1), generator=g, device=dev)
    x = torch.randn((k, s), generator=g, device=dev)
    x[:, -1] = 1.0  # the bias feature
    y = torch.randn((k, 1), generator=g, device=dev)
    rep = lambda t, axis: t.unsqueeze(axis).expand(*t.shape[:axis], e, *t.shape[axis:]).contiguous()  # noqa: E731
    mask = torch.ones((k, e), dtype=torch.bool, device=dev)
    return rep(p, 0), rep(w, 0), rep(x, 1), rep(y, 1), mask


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None, help="src/ of the checkout whose kernels/rls.py to probe")
    ap.add_argument("--e", type=int, default=8)
    ap.add_argument("--s", type=int, default=2501)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rls_lane_probe.py needs a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.abspath(args.src) if args.src else os.path.join(root, "src"))
    from repro_torch.kernels import rls as krls

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    p, w, xb, y, mask = inputs(args.e, args.s, args.k, dev)
    x, px = xb[0], xb[1]  # (E, S) each, every lane the same row
    pad = -args.s % 4
    rows = {
        "sum(x * px, -1)": torch.sum(x * px, dim=-1),
        "sum(pad(x * px), -1)": torch.sum(torch.nn.functional.pad(x * px, (0, pad)), dim=-1),
        "bmm(x, px)": torch.bmm(x[:, None, :], px[:, :, None])[:, 0, 0],
        "sum(0.5 * g, 1) over (E, t, S)": torch.sum(0.5 * xb[:4].transpose(0, 1).contiguous(), dim=1),
        "sum(w * x, 1)": torch.sum(w * x[:, :, None], dim=1),
    }
    for name, out in rows.items():
        print(json.dumps({"piece": name, "lanes_off": lanes_off(out)}), flush=True)
    for k in (args.k, 1):
        p2, w2, preds = krls.rls_chunk(p, w, xb[:k], y[:k], mask[:k], 1.0)
        print(json.dumps({"piece": f"rls_chunk K={k}", "P": lanes_off(p2), "W": lanes_off(w2),
                          "preds": lanes_off(preds.transpose(0, 1))}), flush=True)
    w3, preds = krls.lms_chunk(w, xb, y, mask, 0.5)
    print(json.dumps({"piece": f"lms_chunk K={args.k}", "W": lanes_off(w3),
                      "preds": lanes_off(preds.transpose(0, 1))}), flush=True)
    print(json.dumps({"src": args.src or "this checkout", "e": args.e, "s": args.s, "k": args.k,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
