"""Where the online learners' tail spends its time on the card, and which of
its pieces keep a lane's bits when the batch width changes.

    python3 tools/rls_tail_probe.py [--e 256] [--s 2501] [--k 8]

At the serving shape (E lanes, S = N + 1 features, K ticks a chunk, f32):
1. lane 0 of each piece of kernels/rls.py at width E against the same
   numbers at width 1 — the batched GEMMs (B = P X, the P' update), the
   trailing-axis and middle-axis sums, rls_chunk and lms_chunk — bit-equal
   or the largest difference relative to the largest magnitude;
2. CUDA-event ms of rls_chunk, lms_chunk and the P-sized products alone:
   bmm (P X), baddbmm into a new tensor, baddbmm_ in place, P - bmm, beside
   the bytes bound (each (E, S, S) operand read once, each written once,
   over the card's 3.35 TB/s), and a torch.profiler table of one rls_chunk.
Prints one JSON object per line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.kernels import rls as krls  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[reps // 2]


def lane0(a, b):
    """'equal' or the max |a - b| over max |a| (lane 0 of both)."""
    if torch.equal(a, b):
        return "equal"
    return ((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()


def inputs(e, s, k, dev):
    """Width-e copies of one lane's numbers: P = I / 1e-2 plus a small
    symmetric part, W, features and targets from one generator."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((1, s, s), generator=g, device=dev)
    p = torch.eye(s, device=dev)[None] * 100.0 + 1e-3 * (a + a.transpose(1, 2))
    w = 0.1 * torch.randn((1, s, 1), generator=g, device=dev)
    x = 0.3 * torch.randn((k, 1, s), generator=g, device=dev)
    y = torch.randn((k, 1, 1), generator=g, device=dev)
    mask = torch.ones((k, 1), dtype=torch.bool, device=dev)
    widen = lambda t, d: t.expand(*[e if i == d else -1 for i in range(t.ndim)]).contiguous()  # noqa: E731
    return widen(p, 0), widen(w, 0), widen(x, 1), widen(y, 1), widen(mask, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--e", type=int, default=256)
    ap.add_argument("--s", type=int, default=2501)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rls_tail_probe.py needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    e, s, k = args.e, args.s, args.k

    one, wide = inputs(1, s, k, dev), inputs(e, s, k, dev)
    parts = {}
    for kk in sorted({1, k}):
        o = [one[0], one[1], one[2][:kk], one[3][:kk], one[4][:kk]]
        wd = [wide[0], wide[1], wide[2][:kk], wide[3][:kk], wide[4][:kk]]
        a, b = krls.rls_chunk(*o, 1.0), krls.rls_chunk(*wd, 1.0)
        parts[f"rls_chunk K={kk} P"] = lane0(a[0][0], b[0][0])
        parts[f"rls_chunk K={kk} W"] = lane0(a[1][0], b[1][0])
        a, b = krls.lms_chunk(*o[1:], 0.5), krls.lms_chunk(*wd[1:], 0.5)
        parts[f"lms_chunk K={kk} W"] = lane0(a[0][0], b[0][0])
    xb1, xbe = one[2].permute(1, 2, 0), wide[2].permute(1, 2, 0)
    parts["bmm P X"] = lane0(torch.bmm(one[0], xb1)[0], torch.bmm(wide[0], xbe)[0])
    g1, ge = one[2].transpose(0, 1), wide[2].transpose(0, 1)  # (E, K, S) stand-ins
    parts["baddbmm P - G^T X"] = lane0(
        torch.baddbmm(one[0], g1.transpose(1, 2), g1, alpha=-1)[0],
        torch.baddbmm(wide[0], ge.transpose(1, 2), ge, alpha=-1)[0],
    )
    parts["sum over the last axis (E, S)"] = lane0(
        (one[2][0] * one[2][1]).sum(-1)[0], (wide[2][0] * wide[2][1]).sum(-1)[0]
    )
    parts["sum over axis 1 (E, S, 1)"] = lane0(
        (one[1] * one[2][0][:, :, None]).sum(1)[0], (wide[1] * wide[2][0][:, :, None]).sum(1)[0]
    )
    print(json.dumps({"lane0_width_e_vs_1": parts, "e": e, "s": s, "k": k, "card": card}), flush=True)
    del one

    p, w, x, y, mask = wide
    pbytes = p.numel() * p.element_size()
    gst = 1e-3 * x.transpose(0, 1)  # (E, K, S)
    times = {
        "rls_chunk": time_ms(lambda: krls.rls_chunk(p, w, x, y, mask, 1.0)),
        "lms_chunk": time_ms(lambda: krls.lms_chunk(w, x, y, mask, 0.5)),
        "bmm P X (B)": time_ms(lambda: torch.bmm(p, x.permute(1, 2, 0))),
        "baddbmm into a new P'": time_ms(lambda: torch.baddbmm(p, gst.transpose(1, 2), gst, alpha=-1)),
        "baddbmm_ in place": time_ms(lambda: p.baddbmm_(gst.transpose(1, 2), gst, alpha=-1)),
        "P - bmm": time_ms(lambda: p - torch.bmm(gst.transpose(1, 2), gst)),
    }
    bounds = {
        "rls_chunk": 2 * pbytes / HBM_BYTES_PER_S * 1e3,
        "bmm P X (B)": pbytes / HBM_BYTES_PER_S * 1e3,
        "baddbmm into a new P'": 2 * pbytes / HBM_BYTES_PER_S * 1e3,
        "baddbmm_ in place": 2 * pbytes / HBM_BYTES_PER_S * 1e3,
        "P - bmm": 2 * pbytes / HBM_BYTES_PER_S * 1e3,
    }
    print(json.dumps({"ms": times, "bytes_bound_ms": bounds, "p_bytes": pbytes, "card": card}), flush=True)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        krls.rls_chunk(p, w, x, y, mask, 1.0)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
