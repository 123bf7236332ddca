#!/usr/bin/env python3
"""Times the attention kernels of one or more checkouts of the port on one
NVIDIA card, each checkout in a process of its own, in the order given.

    python3 kernel_ab.py ROOT [ROOT ...]

For A/B runs, give the roots alternately (parent, change, change, parent).
Each ROOT is a directory holding a ``ray_tpu_torch`` package; its kernels
are built from its own sources. Each process measures, for K1
``flash_fwd``, K2 ``flash_bwd_dkdv``, K3 ``flash_bwd_dq`` and
F.scaled_dot_product_attention's forward and backward at the GPT-2 124M
shape ([8,12,1024,64] bf16 causal), the LayerNorm kernels
(``layer_norm_fwd``, ``layer_norm_bwd``) at gpt2-1.5b's rows and width
([16384, 1600] bf16) and the scan's forward (``ssd_forward``: its three
launches and the C B^T product) at Granite's mixer widths (h 128, p 64,
n 128, chunk 256) over 1024 positions:

  - ``ms``: device time per call, torch.profiler (``chip_smoke.time_ms``,
    the same yardstick for every root);
  - ``host_ms``: host wall time per call of the Python entry point, with
    the kernel built and loaded: the median over 15 windows of the clock
    around 40 calls, read before the synchronize that ends the window.

Prints one JSON line per process, a table, the card's name and power
limit, and writes every line to chiprun_out/kernel_ab.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, H, S, D = 8, 12, 1024, 64
LN_ROWS, LN_D = 16384, 1600
SSD_S, SSD_H, SSD_P, SSD_N, SSD_CHUNK = 1024, 128, 64, 128, 256
WINDOWS, CALLS = 15, 40


def host_ms(torch, fn, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / CALLS * 1e3)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def one(root):
    """Times ``root``'s kernels in this process; returns a dict."""
    sys.path.insert(0, HERE)
    import chip_smoke as smoke  # this checkout's timing, for every root
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import norm, ssd

    smoke.require(torch.cuda.is_available(), "no CUDA device")
    smoke.require(os.path.dirname(A.__file__).startswith(
        os.path.abspath(root)), f"imported {A.__file__}, not {root}'s")
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    o, lse = A.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, is_causal=True)
    x_ln = torch.randn((LN_ROWS, LN_D), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    w_ln = torch.ones(LN_D, device=dev, dtype=torch.bfloat16)
    b_ln = torch.zeros(LN_D, device=dev, dtype=torch.bfloat16)
    _, mean, rstd = norm.layer_norm_fwd(x_ln, w_ln, b_ln)
    hp = SSD_H * SSD_P
    xbc = torch.randn((1, SSD_S, hp + 2 * SSD_N), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    x_ssd = xbc[..., :hp].unflatten(-1, (SSD_H, SSD_P))
    b_ssd, c_ssd = xbc[..., hp:hp + SSD_N], xbc[..., hp + SSD_N:]
    dt = F.softplus(torch.randn((1, SSD_S, SSD_H), generator=gen,
                                device=dev) - 1.0)
    a_ssd = -torch.exp(torch.randn(SSD_H, generator=gen, device=dev))
    calls = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, True, scale),
        "flash_bwd_dkdv": lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta,
                                                   True, scale),
        "flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                               scale),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
        "sdpa_bwd": lambda: torch.autograd.grad(out, xs, do,
                                                retain_graph=True),
        "layer_norm_fwd": lambda: norm.layer_norm_fwd(x_ln, w_ln, b_ln),
        "layer_norm_bwd": lambda: norm.layer_norm_bwd(x_ln, x_ln, w_ln,
                                                      mean, rstd),
        "ssd_forward": lambda: ssd.ssd_kernel_forward(
            x_ssd, dt, a_ssd, b_ssd, c_ssd, SSD_CHUNK),
    }
    warm = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t_warm = time.perf_counter() + 1.0
    while time.perf_counter() < t_warm:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    res = {"root": root}
    for name, fn in calls.items():
        res[name] = dict(ms=smoke.time_ms(torch, fn), host_ms=host_ms(torch, fn))
    return res


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    card = smoke.smi_line()
    rows = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"kernel_ab: {root} failed ({proc.returncode})")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    names = [n for n in rows[0] if n != "root"]
    print(f"{'root':<28}" + "".join(f"{n + ' ms/host':>26}" for n in names))
    for r in rows:
        print(f"{r['root']:<28}" + "".join(
            f"{r[n]['ms']:>14.4f}/{r[n]['host_ms']:<11.4f}" for n in names))
    print(f"card: {card}")
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "kernel_ab.json"), "w") as f:
        json.dump({"card": card, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
