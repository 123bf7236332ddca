#!/usr/bin/env python3
"""Where K4's time goes: variants of csrc/flash_fwd_general.cu, each built
for fp32 at DL 2 only, timed at [8,12,1024,64] fp32 causal on one card.

    python3 k4_variants.py

A variant is the source with one or more text substitutions. Some change
the design (key tiles of 32, 8 query rows a thread); others take a piece
out to show what it costs (``no_pv``: S and the softmax without P V;
``no_qk``: P V and the softmax without S; ``no_copy``: only the first K
and V tiles are copied, so every tile reuses them). Those give wrong
results, and the error printed says so. Each variant is built by nvcc
from the checkout's sources, held against the plain attention, and timed
with CUDA events over 50 calls after a second of warm-up, in two rounds.
Prints a line per variant and round, then the card's name and power
limit; writes the lines to chiprun_out/k4_variants.json.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, H, S, D = 8, 12, 1024, 64
TM8 = ("static constexpr int TM = DL == 8 ? 2 : 4;",
       "static constexpr int TM = DL == 8 ? 2 : DL <= 2 ? 8 : 4;")
VARIANTS = {
    "base": [],
    "no_pv": [("#pragma unroll\n    for (int j = 0; j < BN; ++j) {",
               "#pragma unroll\n    for (int j = 0; j < 0; ++j) {")],
    "no_qk": [("for (int d = 0; d < 32 * DL; d += 4) {",
               "for (int d = 0; d < 0; d += 4) {")],
    "no_copy": [("    copy_rows(Vs, ld, v, j0, BN, Sk, D, plan);\n",
                 "    if (t == 0) copy_rows(Vs, ld, v, j0, BN, Sk, D, plan);\n"),
                ("    if (t + 1 < ntiles) copy_rows(Ks, ld, k, j0 + BN, BN, "
                 "Sk, D, plan);", "")],
    "bn32": [("static constexpr int TN = DL >= 4 ? 4 : 8;",
              "static constexpr int TN = 4;")],
    "tm8": [TM8],
    "min_blocks2": [("__launch_bounds__(kThreads)",
                     "__launch_bounds__(kThreads, 2)")],
}


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as smoke
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 2
    src = (_build.CSRC / "flash_fwd_general.cu").read_text()
    dispatch = re.search(r"  RTT_GENERAL_DISPATCH\(dtype, D, run,[^;]*;",
                         src).group(0)
    build = os.path.join(HERE, "ray_tpu_torch", "_build", "k4_variants")
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    shutil.copy(_build.CSRC / "general.cuh", build)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            assert a in text, (name, a)
            text = text.replace(a, b)
        text = text.replace(dispatch, "  return rtt::general::run<float, 2>("
                            "q, k, v, o, lse, B * H, Sq, Sk, D, causal, "
                            "scale, s);")
        path = os.path.join(build, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so",
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    ptxas = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_variants: {name} failed to build\n{log}")
        ptxas[name] = smoke.ptxas_report(log)

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda")
               for _ in range(3))
    sc = D ** -0.5
    ro, _ = A.mha_reference_with_lse(q, k, v, True, sc)
    flops = 4 * D * B * H * smoke.causal_pairs(S, S, True)
    stream = torch.cuda.current_stream().cuda_stream
    warm = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    lines = []
    for rnd in range(2):
        for name in VARIANTS:
            fn = ctypes.CDLL(os.path.join(build, f"{name}.so")) \
                .flash_fwd_general
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            o = torch.empty_like(q)
            lse = torch.empty((B, H, S), device="cuda")

            def call():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), B, H, S, S, D, 1, sc,
                          0, stream)

            if call() != 0:
                raise SystemExit(f"k4_variants: {name} did not launch")
            torch.cuda.synchronize()
            err = ((o - ro).abs().max() / ro.abs().max()).item()
            for _ in range(5):
                call()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(50):
                call()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / 50
            line = dict(round=rnd, variant=name, ms=ms,
                        tflops=flops / ms / 1e9, rel_err=err,
                        ptxas=ptxas[name].get("fp32_dl2"))
            lines.append(line)
            print(f"round {rnd} {name}: {ms:.4f} ms, {line['tflops']:.2f} "
                  f"TFLOP/s, rel err {err:.2e}, ptxas {line['ptxas']}")
    card = smoke.smi_line()
    print(card)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k4_variants.json"),
              "w") as f:
        json.dump(dict(card=card, shape=[B, H, S, D], lines=lines), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
