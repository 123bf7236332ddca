#!/usr/bin/env python3
"""Where the general kernels' time goes: variants of K4
(csrc/flash_fwd_general.cu), K6 (flash_bwd_dq_general.cu) and K5
(flash_bwd_dkdv_general.cu), each built for fp32 at DL 2 only and timed at
[8,12,1024,64] fp32 causal on one card.

    python3 general_variants.py [k4] [k5] [k6]     (default: all three)

A variant is the kernel's source, or the shared header general.cuh, with
one or more text substitutions. Some change the design (key tiles of 32,
8 query rows a thread); others take a piece out to show what it costs
(``no_pv``: K4 without P V; ``no_qk``: without S; ``no_dp``, ``no_dsk``,
``no_dk``, ``no_dv``: the backward kernels without that product;
``no_copy``: only the first streamed tiles are copied, so every tile
reuses them). Those give wrong results, and the error printed says so.
Each variant is built by nvcc from the checkout's sources, held against
the plain version, and timed with CUDA events over 50 calls after a
second of warm-up, in two rounds. Prints a line per variant and round,
then the card's name and power limit; writes the lines to
chiprun_out/general_variants.json.
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
HDR = "general.cuh"
# A substitution: (file, old text, new text); file is the kernel's source
# (None) or the shared header.
K4_BN32 = (HDR, "using FwdTile = Tile<DL == 8 ? 2 : 4, DL >= 4 ? 4 : 8>;",
           "using FwdTile = Tile<DL == 8 ? 2 : 4, 4>;")
K4_TM8 = (HDR, "using FwdTile = Tile<DL == 8 ? 2 : 4, DL >= 4 ? 4 : 8>;",
          "using FwdTile = Tile<DL == 8 ? 2 : DL <= 2 ? 8 : 4, "
          "DL >= 4 ? 4 : 8>;")
K5_TILE = "using DkdvTile = Tile<DL <= 2 ? 4 : DL == 4 ? 2 : 1, 4>;"
MIN_BLOCKS2 = (None, "__launch_bounds__(kThreads)",
               "__launch_bounds__(kThreads, 2)")
KERNELS = {
    "k4": dict(name="flash_fwd_general", variants={
        "base": [],
        "no_pv": [(None, "acc_products<BN, DL>(acc,",
                   "acc_products<0, DL>(acc,")],
        "no_qk": [(None, "row_products<DL>(s, Qs + row0 * ld, Ks + cg * ld, "
                   "ld, D4);", "row_products<DL>(s, Qs + row0 * ld, Ks + cg "
                   "* ld, ld, 0);")],
        "no_copy": [
            (None, "    copy_rows(Vs, ld, v, j0, BN, Sk, D, plan);\n",
             "    if (t == 0) copy_rows(Vs, ld, v, j0, BN, Sk, D, plan);\n"),
            (None, "    if (t + 1 < ntiles) copy_rows(Ks, ld, k, j0 + BN, "
             "BN, Sk, D, plan);", "")],
        "bn32": [K4_BN32],
        "tm8": [K4_TM8],
        "min_blocks2": [MIN_BLOCKS2],
    }),
    "k6": dict(name="flash_bwd_dq_general", variants={
        "base": [],
        "no_dp": [(None, "row_products<DL>(dp, dOs + row0 * ld, Vs + cg * "
                   "ld, ld, D4);", "row_products<DL>(dp, dOs + row0 * ld, "
                   "Vs + cg * ld, ld, 0);")],
        "no_s": [(None, "row_products<DL>(s, Qs + row0 * ld, Ks + cg * ld, "
                  "ld, D4);", "row_products<DL>(s, Qs + row0 * ld, Ks + cg "
                  "* ld, ld, 0);")],
        "no_dsk": [(None, "acc_products<BN, DL>(acc,",
                    "acc_products<0, DL>(acc,")],
        "no_copy": [
            (None, "    copy_rows(Ks, ld, k, j0, BN, Sk, D, plan);\n",
             "    if (t == 0) copy_rows(Ks, ld, k, j0, BN, Sk, D, plan);\n"),
            (None, "    if (t + 1 < ntiles) copy_rows(Vs, ld, v, j0 + BN, "
             "BN, Sk, D, plan);\n", "")],
        "bn64": [(None, "using DqTile = Tile<FwdTile<DL>::TM, 4>;",
                  "using DqTile = Tile<FwdTile<DL>::TM, DL >= 4 ? 4 : 8>;")],
        "tm2": [(None, "using DqTile = Tile<FwdTile<DL>::TM, 4>;",
                 "using DqTile = Tile<2, 4>;")],
        "tm2_bn64": [(None, "using DqTile = Tile<FwdTile<DL>::TM, 4>;",
                      "using DqTile = Tile<2, 8>;")],
    }),
    "k5": dict(name="flash_bwd_dkdv_general", variants={
        "base": [],
        "no_s": [(None, "row_products<DL>(s, Ks + row0 * ld, Qs + cg * ld, "
                  "ld, D4);", "row_products<DL>(s, Ks + row0 * ld, Qs + cg "
                  "* ld, ld, 0);")],
        "no_dp": [(None, "row_products<DL>(dp, Vs + row0 * ld, dOs + cg * "
                   "ld, ld, D4);", "row_products<DL>(dp, Vs + row0 * ld, "
                   "dOs + cg * ld, ld, 0);")],
        "no_dk": [(None, "acc_products<BN, DL>(dka,",
                   "acc_products<0, DL>(dka,")],
        "no_dv": [(None, "acc_products<BN, DL>(dva,",
                   "acc_products<0, DL>(dva,")],
        "no_copy": [
            (None, "    copy_rows(dOs, ld, dout, i0, BN, Sq, D, plan);\n",
             "    if (t == 0) copy_rows(dOs, ld, dout, i0, BN, Sq, D, "
             "plan);\n"),
            (None, "    if (t + 1 < ntiles) copy_rows(Qs, ld, q, i0 + BN, "
             "BN, Sq, D, plan);\n", "")],
        "bn64": [(None, K5_TILE, "using DkdvTile = Tile<DL <= 2 ? 4 : DL "
                  "== 4 ? 2 : 1, DL >= 4 ? 4 : 8>;")],
        "tm2": [(None, K5_TILE, "using DkdvTile = Tile<2, 4>;")],
        "tm2_bn64": [(None, K5_TILE, "using DkdvTile = Tile<2, 8>;")],
    }),
}
# Each entry point's ctypes argument types.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {"k4": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
            "k5": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
            "k6": [_P] * 7 + [_I] * 6 + [_F, _I, _P]}


def build_variants(nvcc, flags, csrc, build, key, spec):
    """Writes and builds every variant of one kernel, all nvcc processes
    at once; returns each variant's library path and nvcc log."""
    src = open(os.path.join(csrc, spec["name"] + ".cu")).read()
    hdr = open(os.path.join(csrc, HDR)).read()
    dispatch = re.search(r"  RTT_GENERAL_DISPATCH\(dtype, D, run,([^;]*);",
                         src)
    args = dispatch.group(1).strip().rstrip(")")
    procs = {}
    for name, subs in spec["variants"].items():
        text, head = src, hdr
        for where, a, b in subs:
            if where == HDR:
                assert a in head, (key, name, a)
                head = head.replace(a, b)
            else:
                assert a in text, (key, name, a)
                text = text.replace(a, b)
        stem = os.path.join(build, f"{key}_{name}")
        text = text.replace(dispatch.group(0), "  return rtt::general::run"
                            f"<float, 2>({args});")
        text = text.replace(f'#include "{HDR}"',
                            f'#include "{key}_{name}.cuh"')
        with open(stem + ".cu", "w") as f:
            f.write(text)
        with open(stem + ".cuh", "w") as f:
            f.write(head)
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            stem + ".so")
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"general_variants: {key} {name} failed to "
                             f"build\n{log}")
        out[name] = (lib, log)
    return out


def main(argv):
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as smoke
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("general_variants: no CUDA device", file=sys.stderr)
        return 2
    keys = argv or list(KERNELS)
    build = os.path.join(HERE, "ray_tpu_torch", "_build", "general_variants")
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    built = {key: build_variants(_build.nvcc(), _build.NVCC_FLAGS,
                                 str(_build.CSRC), build, key, KERNELS[key])
             for key in keys}

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   for _ in range(4))
    sc = D ** -0.5
    ro, lse = A.mha_reference_with_lse(q, k, v, True, sc)
    delta = (do * ro).sum(-1)
    refs = {"k4": [ro],
            "k5": list(A.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                  True, sc)),
            "k6": [A.flash_bwd_dq_reference(q, k, v, do, lse, delta, True,
                                            sc)]}
    pairs = B * H * smoke.causal_pairs(S, S, True)
    flops = {"k4": 4 * D * pairs, "k5": 8 * D * pairs, "k6": 6 * D * pairs}
    stream = torch.cuda.current_stream().cuda_stream
    warm = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    lines = []
    for rnd in range(2):
        for key in keys:
            spec = KERNELS[key]
            outs = [torch.empty_like(r) for r in refs[key]]
            if key == "k4":
                outs.append(torch.empty((B, H, S), device="cuda"))
                ptrs = [q, k, v] + outs
            else:
                ptrs = [q, k, v, do, lse, delta] + outs
            args = ([t.data_ptr() for t in ptrs]
                    + [B, H, S, S, D, 1, sc, 0, stream])
            for name, (lib, log) in built[key].items():
                fn = getattr(ctypes.CDLL(lib), spec["name"])
                fn.argtypes = ARGTYPES[key]
                if fn(*args) != 0:
                    raise SystemExit(f"general_variants: {key} {name} did "
                                     "not launch")
                torch.cuda.synchronize()
                err = max(((o - r).abs().max() / r.abs().max()).item()
                          for o, r in zip(outs, refs[key]))
                for _ in range(5):
                    fn(*args)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(50):
                    fn(*args)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / 50
                line = dict(round=rnd, kernel=key, variant=name, ms=ms,
                            tflops=flops[key] / ms / 1e9, rel_err=err,
                            ptxas=smoke.ptxas_report(log).get("fp32_dl2"))
                lines.append(line)
                print(f"round {rnd} {key} {name}: {ms:.4f} ms, "
                      f"{line['tflops']:.2f} TFLOP/s, rel err {err:.2e}, "
                      f"ptxas {line['ptxas']}")
    card = smoke.smi_line()
    print(card)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "general_variants.json"),
              "w") as f:
        json.dump(dict(card=card, shape=[B, H, S, D], lines=lines), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
