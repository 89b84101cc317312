"""Measure what K1b's f16 dS lift buys, on one card.

    python3 tools/flash_f16_lift.py [--out build/flash_f16_lift.json]

Builds ``paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu`` twice under
the git-ignored ``build/flash_f16_lift/``, as it is and with
``-DFLASH_F16_NO_LIFT`` (dS rounded to f16 as it is, the bf16 forms'
arithmetic), one nvcc each, started together. Each library is swapped
into the wrapper (``_build._LIBS["flash_attention"]``) and K1a + K1b
run over f16 at the NMT's attention shape (``chip_smoke.NMT_ATTENTION``,
dropout 0.1, causal) with dO at several multiples of a unit gradient
(the gradient of a mean over the batch's tokens: N(0, 1) / (B L)), with
q x 1 and q x 8 (a peaked softmax). For each case and library it prints
the f16 check's tolerance used by dq, dk and dv (``chip_smoke.
flash_2byte_vs_plain``'s rule; <= 1 passes) and the count of non-finite
values, as one JSON line. Torch only: nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, dO's multiple of a unit gradient, q's multiplier)
CASES = (("scale_1", 1.0, 1.0), ("scale_1_peaked", 1.0, 8.0),
         ("scale_2^15", 2.0 ** 15, 1.0), ("scale_2^15_peaked", 2.0 ** 15, 8.0),
         ("scale_2^24", 2.0 ** 24, 1.0), ("scale_2^24_peaked", 2.0 ** 24, 8.0))


def build(_build, out_dir):
    """{variant: path of its library}, both built at once."""
    os.makedirs(out_dir, exist_ok=True)
    src = str(_build.CSRC / "flash_attention.cu")
    jobs = {}
    for name, extra in (("lift", []), ("no_lift", ["-DFLASH_F16_NO_LIFT"])):
        path = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
               str(_build.CSRC), "-o", path, src]
        jobs[name] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: path for name, (path, _) in jobs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_f16_lift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, _REPO)
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    libs = build(_build, os.path.join(_REPO, "build", "flash_f16_lift"))
    B, L, H, D = cs.NMT_ATTENTION
    result = {"shape": [B, L, H, D], "dropout": 0.1, "causal": True,
              "card": cs.card_line(), "cases": {}}
    for case, scale, q_mul in CASES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D,
                                          torch.float16, q_mul, scale)
        row = {}
        for name, path in libs.items():
            _build._LIBS["flash_attention"] = ctypes.CDLL(path)
            out, lse = fa._cuda_fwd(q, k, v, True, 0.1, 1234)
            grads = fa._cuda_bwd(q, k, v, out, lse, do, True, 0.1, 1234)
            f = [x.float() for x in (q, k, v, out, do)]
            want = fa._plain_bwd(f[0], f[1], f[2], f[3], lse, f[4], True,
                                 0.1, 1234)
            norms, sums = fa._term_norms(q, k, v, out, lse, do, True, 0.1,
                                         1234)
            floor = tuple(cs.FLASH_F32_SUMS * D * x for x in sums) + (0.0,)
            u = cs.FLASH_UNIT_ROUNDOFF["float16"]
            row[name] = {
                g: {"tolerance_used": cs.tolerance_ratio(
                        torch, got, ref, cs.FLASH_TERMS_K * u * n + fl
                        + 1e-6 * float(ref.abs().max())),
                    "non_finite": int((~torch.isfinite(got)).sum()),
                    "ref_max_abs": float(ref.abs().max())}
                for g, got, ref, n, fl in zip(("dq", "dk", "dv"), grads,
                                              want, norms[1:], floor)}
        result["cases"][case] = row
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
