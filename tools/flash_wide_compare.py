"""Time the 2-byte flash kernels at head widths 192 and 256 of this tree
against another tree's (a ``git archive`` of a parent commit) on one card,
in one process, turn about: the other tree, this one, this one, the other.

    git archive <parent> paddle_tpu_torch/ops/cuda/csrc | tar -x -C build/parent
    python3 tools/flash_wide_compare.py --other build/parent --out build/w.json

The other tree's ``flash_attention.cu`` and ``flash_short.cu`` are built
with ``-DFLASH_WIDE`` and this tree's nvcc flags (the same C entry points)
and swapped into this tree's wrapper (``_build._LIBS["flash_attention_wide"]``
and ``["flash_short_wide"]``); each case is timed by CUDA events
(``chip_smoke.time_ms``: L2 flushed, a spin kernel ahead) on the same
inputs. The cases are the main paths' shapes (``gpt_d256``:
8 x 1024 x 3 x 256 causal; ``bert512_d192``: 32 x 512 x 4 x 192 with
dropout 0.1) and the other wide forms those kernels carry (masked, f16,
the D 192 forward with dropout). Prints one JSON line, with the card's
name and power limit. Torch only: nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (form, B, L, H, D, dtype, causal, dropout, pass); "masked" adds
# chip_smoke.masked_lens key lengths
CASES = {
    "K1a_D256_gpt_d256_causal": ("stream", 8, 1024, 3, 256, "bfloat16", True,
                                 0.0, "fwd"),
    "K1c_D192_bert512_d192": ("short", 32, 512, 4, 192, "bfloat16", False,
                              0.1, "fwd"),
    "K1d_D192_bert512_d192": ("short", 32, 512, 4, 192, "bfloat16", False,
                              0.1, "bwd"),
    "K1a_D192_dropout": ("stream", 4, 512, 4, 192, "bfloat16", False, 0.1,
                         "fwd"),
    "K1a_D192_f16": ("stream", 4, 512, 4, 192, "float16", False, 0.1, "fwd"),
    "K1a_D192_masked": ("masked", 8, 512, 4, 192, "bfloat16", False, 0.1,
                        "fwd"),
    "K1c_D192_f16": ("short", 8, 512, 4, 192, "float16", False, 0.1, "fwd"),
    "K1d_D192_f16": ("short", 8, 512, 4, 192, "float16", False, 0.1, "bwd"),
    "K1c_D256_causal": ("short", 4, 512, 3, 256, "bfloat16", True, 0.1,
                        "fwd"),
    "K1d_D256_causal": ("short", 4, 512, 3, 256, "bfloat16", True, 0.1,
                        "bwd"),
}


def build_other(build, other, out_dir):
    """The other tree's wide flash libraries, built at once."""
    src = os.path.join(other, "paddle_tpu_torch", "ops", "cuda", "csrc")
    jobs = {}
    for name in ("flash_attention", "flash_short"):
        out = os.path.join(out_dir, f"other_{name}_wide.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DFLASH_WIDE", "-I", src,
               "-o", out, os.path.join(src, f"{name}.cu")]
        jobs[name + "_wide"] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.abspath(out))
    return libs


def case_fn(torch, cs, fa, gen, spec, seed=5):
    """A closure launching one case's kernel on fixed inputs."""
    form, B, L, H, D, dt, causal, p, part = spec
    q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D,
                                      getattr(torch, dt), 1.0, B * L)
    if form == "short":
        out, lse = fa._cuda_short_fwd(q, k, v, causal, p, seed)
        if part == "fwd":
            return lambda: fa._cuda_short_fwd(q, k, v, causal, p, seed)
        return lambda: fa._cuda_short_bwd(q, k, v, out, lse, do, causal, p,
                                          seed)
    bias = None
    if form == "masked":
        bias = fa.kv_mask_bias(cs.len_mask(torch, cs.masked_lens(B, L, seed=3),
                                           L), B, L)
    out, lse = fa._cuda_fwd(q, k, v, causal, p, seed, bias)
    if part == "fwd":
        return lambda: fa._cuda_fwd(q, k, v, causal, p, seed, bias)
    return lambda: fa._cuda_bwd(q, k, v, out, lse, do, causal, p, seed, bias)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="a tree holding paddle_tpu_torch/ops/cuda/csrc")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_wide_compare: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, _REPO)
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    _build.build_all()
    other = build_other(_build, args.other, str(_build.BUILD_DIR))
    this = {n: _build._LIBS[n] for n in other}
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = {name: case_fn(torch, cs, fa, gen, spec)
           for name, spec in CASES.items()}
    times = {name: {"other": [], "this": []} for name in CASES}
    for which in ("other", "this", "this", "other"):
        _build._LIBS.update(other if which == "other" else this)
        for name, fn in fns.items():
            times[name][which].append(cs.time_ms(torch, fn, iters=10))
    _build._LIBS.update(this)
    row = {"card": cs.card_line(), "other": os.path.abspath(args.other),
           "ms": times}
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
