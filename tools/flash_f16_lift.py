"""Measure what the f16 flash backwards' dS and P lifts buy, on one card,
and what K1c f16's one-term P costs against hi + lo.

    python3 tools/flash_f16_lift.py [--out build/flash_f16_lift.json]

Builds ``paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu`` and
``flash_short.cu`` as they are and with ``-DFLASH_F16_NO_LIFT`` (dS and
P rounded to f16 as they are, the bf16 forms' arithmetic) under the
git-ignored ``build/flash_f16_lift/``, one nvcc each, started together.
Each library is swapped into the wrapper (``_build._LIBS[...]``) and run
over f16:

- K1a + K1b at the NMT's attention shape (``chip_smoke.NMT_ATTENTION``,
  dropout 0.1, causal), q x 1 and q x 8 (a peaked softmax);
- K1c + K1d at BERT phase 2's 32 x 512 x 12 x 64 (dropout 0.1), not
  causal and causal, q x 1 and x 8;
- the external-lse K1b at the SP block 8 x 512 x 12 x 64 with the lse
  and delta of two blocks: a full block, the diagonal, and a block whose
  keys hold little of each row's mass (the other block's keys x 4);

with dO at several multiples of a unit gradient (the gradient of a mean
over the batch's tokens: N(0, 1) / (B L)). For each case and library it
prints the f16 check's tolerance used by each output (``chip_smoke.
flash_2byte_vs_plain``'s rule; <= 1 passes; the check's own failure is
caught and the figure kept) and the count of non-finite values, then
the forward's P V at BERT phase 2's shape with P as one f16 term (K1c
f16) and as hi + lo (K1a f16, the same body): out's tolerance used and
the forward's ms, as one JSON line. Torch only: nothing here imports
JAX.
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
SCALES = (("scale_1", 1.0, 1.0), ("scale_1_peaked", 1.0, 8.0),
          ("scale_2^15", 2.0 ** 15, 1.0),
          ("scale_2^15_peaked", 2.0 ** 15, 8.0),
          ("scale_2^24", 2.0 ** 24, 1.0), ("scale_2^24_peaked", 2.0 ** 24, 8.0))
BERT512 = (32, 512, 12, 64)
SP_BLOCK = (8, 512, 12, 64)

def build(_build, out_dir):
    """{variant: {library: path}}, every library built at once."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for variant, extra in (("lift", []),
                           ("no_lift", ["-DFLASH_F16_NO_LIFT"])):
        for lib in ("flash_attention", "flash_short"):
            path = os.path.join(out_dir, f"{variant}_{lib}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                   str(_build.CSRC), "-o", path,
                   str(_build.CSRC / f"{lib}.cu")]
            jobs[(variant, lib)] = (path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (variant, lib), (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant} {lib}:\n{log}")
        libs.setdefault(variant, {})[lib] = path
    return libs


def held(torch, cs, fn):
    """({output: tolerance used}, {output: non-finite count}) of one
    ``chip_smoke.flash_2byte_vs_plain`` call, kept when it fails."""
    grads = {}
    real = cs.expect
    cs.expect = lambda cond, msg: None      # keep the figures of a failure
    try:
        used, _, got = fn()
    finally:
        cs.expect = real
    names = list(used)
    outs = got if len(got) == len(names) else (got[0],) + tuple(got[2:])
    for name, t in zip(names, outs):
        grads[name] = int((~torch.isfinite(t)).sum())
    return used, grads


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
    f16 = torch.float16
    result = {"card": cs.card_line(), "dropout": 0.1, "saved": {},
              "short": {}, "ext": {}}

    def swap(variant):
        for lib, path in libs[variant].items():
            _build._LIBS[lib] = ctypes.CDLL(path)

    forms = {
        "saved": (cs.NMT_ATTENTION, (("causal", True),), "stream"),
        "short": (BERT512, (("full", False), ("causal", True)), "short")}
    for key, ((B, L, H, D), kinds, form) in forms.items():
        for kind, causal in kinds:
            for case, scale, q_mul in SCALES:
                gen = torch.Generator(device="cuda").manual_seed(7)
                q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D,
                                                  f16, q_mul, scale)
                row = {}
                for variant in ("lift", "no_lift"):
                    swap(variant)
                    used, bad = held(torch, cs, lambda: cs.flash_2byte_vs_plain(
                        torch, fa, q, k, v, do, causal, 0.1, 1234,
                        form=form))
                    row[variant] = {"tolerance_used": used,
                                    "non_finite": bad}
                result[key][f"{kind}_{case}"] = row
                del q, k, v, do
    B, L, H, D = SP_BLOCK
    for kind, causal, k0_mul in (("full", False, 1.0),
                                 ("diagonal", True, 1.0),
                                 ("little_mass", False, 4.0)):
        for case, scale, q_mul in SCALES:
            gen = torch.Generator(device="cuda").manual_seed(7)
            q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D, f16,
                                              q_mul, scale)
            k0, v0 = (torch.randn((B, L, H, D), generator=gen,
                                  device="cuda") * m for m in (k0_mul, 1.0))
            out, lse = fa._plain_fwd(q.float(), torch.cat([k0, k.float()], 1),
                                     torch.cat([v0, v.float()], 1), False,
                                     0.0, 0)
            row = {}
            for variant in ("lift", "no_lift"):
                swap(variant)
                used, bad = held(torch, cs, lambda: cs.flash_2byte_vs_plain(
                    torch, fa, q, k, v, do, causal, 0.0, 0, form="ext",
                    glob=(out.to(f16), lse)))
                row[variant] = {"tolerance_used": used, "non_finite": bad}
            result["ext"][f"{kind}_{case}"] = row
            del q, k, v, do, k0, v0
    # P V with P as one term (K1c f16) and as hi + lo (K1a f16, the same
    # body), at BERT phase 2's shape
    B, L, H, D = BERT512
    swap("lift")
    one = {}
    for case, q_mul in (("q_x1", 1.0), ("q_x8", 8.0)):
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D, f16,
                                          q_mul, 1.0)
        row = {}
        for name, form, fwd in (("one_term", "short", fa._cuda_short_fwd),
                                ("hi_lo", "stream", fa._cuda_fwd)):
            used, _ = held(torch, cs, lambda: cs.flash_2byte_vs_plain(
                torch, fa, q, k, v, do, False, 0.1, 1234, form=form))
            row[name] = {"out_tolerance_used": used["out"],
                         "fwd_ms": cs.time_ms(torch, lambda: fwd(
                             q, k, v, False, 0.1, 1234))}
        one[case] = row
        del q, k, v, do
    result["short_fwd_p_terms"] = one
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
