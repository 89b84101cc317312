"""Time text-edited variants of K2's CUDA source (the fused linear +
vocabulary cross-entropy, ``paddle_tpu_torch/ops/cuda/csrc/fused_xent.cu``)
at BERT's MLM head on one card, to see where a kernel's time goes.

    python3 tools/xent_variants.py --edits ws --library --out build/v.json
    python3 tools/xent_variants.py --tree build/parent --edits none

Each variant is the source of ``--tree`` (default: this repository) with
some lines replaced (``EDITS``: a variant drops a piece of the kernels'
work, so its outputs are wrong and only its time counts). All variants
build at once, one nvcc each, with the tree's own flags; each library is
swapped into the tree's wrapper (``_build._LIBS["fused_xent"]``), and the
2-byte forward and backward are timed by CUDA events (``chip_smoke.
time_ms``: L2 flushed, a spin kernel ahead), in the order given and then
the first variant once more. ``--library`` adds the PyTorch call that
computes the same function (``matmul`` + ``F.cross_entropy``, and its
autograd backward). The tree's package and ``chip_smoke.py`` are imported
from ``--tree``, so two trees compare in two processes of one call.
Torch only: nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the backward's exchange stores and waits and its products (the "ws"
# design), dropped by the variants below
_NO_PARTIAL_SENDS = (
    "      st_async4(cluster_map(at, o), v, cluster_map(c.pbar, o));",
    "      (void)v;")
_NO_P_SENDS = [
    ("            st_async4u(cluster_map(at, k), v, cluster_map(c.qbar, "
     "k));", "            (void)k;"),
    ("            st_async2(cluster_map(at, k), w[q][0], w[q][1],\n"
     "                      cluster_map(c.qbar, k));", "            (void)k;"),
]
_NO_PARTIAL_WAIT = ("  if (C > 1) {\n    if (lane == 0) mbar_expect(c.pbar",
                    "  if (false) {\n    if (lane == 0) mbar_expect(c.pbar")
_NO_P_WAIT = ("  if (C > 1) {\n    if (lane == 0) mbar_expect(c.qbar",
              "  if (false) {\n    if (lane == 0) mbar_expect(c.qbar")
_NO_S = ("    bwd_s<T>(d, Rg, c.Xs + sn * kBwdX);", "    (void)sn;")
_NO_PX = ("    wg_rs256t<T>(acc, A[j], wg_desc(X + j * 2048, 8192, 1024));",
          "    (void)A[j];")

# variant -> [(old text, new text)], each old text present in the source.
# "cluster": the earlier design (one 64-row tile a CTA, the partial S
# exchanged through distributed shared memory behind cluster barriers),
# for ``--tree`` a ``git archive`` of the last commit that has it: the
# measurement that chose the present design. "ws": the present one (two
# warpgroups, the exchange by st.async into mbarrier-guarded slots).
EDITS = {
    "none": {"as_is": []},
    "cluster": {
        "a_as_is": [],
        # no remote loads and no cluster barriers: each CTA uses its own
        # partial S
        "b_no_exchange": [
            ("    if (t > 0) cluster_wait();      // B of t - 1\n", ""),
            ("    cluster_arrive_shared_release();  // A of t\n", ""),
            ("    cluster_wait();\n    if (tid == 0 && t + 1 < nsteps)",
             "    if (tid == 0 && t + 1 < nsteps)"),
            ("    cluster_arrive_relaxed();\n", ""),
            ("  cluster_wait();          // B of the last step: exit is "
             "safe\n", ""),
            ("        if (c < C && c != rank) {", "        if (false) {"),
            ("const float v = c == rank ? s[i][e] : ps[c][i][e];",
             "const float v = c == rank ? s[i][e] : 0.0f;"),
        ],
        # no exponentials: the forward sums x - m, the backward stores S
        # as P' (its masks, lift and onehot gone too)
        "c_no_p": [
            ("sum += exp2_ftz((x[j] - mn) * kLog2e);", "sum += x[j] - mn;"),
            ("l[h] = l[h] * exp2_ftz((m[h] - mn) * kLog2e) + sum;",
             "l[h] = l[h] + sum;"),
            ("        for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
             "          for (int e = 0; e < 4; ++e) {\n"
             "            const int h = e >> 1, cl",
             "        for (int i = 0; i < 4 && t < 0; ++i)\n#pragma unroll\n"
             "          for (int e = 0; e < 4; ++e) {\n"
             "            const int h = e >> 1, cl"),
        ],
        # no P'X product (the backward)
        "d_no_px": [
            ("      if (128 * wc < ks) product<T, SPLIT>(acc, Ps, Xh, wc, "
             "unscale);", "      (void)unscale;"),
        ],
    },
    "ws": {
        "a_as_is": [],
        # no exchange: no st.async to a peer and no wait on the
        # exchange's mbarriers (each CTA reads its slots as they are)
        "b_no_exchange": [_NO_PARTIAL_SENDS, *_NO_P_SENDS, _NO_PARTIAL_WAIT,
                          _NO_P_WAIT],
        # no exponentials in the backward's P' (the rest of P' stays)
        "c_no_exp": [
            ("pe = exp2_ftz((sv[e] + elem_f32(cbias[cl]) - r.v[h]) * kLog2e);",
             "pe = sv[e] + elem_f32(cbias[cl]) - r.v[h];"),
            ("pe = exp2_ftz((sv[e] + r.v[h] - clse[cl]) * kLog2e);",
             "pe = sv[e] + r.v[h] - clse[cl];"),
        ],
        # no P'X product
        "d_no_px": [_NO_PX],
        # no S products after the first (S(t + 1) left as S(0))
        "e_no_s": [_NO_S],
        # neither S after the first nor P'X: the exchange, P' and the
        # pipeline alone
        "f_no_s_no_px": [_NO_S, _NO_PX],
        # no X tile loads after the first two (the products read stale
        # tiles; the column values still arrive)
        "g_no_x_loads": [
            ("  mbar_expect(bar, kBwdX + (c.dwp ? 3 * 256 : 128));\n"
             "  for (int b = 0; b < 4; ++b)",
             "  mbar_expect(bar, x < 2 ? kBwdX + (c.dwp ? 3 * 256 : 128)\n"
             "                         : (c.dwp ? 3 * 256 : 128));\n"
             "  for (int b = 0; b < 4 && x < 2; ++b)"),
        ],
        # no partial exchange (the P' exchange stays)
        "i_no_partial_exchange": [_NO_PARTIAL_SENDS, _NO_PARTIAL_WAIT],
        # the forward without its epilogues but the last
        "k_fwd_no_epilogue": [
            ("    fwd_epilogue<T>(a, acc, j * kFwdCols,",
             "    if (j + 1 == nvt)\n    fwd_epilogue<T>(a, acc, j * kFwdCols,"),
        ],
        # the forward without loads past the ring's first fill (the
        # products read stale chunks)
        "l_fwd_no_loads": [
            ("  mbar_expect(bar, kFwdStage + (k == 0 ? 512 : 0));",
             "  if (q >= kFwdStages) {\n    mbar_expect(bar, 0);\n    "
             "return;\n  }\n  mbar_expect(bar, kFwdStage + (k == 0 ? 512 "
             ": 0));"),
        ],
        # neither products nor the exchange: P', the loads, the pipeline
        "h_skeleton": [_NO_S, _NO_PX, _NO_PARTIAL_SENDS, *_NO_P_SENDS,
                       _NO_PARTIAL_WAIT, _NO_P_WAIT],
    },
}


def _variant_sources(tree, edits, root):
    """{variant: its source directory under ``root``}, the edits made."""
    csrc = os.path.join(tree, "paddle_tpu_torch", "ops", "cuda", "csrc")
    with open(os.path.join(csrc, "fused_xent.cu")) as f:
        src = f.read()
    out = {}
    for name, subs in edits.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: text not found: {old!r}")
            text = text.replace(old, new)
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        with open(os.path.join(d, "fused_xent.cu"), "w") as f:
            f.write(text)
        out[name] = d
    return out


def _build_all(build, dirs):
    """One nvcc a variant, all started together; {variant: CDLL}."""
    procs = {}
    for name, d in dirs.items():
        lib = os.path.join(d, "fused_xent.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", d, "-o", lib,
               os.path.join(d, "fused_xent.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_REPO)
    ap.add_argument("--edits", default="none", choices=sorted(EDITS))
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import fused_xent as fx

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    tag = f"{os.path.basename(tree.rstrip('/'))}-{args.edits}-{os.getpid()}"
    root = os.path.join(tree, "build", "xent_variants", tag)
    t0 = time.time()
    libs = _build_all(_build, _variant_sources(tree, EDITS[args.edits],
                                                root))
    rows = [{"tree": tree, "edits": args.edits, "build_s": time.time() - t0,
             "card": cs.card_line()}]
    N, H, V = 16384, 768, 30592
    order = list(libs) + [next(iter(libs))]
    for dname in args.dtypes.split(","):
        dt = getattr(torch, dname)
        gen = torch.Generator(device="cuda").manual_seed(11)
        h = torch.randn((N, H), generator=gen, device="cuda").to(dt)
        w = (torch.randn((V, H), generator=gen, device="cuda") * 0.02).to(dt)
        b = (torch.randn((V,), generator=gen, device="cuda") * 0.02).to(dt)
        lab = torch.randint(0, V, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ignored = torch.rand((N,), generator=gen, device="cuda") < 0.15
        lab = torch.where(ignored, torch.full_like(lab, -1), lab)
        valid = lab >= 0
        g = valid.float() / valid.sum().float() * cs.XENT_LOSS_SCALE[dname]
        lse = fx._plain_fwd(h, w, b, lab)[0]
        for name in order:
            _build._LIBS["fused_xent"] = libs[name]
            row = {"dtype": dname, "variant": name,
                   "fwd_ms": cs.time_ms(torch, lambda: fx._cuda_fwd(
                       h, w, b, lab), iters=args.iters, warmup=1),
                   "bwd_ms": cs.time_ms(torch, lambda: fx._cuda_bwd(
                       h, w, b, lab, lse, g), iters=args.iters, warmup=1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        if args.library:
            F = torch.nn.functional
            lab64 = lab.long()
            hg, wg, bg = (x.clone().requires_grad_() for x in (h, w, b))
            loss = F.cross_entropy((torch.matmul(hg, wg.t()) + bg).float(),
                                   lab64, ignore_index=-1)
            row = {"dtype": dname, "variant": "library",
                   "fwd_ms": cs.time_ms(torch, lambda: F.cross_entropy(
                       (torch.matmul(h, w.t()) + b).float(), lab64,
                       ignore_index=-1), iters=args.iters, warmup=1),
                   "bwd_ms": cs.time_ms(torch, lambda: torch.autograd.grad(
                       loss, (hg, wg, bg), retain_graph=True),
                       iters=args.iters, warmup=1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del loss
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
