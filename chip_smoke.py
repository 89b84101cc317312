"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and hold
every kernel on it against its plain PyTorch version.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

0. build    every CUDA kernel from ``paddle_tpu_torch/ops/cuda/csrc``,
            one nvcc per source, all started together (ptxas report
            included);
1. kernels  each kernel against its plain version on the card at the
            full-width shapes (ragged lengths, -1 table tails, one small
            odd shape): paged attention within atol/rtol 1e-4 (sum
            order), sampling bit for bit; kernel, plain and library
            times and the least time the card could take (bound);
2. int8     the decode engine at the full width of its README
            configuration (vocab 32000, 24 layers, 16 x 128 heads, ffn
            8192, page 128, 16 pages a sequence, batch 8, 512 pages,
            int8 pool), greedy, 16 concurrent requests of 16-1500
            prompt tokens; every request finishes, the int8 attention
            kernel launches n_layers times per decode tick;
3. f32      the same model over an f32 pool, greedy, 4 requests; tokens
            equal the dense oracle (``reference_generate`` on the card)
            except where the oracle's top-2 logit gap is < 1e-3 (a tie,
            printed as such); the f32 attention kernel launched;
4. sample   int8 pool, temperature 0.8, top_k 8, sample_seed 7, run
            twice: identical tokens, the sampling kernel launched;
5. the ``kernels`` line (launches counted over phases 2-4), then the
   card's name and power limit, then the result line.

Weights are random, made on the card from a seed. Depth is the
configuration's own (24 layers).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
ATOL = RTOL = 1e-4            # paged attention: the sum order differs

FULL = dict(vocab_size=32000, n_layers=24, n_heads=16, head_dim=128,
            ffn_dim=8192, max_context=2048)
ENGINE = dict(max_batch=8, page_size=128, max_pages_per_seq=16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, L2 flushed before each (the
    decode step reads each layer's pages cold)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_case(torch, rng, B, H, D, S, T, P, lens, quant):
    """Inputs at one shape: distinct live pages per row, -1 past the
    live pages, and one -1 inside the live length of the longest row
    (which reads page 0, as the JAX paths do)."""
    dev = "cuda"
    q = torch.tensor(rng.randn(B, H, D).astype(np.float32), device=dev)
    perm = rng.permutation(np.arange(1, P))
    table = np.full((B, T), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        live = -(-n // S)
        table[b, :live] = perm[used:used + live]
        used += live
    longest = int(np.argmax(lens))
    if -(-lens[longest] // S) > 2:
        table[longest, 1] = -1
    if quant:
        kp = torch.randint(-127, 128, (P, S, H, D), dtype=torch.int8,
                           device=dev)
        vp = torch.randint(-127, 128, (P, S, H, D), dtype=torch.int8,
                           device=dev)
        ks = torch.rand((P, S), device=dev) * 0.02
        vs = torch.rand((P, S), device=dev) * 0.02
    else:
        kp = torch.randn((P, S, H, D), device=dev)
        vp = torch.randn((P, S, H, D), device=dev)
        ks = vs = None
    return (q, kp, vp, ks, vs, torch.tensor(table, device=dev),
            torch.tensor(np.asarray(lens, np.int32), device=dev))


def check_attention(torch, pa, rng, quant, timing):
    B, H, D, S, T, P = 8, 16, 128, 128, 16, 512
    lens = [1, 127, 128, 129, 700, 2047, 1500, 300]
    q, kp, vp, ks, vs, table, lens_t = attention_case(
        torch, rng, B, H, D, S, T, P, lens, quant)

    if quant:
        def kern():
            return pa._cuda_paged_attention_quant(q, kp, vp, ks, vs, table,
                                                  lens_t)

        def plain():
            return pa._plain_paged_attention_quant(q, kp, vp, ks, vs, table,
                                                   lens_t)
    else:
        def kern():
            return pa._cuda_paged_attention(q, kp, vp, table, lens_t)

        def plain():
            return pa._plain_paged_attention(q, kp, vp, table, lens_t)

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    expect(bool(torch.isfinite(out).all()), "non-finite attention output")
    expect(torch.allclose(out, ref, atol=ATOL, rtol=RTOL),
           f"paged attention (quant={quant}) disagrees: max abs err {err}")

    # small odd shape: page 16, head_dim 64
    small = attention_case(torch, rng, 3, 4, 64, 16, 5, 24, [1, 17, 80],
                           quant)
    sq, skp, svp, sks, svs, stab, slen = small
    if quant:
        so = pa._cuda_paged_attention_quant(sq, skp, svp, sks, svs, stab,
                                            slen)
        sr = pa._plain_paged_attention_quant(sq, skp, svp, sks, svs, stab,
                                             slen)
    else:
        so = pa._cuda_paged_attention(sq, skp, svp, stab, slen)
        sr = pa._plain_paged_attention(sq, skp, svp, stab, slen)
    small_err = float((so - sr).abs().max())
    expect(torch.allclose(so, sr, atol=ATOL, rtol=RTOL),
           f"paged attention (quant={quant}) at S=16 D=64 disagrees: "
           f"max abs err {small_err}")

    row = {"max_abs_err": err, "max_abs_err_small": small_err}
    if timing:
        n_tok = int(sum(lens))
        elem = 1 if quant else 4
        kv_bytes = 2 * n_tok * H * D * elem + (2 * n_tok * 4 if quant
                                               else 0)
        io_bytes = 2 * B * H * D * 4 + B * T * 4 + B * 4
        flops = 4 * n_tok * H * D
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        # library yardstick: one SDPA call over pre-gathered, contiguous
        # (dequantised) K/V with the ragged mask
        safe = table.long().clamp(min=0)
        kg = kp[safe].reshape(B, T * S, H, D).float()
        vg = vp[safe].reshape(B, T * S, H, D).float()
        if quant:
            kg = kg * ks[safe].reshape(B, T * S)[..., None, None]
            vg = vg * vs[safe].reshape(B, T * S)[..., None, None]
        kg = kg.permute(0, 2, 1, 3).contiguous()
        vg = vg.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(T * S, device="cuda")[None, :]
                < lens_t[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        F = torch.nn.functional

        def lib():
            return F.scaled_dot_product_attention(q4, kg, vg,
                                                  attn_mask=mask)

        lib_out = lib()[:, :, 0]
        expect(torch.allclose(lib_out, ref, atol=1e-3, rtol=1e-3),
               "SDPA yardstick disagrees with the plain version")
        row.update({
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lib),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_tokens": n_tok})
    return row


def check_sampling(torch, samp, rng, timing):
    B, V = 8, 32000
    logits = torch.tensor((rng.randn(B, V) * 3).astype(np.float32),
                          device="cuda")
    noise = torch.tensor(rng.gumbel(size=(B, V)).astype(np.float32),
                         device="cuda")
    mismatches = 0
    for top_k in (0, 1, 4, 8):
        for temp in (0.7, 1.0):
            out = samp._cuda_sample(logits, noise, temp, top_k)
            ref = samp._plain_sample(logits, noise, temp, top_k, 1.0)
            if not torch.equal(out, ref):
                mismatches += 1
    expect(mismatches == 0,
           f"sampling kernel disagrees bitwise in {mismatches} of 8 cases")
    row = {"max_abs_err": 0.0, "bitwise_cases": 8}
    if timing:
        top_k, temp = 8, 0.8
        io = 2 * B * V * 4 + B * 4
        ops = B * V * (top_k + 3)   # k threshold rounds + scale, add, max
        t_bytes = io / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS_PER_S * 1e3
        row.update({
            "ms": time_ms(torch, lambda: samp._cuda_sample(
                logits, noise, temp, top_k)),
            "plain_ms": time_ms(torch, lambda: samp._plain_sample(
                logits, noise, temp, top_k, 1.0)),
            "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return row


# ---------------------------------------------------------------------------
# phases 2-4: the decode engine
# ---------------------------------------------------------------------------
def run_engine(eng, prompts, max_new):
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs, errors = [], []
    for h in handles:
        try:
            outs.append(h.result(timeout=600))
        except Exception as e:   # typed failure: the phase fails below
            errors.append(f"{type(e).__name__}: {e}")
            outs.append(None)
    wall = time.perf_counter() - t0
    return outs, errors, wall


def prompts_for(rng, lengths, vocab):
    return [rng.randint(1, vocab, size=n).tolist() for n in lengths]


def timed(fn, sink):
    """Wrap an engine method to record its wall time (ms) in ``sink``;
    the decode step ends in a device-to-host fetch, so its wall time
    covers the device work."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def device_breakdown(torch, eng, prompts):
    """Device time by kernel family over a window of decode ticks only
    (profiling starts once every prompt is prefilled), under
    torch.profiler, and the device's busy share of that window."""
    from torch.profiler import ProfilerActivity, profile

    base = eng.counters.get("decode_prefills", 0)
    handles = [eng.submit(p, max_new_tokens=128) for p in prompts]
    deadline = time.perf_counter() + 600
    while eng.counters.get("decode_prefills", 0) < base + len(prompts):
        expect(time.perf_counter() < deadline
               and not any(h.error() for h in handles),
               "the profiled window's prefills did not complete")
        time.sleep(0.001)
    errors = []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ticks0 = eng.counters["decode_steps"]
            for h in handles:
                try:
                    h.result(timeout=600)
                except Exception as e:   # typed failure: fails below
                    errors.append(f"{type(e).__name__}: {e}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ticks = eng.counters["decode_steps"] - ticks0
    except RuntimeError as e:   # the profiler itself: not measured
        return {"device_ms": "not measured", "error": str(e)}
    expect(not errors, f"profiled window failed: {errors[:3]}")
    fams = {"paged_attention": 0.0, "fused_sample": 0.0, "gemm": 0.0,
            "other": 0.0}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        name = e.name.lower()
        if "paged_attn_kernel" in name:
            fam = "paged_attention"
        elif "sample_kernel" in name:
            fam = "fused_sample"
        elif "gemm" in name or "gemv" in name or "cutlass" in name \
                or "sm90_xmma" in name:
            fam = "gemm"
        else:
            fam = "other"
        fams[fam] += us / 1e3
    busy = sum(fams.values())
    if busy <= 0:
        return {"device_ms": "not measured"}
    return {"window_ms": wall * 1e3, "ticks": ticks, "device_ms": fams,
            "device_busy_share": busy / (wall * 1e3)}


def phase_int8(torch, dec, counters, params, cfg, rng):
    eng = dec.DecodeEngine(cfg, params=params, n_pages=512,
                           kv_codec="int8", **ENGINE)
    eng.warm()
    tick_ms, prefill_ms = [], []
    eng._step = timed(eng._step, tick_ms)
    eng._prefill_dispatch = timed(eng._prefill_dispatch, prefill_ms)
    eng.start()
    try:
        lengths = np.linspace(16, 1500, 16).astype(int).tolist()
        prompts = prompts_for(rng, lengths, cfg.vocab_size)
        counters.reset()
        outs, errors, wall = run_engine(eng, prompts, 32)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        c = eng.counters
        expect(not errors, f"int8 engine requests failed: {errors[:3]}")
        expect(c.get("decode_failed", 0) == 0, "decode_failed > 0")
        expect(all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
                   for o in outs), "int8 engine emitted malformed tokens")
        ticks = c["decode_steps"]
        k4b = launches.get("paged_attention_quant", 0)
        expect(k4b == cfg.n_layers * ticks,
               f"int8 attention launched {k4b} times, want n_layers x ticks = "
               f"{cfg.n_layers} x {ticks}")
        n_tok = sum(len(o) for o in outs)
        p_hi = max(50.0, 100.0 * (1 - 10 / len(tick_ms)))
        row = {"phase": "int8_engine", "requests": len(prompts),
               "prompt_tokens": int(sum(lengths)), "generated_tokens": n_tok,
               "wall_s": wall, "tokens_per_s": n_tok / wall,
               "decode_ticks": ticks, "prefills": c["decode_prefills"],
               "step_samples": len(tick_ms),
               "step_p50_ms": float(np.percentile(tick_ms, 50)),
               "step_p99_ms": float(np.percentile(tick_ms, 99)),
               # the highest percentile with ten samples beyond it
               "step_p_hi": p_hi,
               "step_p_hi_ms": float(np.percentile(tick_ms, p_hi)),
               "prefill_p50_ms": float(np.percentile(prefill_ms, 50)),
               "prefill_max_ms": float(np.max(prefill_ms)),
               "launches": launches,
               "breakdown": device_breakdown(torch, eng, prompts[::2])}
    finally:
        eng.stop()
    return row, launches


def top2_gap(torch, dec, cfg, params, tokens):
    logits = dec.model.dense_forward(
        cfg, params, torch.tensor([tokens], device="cuda"))[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def phase_f32(torch, dec, counters, params, cfg, rng):
    eng = dec.DecodeEngine(cfg, params=params, n_pages=160, **ENGINE)
    eng.warm()
    eng.start()
    lengths = [16, 300, 700, 1100]
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    max_new = 16
    counters.reset()
    outs, errors, wall = run_engine(eng, prompts, max_new)
    torch.cuda.synchronize()
    launches = counters.snapshot()
    c = eng.counters
    eng.stop()
    expect(not errors, f"f32 engine requests failed: {errors[:3]}")
    expect(c.get("decode_failed", 0) == 0, "decode_failed > 0")
    expect(launches.get("paged_attention", 0) > 0,
           "the f32 attention kernel was not launched")
    del eng
    torch.cuda.empty_cache()
    ties, matched = [], 0
    for p, out in zip(prompts, outs):
        ref = dec.reference_generate(cfg, params, p, max_new)
        diverge = next((i for i, (a, b) in enumerate(zip(out, ref))
                        if a != b), None)
        if diverge is None:
            matched += 1
            continue
        gap = top2_gap(torch, dec, cfg, params, p + ref[:diverge])
        expect(gap < 1e-3,
               f"f32 engine diverged from the dense oracle at token "
               f"{diverge} with a top-2 gap of {gap}")
        ties.append({"prompt_len": len(p), "token": diverge, "gap": gap})
    return {"phase": "f32_engine", "requests": len(prompts),
            "matched_oracle": matched, "ties": ties, "wall_s": wall,
            "decode_ticks": c["decode_steps"],
            "launches": launches}, launches


def phase_sample(torch, dec, counters, params, cfg, rng):
    lengths = [20, 150, 400, 900]
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    runs, total = [], {}
    for _ in range(2):
        eng = dec.DecodeEngine(cfg, params=params, n_pages=512,
                               kv_codec="int8", temperature=0.8, top_k=8,
                               sample_seed=7, **ENGINE)
        eng.warm()
        eng.start()
        counters.reset()
        outs, errors, wall = run_engine(eng, prompts, 24)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        c = eng.counters
        eng.stop()
        del eng
        torch.cuda.empty_cache()
        expect(not errors, f"sampling engine requests failed: {errors[:3]}")
        expect(c.get("decode_failed", 0) == 0, "decode_failed > 0")
        expect(launches.get("fused_sample", 0) > 0,
               "the sampling kernel was not launched")
        runs.append(outs)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    expect(runs[0] == runs[1], "two seeded sampling runs differ")
    expect(all(0 <= t < cfg.vocab_size for o in runs[0] for t in o),
           "sampled tokens out of vocabulary")
    return {"phase": "sampling_engine", "requests": len(prompts),
            "replayed": True, "launches": total}, total


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 1 (no timing, no engine)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.inference import decode as dec
    from paddle_tpu_torch.ops.cuda import _build, counters
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import sampling as samp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    try:
        t0 = time.perf_counter()
        logs = _build.build_all(ptxas_verbose=True)
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": sorted(logs), "ptxas": logs})

        timing = not args.kernels_only
        k4a = check_attention(torch, pa, rng, False, timing)
        k4b = check_attention(torch, pa, rng, True, timing)
        k5 = check_sampling(torch, samp, rng, timing)
        emit({"phase": "kernels_vs_plain", "paged_attention": k4a,
              "paged_attention_quant": k4b, "fused_sample": k5})
        if args.kernels_only:
            return 0

        cfg = dec.DecodeModelConfig(**FULL)
        t0 = time.perf_counter()
        params = dec.init_decode_params(cfg, seed=0)
        torch.cuda.synchronize()
        emit({"phase": "init", "seconds": time.perf_counter() - t0,
              "params": int(sum(p.numel() for p in params.values()))})
        total = {}
        for phase in (phase_int8, phase_f32, phase_sample):
            row, launches = phase(torch, dec, counters, params, cfg, rng)
            torch.cuda.empty_cache()
            emit(row)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

        src = "paddle_tpu_torch/ops/cuda/csrc/"
        kernels = []
        for name, row, source, replaces in (
                ("paged_attention", k4a, src + "paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:150"),
                ("paged_attention_quant", k4b, src + "paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:241"),
                ("fused_sample", k5, src + "sampling.cu",
                 "paddle_tpu/ops/pallas/sampling.py:85")):
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total.get(name, 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]})
            expect(total.get(name, 0) > 0,
                   f"{name} was not launched on the main path")
        emit({"kernels": kernels})
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    expect(smi.returncode == 0, "nvidia-smi failed")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
