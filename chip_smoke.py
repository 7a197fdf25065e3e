"""Card check of the PyTorch port: builds its CUDA kernel, holds it against
its plain version, and drives GPT-2 125M inference at full width.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one) and ``nvcc`` (the kernel
is built from ``tpu_parallel_torch/csrc`` at first use).  Phases, in order;
any failure raises:

1. setup: card name and power limit, versions, kernel build and ``ptxas``;
2. ``flash_fwd`` kernel against ``flash_fwd_reference`` at shapes (a)-(g),
   with the kernel's, the plain version's and SDPA's times and the bound;
3. forward: ``gpt2_125m(attn_impl="flash")`` on tokens [8, 1024], seeded
   weights, against the same weights under ``attn_impl="xla"``;
4. generate: greedy on 4 ragged prompts, then a top-p sampled call;
5. profile: device time by kernel and the device's idle share over one
   forward and over 8 decode steps (``torch.profiler``).

Weights and inputs are made from ``SEED``.  The kernel launch counter is set
to 0 before phases 3-4 (the main path) and read after them.  The last two lines are the ``kernels`` JSON object and the
``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version: P is rounded to bf16 before P.V and sums run in
# another order (out); lse is fp32 throughout
OUT_TOL = 2e-2
LSE_TOL = 1e-3
# flash vs xla path of the full model, bf16 (the xla path rounds its scores
# to bf16 before the softmax, the kernel keeps them in fp32)
LOSS_TOL = 1e-2
LOGITS_TOL = 0.1
SEED = 0


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms from CUDA events over ``iters`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Mean wall time of ``fn`` in ms, each run ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / iters


def setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    import tpu_parallel_torch
    from tpu_parallel_torch.ops import build

    here = Path(__file__).resolve().parent
    if here not in Path(tpu_parallel_torch.__file__).resolve().parents:
        raise RuntimeError(f"tpu_parallel_torch imported from outside {here}")
    start = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - start:.2f} s wall; nvcc seconds {build.build_seconds}")
    for name, report in build.build_reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def visible_pairs(b, h, s, s_kv, causal, window, q_offset, seg, device):
    """(query, key) pairs the inputs let attend, summed over batch and heads."""
    from tpu_parallel_torch.ops.flash_attention import _band_mask

    mask = _band_mask(0, 0, (s, s_kv), s, s_kv, causal, window, q_offset, device=device)
    if mask is None:
        mask = torch.ones(s, s_kv, dtype=torch.bool, device=device)
    if seg is None:
        return int(mask.sum()) * b * h
    same = seg[:, :, None] == seg[:, None, :]
    return int((mask[None] & same).sum()) * h


def kernel_phase(seed):
    """Phase 2: the kernel against its plain version at shapes (a)-(g)."""
    import torch.nn.functional as F
    from tpu_parallel_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def packed(b, s):
        cuts = torch.sort(torch.randint(1, s - 1, (b, 2), device=dev, generator=gen), dim=1).values
        pos = torch.arange(s, device=dev)[None, :]
        return ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()).to(torch.int32)

    # name: (B, H, H_KV, S, D, kwargs, packed segments, timing iterations)
    shapes = {
        "a_main": (8, 12, 12, 1024, 64, dict(causal=True), False, 50),
        "b_gqa_d128": (2, 16, 4, 2048, 128, dict(causal=True), False, 20),
        "c_window256": (8, 12, 12, 1024, 64, dict(causal=True, window=256), False, 50),
        "d_packed": (8, 12, 12, 1024, 64, dict(causal=True), True, 50),
        "e_offset_plus512": (4, 12, 12, 1024, 64, dict(causal=False, q_offset=512, window=384), False, 50),
        "e_offset_minus512": (4, 12, 12, 1024, 64, dict(causal=False, q_offset=-512, window=384), False, 50),
        "f_stream_8192": (1, 12, 12, 8192, 64, dict(causal=True), False, 10),
        "g_ragged_1000": (8, 12, 12, 1000, 64, dict(causal=True), False, 50),
    }
    rows = {}
    for name, (b, h, h_kv, s, d, kw, pack, iters) in shapes.items():
        q = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
        k = torch.randn(b, h_kv, s, d, device=dev, generator=gen).to(torch.bfloat16)
        v = torch.randn(b, h_kv, s, d, device=dev, generator=gen).to(torch.bfloat16)
        seg = packed(b, s) if pack else None
        with torch.inference_mode():
            out, lse = fa._flash_fwd(q, k, v, seg, seg, **kw)
            ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, seg, seg, **kw)
            torch.cuda.synchronize()
            out_err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            empty_rows = int((ref_lse <= fa.NEG_INF / 2).sum())
            torch.testing.assert_close(out.float(), ref_out.float(), atol=OUT_TOL, rtol=OUT_TOL)
            torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
            if empty_rows:
                assert (out.float()[ref_lse <= fa.NEG_INF / 2] == 0).all()

            ms = cuda_ms(lambda: fa._flash_fwd(q, k, v, seg, seg, **kw), iters)
            plain_ms = cuda_ms(
                lambda: fa.flash_fwd_reference(q, k, v, seg, seg, **kw), max(2, iters // 10), 1
            )
            if kw.get("window") or pack or not kw["causal"]:
                mask = fa._band_mask(0, 0, (s, s), s, s, kw["causal"], kw.get("window", 0),
                                     kw.get("q_offset", 0), device=dev)[None, None]
                if pack:
                    mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=h != h_kv)
            else:
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=h != h_kv)
            library_ms = cuda_ms(lib, iters)
        pairs = visible_pairs(b, h, s, s, kw["causal"], kw.get("window", 0),
                              kw.get("q_offset", 0), seg, dev)
        flops = 4 * d * pairs  # Q.K^T and P.V, 2*D each per visible pair
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
        if seg is not None:
            nbytes += 2 * 4 * seg.numel()
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        row = dict(
            shape=f"B={b} H={h} Hkv={h_kv} S={s} D={d} {kw} packed={pack}",
            max_abs_err=out_err, lse_max_abs_err=lse_err, empty_rows=empty_rows,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            gflop=flops / 1e9, mbytes=nbytes / 1e6, share_of_bound=bound_ms / ms,
            tflops=flops / ms / 1e9,
        )
        rows[name] = row
        log(f"[kernel {name}] {row['shape']}")
        log(f"  out max abs err {out_err:.3e} (atol=rtol={OUT_TOL}), lse max abs err "
            f"{lse_err:.3e} (atol {LSE_TOL}), empty rows {empty_rows}")
        log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {row['bound_by']} ({row['gflop']:.2f} GFLOP, "
            f"{row['mbytes']:.1f} MB), share of bound {row['share_of_bound']:.3f}, "
            f"{row['tflops']:.1f} TFLOP/s")
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return rows


def forward_phase(seed):
    """Phase 3: the full-width forward through the kernel, against xla."""
    from tpu_parallel_torch.core.losses import token_cross_entropy
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.utils.profiling import transformer_flops_per_token

    cfg = gpt2_125m(attn_impl="flash")
    start = time.perf_counter()
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    ref = GPTLM(gpt2_125m(attn_impl="xla"), device="cuda", seed=seed).eval()
    ref.load_state_dict(model.state_dict())
    log(f"[forward] two GPT-2 125M models built in {time.perf_counter() - start:.1f} s")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    targets = tokens.roll(-1, dims=1)
    with torch.inference_mode():
        before = fa.flash_fwd_launches
        logits = model(tokens)
        torch.cuda.synchronize()
        launched = fa.flash_fwd_launches - before
        if launched != cfg.n_layers:
            raise AssertionError(f"forward launched the kernel {launched} times, want {cfg.n_layers}")
        want = ref(tokens)
        if logits.shape != (8, 1024, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        loss = token_cross_entropy(logits, targets).mean().item()
        ref_loss = token_cross_entropy(want, targets).mean().item()
        logit_err = (logits.float() - want.float()).abs().max().item()
        log(f"[forward] loss flash {loss:.6f} xla {ref_loss:.6f} (|diff| {abs(loss - ref_loss):.2e}, "
            f"tol {LOSS_TOL}); logits max abs err {logit_err:.4f} (tol {LOGITS_TOL})")
        if abs(loss - ref_loss) > LOSS_TOL or logit_err > LOGITS_TOL:
            raise AssertionError("flash forward disagrees with the xla forward")
        del want
        ms = host_ms(lambda: model(tokens), 10)
        xla_ms = host_ms(lambda: ref(tokens), 5)
    toks = tokens.numel()
    fwd_flops = transformer_flops_per_token(cfg) / 3 * toks  # a forward is 1/3 of 6N+attn
    log(f"[forward] {ms:.3f} ms per forward [8, 1024] (xla path {xla_ms:.3f} ms), "
        f"{toks / ms * 1e3:.0f} tokens/s, {fwd_flops / ms / 1e9:.1f} TFLOP/s achieved")
    del ref
    torch.cuda.empty_cache()
    return model, dict(forward_ms=ms, xla_forward_ms=xla_ms, tokens_per_s=toks / ms * 1e3,
                       tflops=fwd_flops / ms / 1e9, loss=loss, xla_loss=ref_loss,
                       logits_max_abs_err=logit_err)


def generate_phase(model, seed):
    """Phase 4: ragged greedy and top-p generation; prefill against the
    kernel forward."""
    from tpu_parallel_torch.models.generate import generate, prefill_step

    cfg = model.config
    lengths = [16, 50, 97, 128]
    width, new = max(lengths), 32
    gen = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (len(lengths), width), generator=gen).cuda()
    mask = torch.zeros(len(lengths), width, dtype=torch.bool)
    for r, n in enumerate(lengths):
        mask[r, width - n:] = True  # left-padded
    mask = mask.cuda()
    with torch.inference_mode():
        greedy = generate(model, prompt, max_new_tokens=new, prompt_mask=mask)
        sampled = generate(model, prompt, torch.Generator(device="cuda").manual_seed(seed),
                           max_new_tokens=new, temperature=0.8, top_p=0.9, prompt_mask=mask)
        for name, out in (("greedy", greedy), ("top-p", sampled)):
            if out.shape != (len(lengths), new) or out.min() < 0 or out.max() >= cfg.vocab_size:
                raise AssertionError(f"{name} tokens {tuple(out.shape)} out of range")
        positions = torch.where(mask, mask.long().cumsum(1) - 1, torch.full_like(prompt, -1))
        hidden, _ = prefill_step(model, prompt, positions)
        dec_logits = model.lm_head(hidden[:, -1]).float()
        err = 0.0
        for r, n in enumerate(lengths):
            fwd = model(prompt[r:r + 1, width - n:])[0, -1].float()
            err = max(err, (fwd - dec_logits[r]).abs().max().item())
        log(f"[generate] greedy {tuple(greedy.shape)} first row {greedy[0, :8].tolist()}, "
            f"top-p {tuple(sampled.shape)}; prefill last-position logits vs kernel forward "
            f"max abs err {err:.4f} (tol {LOGITS_TOL})")
        if err > LOGITS_TOL:
            raise AssertionError("decode-path prefill disagrees with the kernel forward")
        prefill_ms = host_ms(lambda: generate(model, prompt, max_new_tokens=1, prompt_mask=mask), 5)
        total_ms = host_ms(lambda: generate(model, prompt, max_new_tokens=new + 1, prompt_mask=mask), 3)
    decode_tps = len(lengths) * new / ((total_ms - prefill_ms) / 1e3)
    log(f"[generate] prefill [4, {width}] + first token {prefill_ms:.3f} ms; decode "
        f"{decode_tps:.1f} tokens/s at batch {len(lengths)} "
        f"({(total_ms - prefill_ms) / new:.3f} ms per step)")
    return dict(prefill_ms=prefill_ms, decode_tokens_per_s=decode_tps,
                decode_step_ms=(total_ms - prefill_ms) / new)


def profile_phase(model, seed):
    """Device time by kernel and the device's busy share over one forward
    [8, 1024] and over 8 decode steps at batch 4 (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_parallel_torch.models.generate import generate

    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, model.config.vocab_size, (8, 1024), generator=gen).cuda()
    prompt = tokens[:4, :128].contiguous()
    runs = {
        "forward [8, 1024]": lambda: model(tokens),
        "generate [4, 128] + 8 new": lambda: generate(model, prompt, max_new_tokens=8),
    }
    for name, fn in runs.items():
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - start) * 1e6
        # device-side entries only: an aten op's entry repeats its kernels' time
        events = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_us = sum(t for _, _, t in events)
        log(f"[profile {name}] wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"(idle share {1 - busy_us / wall_us:.3f})")
        for key, count, t in sorted(events, key=lambda e: -e[2])[:10]:
            log(f"  {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% x{count:<5d} {key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = setup()
    kernel_rows = kernel_phase(SEED)

    from tpu_parallel_torch.ops import flash_attention as fa

    fa.flash_fwd_launches = 0  # the main path starts here
    model, fwd = forward_phase(SEED)
    gen = generate_phase(model, SEED)
    launches = fa.flash_fwd_launches
    if launches == 0:
        raise AssertionError("the main path never launched flash_fwd")
    profile_phase(model, SEED)
    main_row = kernel_rows["a_main"]
    kernels = {"kernels": [dict(
        name="flash_fwd", route="cuda", source="tpu_parallel_torch/csrc/flash_fwd.cu",
        replaces="tpu_parallel/ops/flash_attention.py:240", launches=launches,
        max_abs_err=main_row["max_abs_err"], ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
    )]}
    summary = dict(card=smi, forward=fwd, generate=gen, kernel_shapes=kernel_rows)
    log("[summary] " + json.dumps(summary, sort_keys=True))
    log(f"card: {smi}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
