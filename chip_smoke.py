"""Card check of the PyTorch port: builds its CUDA kernels, holds each
against its plain version, and drives GPT-2 125M inference and training at
full width.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one) and ``nvcc`` (the kernels
are built from ``tpu_parallel_torch/csrc`` at first use, one ``nvcc`` per
source, all started together).  Phases, in order; any failure raises:

1. setup: card name and power limit, versions, kernel builds and ``ptxas``;
2. ``flash_fwd`` kernel against ``flash_fwd_reference`` at shapes (a)-(g)
   and the training pass's shape, in both layouts: the main path's (q, k, v
   views of a fused [B, S, H, 3D] qkv buffer, or q and views of a
   [B, S, H_KV, 2D] kv buffer under GQA; out written [B, S, H, D]) and the
   JAX layout [B, H, S, D], whose outputs must be bitwise equal; the
   kernel's time on the main path's layout and SDPA's on the same inputs in
   turns (kernel, SDPA, SDPA, kernel; medians), the [B, H, S, D] layout's
   and the plain version's times, and the bound;
2b. ``flash_bwd`` (one pass for dq, dk and dv) against
   ``flash_bwd_reference`` at shapes (a)-(g) and the training pass's shape,
   row by row, dq exactly 0 on empty rows; the kernel's time and SDPA's
   backward time taken in turns (kernel, SDPA, SDPA, kernel; medians), the
   plain version's time and the one-pass bound; at (a), planted faults that
   the row check must reject; at the training pass, two runs: dk and dv
   bitwise equal, dq's largest difference printed; and the same pass on the
   main path's layout (strided q, k, v, out, do; dq, dk, dv written
   [B, S, H, D]): within the row rule, dk and dv bitwise equal to the
   [B, H, S, D] run's, and its time;
3. forward: ``gpt2_125m(attn_impl="flash")`` on tokens [8, 1024], seeded
   weights, against the same weights under ``attn_impl="xla"``;
4. generate: greedy on 4 ragged prompts, then a top-p sampled call;
5. profile: device time by kernel and kind, the copy kernels by name with
   their counts, and the device's idle share over one forward and over 8
   decode steps (``torch.profiler``); the profile of one training step runs
   at the end of phase 6, after its counted steps;
6. training: the ``Trainer`` at ``bench.py``'s shape (GPT-2 125M, flash,
   "proj_attn" remat, global batch 256 in 16 minibatches of [16, 1024]):
   3 warm-up and 12 timed steps, launches per step, step time, tokens/s,
   MFU and peak memory; one minibatch's loss and gradients against the
   xla path; a profile of one step.

Weights and inputs are made from ``SEED``.  The kernel launch counters are
set to 0 before each main path (phases 3-4: inference; phase 6's steps:
training) and read after it.  The last two lines are the ``kernels`` JSON
object and the ``{"ok": true, ...}`` line.
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
# backward kernels vs plain version, row by row (one query's dq, one key's dk
# or dv, over D): ||got - plain|| <= GRAD_RTOL * ||plain row|| + GRAD_ATOL *
# (rms row norm of the tensor).  A row's error comes from the bf16 rounding of
# its own elements (rms 2^-9 / sqrt(3) = 1.1e-3 relative), ds and p rounded to
# bf16 where the kernel's fp32 scores differ in their last bits, and sums in
# another order: a few 1e-3 of the row's norm, so GRAD_RTOL = 2e-2 leaves 4x
# and more.  GRAD_ATOL covers rows that are rounding noise in both, such as
# the dq of a query that sees one key (ds = p * (dp - delta) cancels).  Each
# row is held to its own norm, so a kernel that drops the contributions to
# the late keys (whose rows are small under a causal mask) fails; phase 2b
# plants two such faults and checks that this rule rejects them.
GRAD_RTOL = 2e-2
GRAD_ATOL = 1e-3
# flash vs xla path of the full model, bf16 (the xla path rounds its scores
# to bf16 before the softmax, the kernel keeps them in fp32)
LOSS_TOL = 1e-2
LOGITS_TOL = 0.1
# flash vs xla gradients of one training minibatch, relative L2 error per
# weight: bf16 activations and gradients through 12 layers, and the xla
# path's bf16 scores; the key slice of the qkv bias is left out (its
# gradient is zero in exact arithmetic, so both paths give rounding noise)
TRAIN_GRAD_TOL = 5e-2
SEED = 0
# cycles of the spin kernel `cuda_ms` queues per timed run: about 0.2 ms at
# the H100's clock, more than the host takes to launch one of the timed calls
SPIN_CYCLES_PER_RUN = 400_000
# name: (B, H, H_KV, S, D, kwargs, packed segments, timing iterations)
SHAPES = {
    "a_main": (8, 12, 12, 1024, 64, dict(causal=True), False, 50),
    "b_gqa_d128": (2, 16, 4, 2048, 128, dict(causal=True), False, 20),
    "c_window256": (8, 12, 12, 1024, 64, dict(causal=True, window=256), False, 50),
    "d_packed": (8, 12, 12, 1024, 64, dict(causal=True), True, 50),
    "e_offset_plus512": (4, 12, 12, 1024, 64, dict(causal=False, q_offset=512, window=384), False, 50),
    "e_offset_minus512": (4, 12, 12, 1024, 64, dict(causal=False, q_offset=-512, window=384), False, 50),
    "f_stream_8192": (1, 12, 12, 8192, 64, dict(causal=True), False, 10),
    "g_ragged_1000": (8, 12, 12, 1000, 64, dict(causal=True), False, 50),
}
# the shape the training pass gives the kernels: [16, 1024] per minibatch
TRAIN_SHAPE = (16, 12, 12, 1024, 64, dict(causal=True), False, 20)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms from CUDA events over ``iters`` runs.
    A spin kernel queued first keeps the card busy while the host enqueues
    the runs, so a call whose kernels are shorter than the host's work to
    launch them is timed on the device and not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_RUN * iters)
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


def _packed(b, s, gen):
    dev = gen.device
    cuts = torch.sort(torch.randint(1, s - 1, (b, 2), device=dev, generator=gen), dim=1).values
    pos = torch.arange(s, device=dev)[None, :]
    return ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()).to(torch.int32)


def _inputs(shape, gen, with_do=False):
    """bf16 q, k, v (and do) and the segment ids (or None) of one shape."""
    b, h, h_kv, s, d, _, pack, _ = shape
    dev = gen.device
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=dev, generator=gen).to(torch.bfloat16)
    seg = _packed(b, s, gen) if pack else None
    if not with_do:
        return q, k, v, seg
    do = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
    return q, k, v, seg, do


def _sdpa_mask(kw, s, seg, dev):
    """The boolean mask SDPA needs for a shape (None: plain causal)."""
    from tpu_parallel_torch.ops import flash_attention as fa

    if not (kw.get("window") or seg is not None or not kw["causal"]):
        return None
    mask = fa._band_mask(0, 0, (s, s), s, s, kw["causal"], kw.get("window", 0),
                         kw.get("q_offset", 0), device=dev)[None, None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
    return mask


def grad_error_ratio(got, want):
    """Worst row of ``got`` against ``want``: its L2 error over its limit,
    GRAD_RTOL * ||row|| + GRAD_ATOL * rms row norm; at most 1 passes."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = (g - w).norm(dim=-1)
    ref = w.norm(dim=-1)
    limit = GRAD_RTOL * ref + GRAD_ATOL * ref.square().mean().sqrt()
    return (err / limit.clamp(min=1e-30)).max().item()


def _bound(flops, nbytes):
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms > bytes_ms else "bytes"


def main_path_layout(*tensors):
    """The same values as [B, H, S, D]-shaped views in the layout the model
    hands the kernels: q, k, v as views of one fused [B, S, H, 3D] buffer
    when the heads match, as ``Attention.qkv`` makes
    them; under GQA q contiguous in [B, S, H, D] and k, v views of a fused
    [B, S, H_KV, 2D] buffer, as ``Attention.q`` and ``.kv`` do.  Further
    tensors (do) come back contiguous in [B, S, H, D], as the gradient of
    the model's output projection arrives."""
    q, k = tensors[:2]
    d = q.shape[3]
    bshd = [x.transpose(1, 2) for x in tensors]
    fused = 3 if q.shape[1] == k.shape[1] else 2  # q, k, v or k, v share a buffer
    views = [x.transpose(1, 2) for x in torch.cat(bshd[3 - fused:3], dim=-1).split(d, dim=-1)]
    rest = [x.contiguous().transpose(1, 2) for x in bshd[3:]]
    return [x.contiguous().transpose(1, 2) for x in bshd[:3 - fused]] + views + rest


def in_turns(fns, iters):
    """Medians of ``cuda_ms`` of each of two callables timed in turns (a,
    b, b, a), with the list of each one's times."""
    import statistics

    turns = ([], [])
    for i in (0, 1, 1, 0):
        turns[i].append(cuda_ms(fns[i], iters))
    return [statistics.median(t) for t in turns], turns


def kernel_phase(seed):
    """Phase 2: the kernel against its plain version at shapes (a)-(g), in
    the main path's layout and in [B, H, S, D]."""
    import torch.nn.functional as F
    from tpu_parallel_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for name, shape in {**SHAPES, "t_train_pass": TRAIN_SHAPE}.items():
        b, h, h_kv, s, d, kw, pack, iters = shape
        q, k, v, seg = _inputs(shape, gen)
        qm, km, vm = main_path_layout(q, k, v)
        with torch.inference_mode():
            out, lse = fa._flash_fwd(qm, km, vm, seg, seg, **kw)
            out_bhsd, lse_bhsd = fa._flash_fwd(q, k, v, seg, seg, **kw)
            ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, seg, seg, **kw)
            torch.cuda.synchronize()
            if not out.transpose(1, 2).is_contiguous():
                raise AssertionError(f"{name}: out is not [B, S, H, D] in memory")
            if not (torch.equal(out, out_bhsd) and torch.equal(lse, lse_bhsd)):
                raise AssertionError(f"{name}: out/lse differ between the two layouts")
            out_err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            empty_rows = int((ref_lse <= fa.NEG_INF / 2).sum())
            torch.testing.assert_close(out.float(), ref_out.float(), atol=OUT_TOL, rtol=OUT_TOL)
            torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
            if empty_rows:
                assert (out.float()[ref_lse <= fa.NEG_INF / 2] == 0).all()

            mask = _sdpa_mask(kw, s, seg, dev)
            (ms, library_ms), turns = in_turns((
                lambda: fa._flash_fwd(qm, km, vm, seg, seg, **kw),
                lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=mask,
                                                       is_causal=mask is None,
                                                       enable_gqa=h != h_kv),
            ), iters)
            ms_bhsd = cuda_ms(lambda: fa._flash_fwd(q, k, v, seg, seg, **kw), iters)
            plain_ms = cuda_ms(
                lambda: fa.flash_fwd_reference(q, k, v, seg, seg, **kw), max(2, iters // 10), 1
            )
        pairs = visible_pairs(b, h, s, s, kw["causal"], kw.get("window", 0),
                              kw.get("q_offset", 0), seg, dev)
        flops = 4 * d * pairs  # Q.K^T and P.V, 2*D each per visible pair
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
        if seg is not None:
            nbytes += 2 * 4 * seg.numel()
        bound_ms, bound_by = _bound(flops, nbytes)
        row = dict(
            shape=f"B={b} H={h} Hkv={h_kv} S={s} D={d} {kw} packed={pack}",
            layout="views of fused [B, S, H, 3D] qkv" if h == h_kv
            else "q [B, S, H, D], k/v views of fused [B, S, Hkv, 2D] kv",
            max_abs_err=out_err, lse_max_abs_err=lse_err, empty_rows=empty_rows,
            bitwise_equal_across_layouts=True, ms=ms, kernel_turns_ms=turns[0], ms_bhsd=ms_bhsd,
            plain_ms=plain_ms, library_ms=library_ms, sdpa_turns_ms=turns[1], bound_ms=bound_ms,
            bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
            share_of_bound=bound_ms / ms, tflops=flops / ms / 1e9,
        )
        rows[name] = row
        log(f"[kernel {name}] {row['shape']}; main-path layout: {row['layout']}")
        log(f"  out max abs err {out_err:.3e} (atol=rtol={OUT_TOL}), lse max abs err "
            f"{lse_err:.3e} (atol {LSE_TOL}), empty rows {empty_rows}; out and lse bitwise "
            f"equal in [B, H, S, D]")
        log(f"  kernel {ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns[0])}), SDPA "
            f"{library_ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns[1])}), kernel on "
            f"[B, H, S, D] {ms_bhsd:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by "
            f"{row['bound_by']} ({row['gflop']:.2f} GFLOP, {row['mbytes']:.1f} MB), share of "
            f"bound {row['share_of_bound']:.3f}, {row['tflops']:.1f} TFLOP/s")
        del q, k, v, qm, km, vm, out, lse, out_bhsd, lse_bhsd, ref_out, ref_lse
        torch.cuda.empty_cache()
    return rows


def backward_kernel_phase(seed):
    """Phase 2b: the backward kernel against its plain version at shapes
    (a)-(g) and the training pass's shape."""
    import statistics

    import torch.nn.functional as F
    from tpu_parallel_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    rows = {}
    for name, shape in {**SHAPES, "t_train_pass": TRAIN_SHAPE}.items():
        b, h, h_kv, s, d, kw, pack, iters = shape
        q, k, v, seg, do = _inputs(shape, gen, with_do=True)
        causal, window, q_offset = kw["causal"], kw.get("window", 0), kw.get("q_offset", 0)
        kernel = lambda: fa._flash_bwd(q, k, v, seg, seg, out, lse, do, **kw)
        row = dict(shape=f"B={b} H={h} Hkv={h_kv} S={s} D={d} {kw} packed={pack}")
        with torch.inference_mode():
            out, lse = fa._flash_fwd(q, k, v, seg, seg, **kw)
            got = kernel()
            want = fa.flash_bwd_reference(q, k, v, seg, seg, out, lse, do, **kw)
            torch.cuda.synchronize()
            errs, scales, ratios = {}, {}, {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[gname] = (g.float() - w.float()).abs().max().item()
                scales[gname] = w.float().abs().max().item()
                ratios[gname] = grad_error_ratio(g, w)
                if ratios[gname] > 1:
                    raise AssertionError(
                        f"{name}: a row of {gname} is {ratios[gname]:.2f}x its limit "
                        f"({GRAD_RTOL} * ||row|| + {GRAD_ATOL} * rms row norm)")
            empty = lse <= fa.NEG_INF / 2
            row["empty_rows"] = int(empty.sum())
            if row["empty_rows"] and not (got[0][empty] == 0).all():
                raise AssertionError(f"{name}: dq is not 0 on the {row['empty_rows']} empty rows")
            if name == "a_main":
                row["planted_faults"] = planted_faults((q, k, v, out, do, lse), kw, want)
            if name == "t_train_pass":
                again = kernel()
                torch.cuda.synchronize()
                if not (torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])):
                    raise AssertionError("dk / dv differ between two runs on the same inputs")
                row["dkv_bitwise_equal_across_runs"] = True
                row["dq_run_to_run_max_abs"] = (again[0].float() - got[0].float()).abs().max().item()
                row["dq_run_to_run_worst_row_ratio"] = grad_error_ratio(again[0], got[0])
                del again
                # the main path's layout: q, k, v views of the fused qkv buffer,
                # out and do [B, S, H, D] in memory; dq, dk, dv written so
                qm, km, vm, om, dom = main_path_layout(q, k, v, out, do)
                strided = lambda: fa._flash_bwd(qm, km, vm, seg, seg, om, lse, dom, **kw)
                got_m = strided()
                torch.cuda.synchronize()
                if not all(g.transpose(1, 2).is_contiguous() for g in got_m):
                    raise AssertionError("dq, dk, dv are not [B, S, H, D] in memory")
                ratios_m = {g: grad_error_ratio(x, w)
                            for g, x, w in zip(("dq", "dk", "dv"), got_m, want)}
                if max(ratios_m.values()) > 1:
                    raise AssertionError(f"strided backward: worst rows {ratios_m} over limit")
                if not (torch.equal(got_m[1], got[1]) and torch.equal(got_m[2], got[2])):
                    raise AssertionError("strided dk / dv differ from the [B, H, S, D] run's")
                row["main_path_layout"] = dict(
                    worst_row_ratio=ratios_m, dkv_bitwise_equal_to_bhsd=True,
                    ms=cuda_ms(strided, iters))
                del got_m
            del got, want
            plain_ms = cuda_ms(
                lambda: fa.flash_bwd_reference(q, k, v, seg, seg, out, lse, do, **kw),
                max(2, iters // 10), 1)
        # SDPA's backward alone, on a retained graph, timed in turns with the kernel
        mask = _sdpa_mask(kw, s, seg, dev)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, is_causal=mask is None,
                                                  enable_gqa=h != h_kv)
        sdpa = lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True)
        turns = {"kernel": [], "sdpa": []}
        for who in ("kernel", "sdpa", "sdpa", "kernel"):
            with torch.inference_mode(who == "kernel"):
                turns[who].append(cuda_ms(kernel if who == "kernel" else sdpa, iters))
        del sdpa_out, leaves
        ms, library_ms = statistics.median(turns["kernel"]), statistics.median(turns["sdpa"])
        pairs = visible_pairs(b, h, s, s, causal, window, q_offset, seg, dev)
        flops = 10 * d * pairs  # S, dP, dV, dK and dQ, 2*D each per visible pair
        # inputs read once (q, k, v, out, do, lse, segment ids), outputs written once
        nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * do.numel()) + 4 * lse.numel()
        if seg is not None:
            nbytes += 2 * 4 * seg.numel()
        bound_ms, bound_by = _bound(flops, nbytes)
        row.update(
            max_abs_err=max(errs.values()), errs=errs, max_abs_plain=scales,
            worst_row_ratio=ratios, ms=ms, kernel_turns_ms=turns["kernel"], plain_ms=plain_ms,
            library_ms=library_ms, sdpa_turns_ms=turns["sdpa"], bound_ms=bound_ms,
            bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
            share_of_bound=bound_ms / ms, tflops=flops / ms / 1e9,
        )
        rows[name] = row
        log(f"[bwd kernel {name}] {row['shape']}")
        log("  worst row over its limit " + ", ".join(f"{g} {ratios[g]:.3f}" for g in ratios)
            + f" (limit {GRAD_RTOL} * ||row|| + {GRAD_ATOL} * rms row norm; passes <= 1); "
            + "max abs err " + ", ".join(f"{g} {errs[g]:.3e} (max |plain| {scales[g]:.3e})"
                                         for g in errs)
            + f"; empty rows {row['empty_rows']} (dq 0 there)")
        if "planted_faults" in row:
            log("  planted faults, worst row over its limit (and max abs err over max |plain|): "
                + ", ".join(f"{f} {r['worst_row_ratio']:.2f} ({r['max_abs_over_max']:.3e})"
                            for f, r in row["planted_faults"].items()))
        if "dq_run_to_run_max_abs" in row:
            log(f"  two runs: dk, dv bitwise equal; dq max |run 1 - run 2| "
                f"{row['dq_run_to_run_max_abs']:.3e} (worst row {row['dq_run_to_run_worst_row_ratio']:.3f}"
                f" of its limit; fp32 atomics sum dq in a varying order)")
        if "main_path_layout" in row:
            m = row["main_path_layout"]
            log("  main-path layout (q, k, v views of fused qkv; out, do, dq, dk, dv "
                "[B, S, H, D]): worst row over its limit "
                + ", ".join(f"{g} {r:.3f}" for g, r in m["worst_row_ratio"].items())
                + f"; dk, dv bitwise equal to the [B, H, S, D] run's; {m['ms']:.4f} ms")
        log(f"  kernel {ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns['kernel'])}), "
            f"SDPA backward (dq, dk, dv) {library_ms:.4f} ms (turns "
            f"{', '.join(f'{x:.4f}' for x in turns['sdpa'])}), plain {plain_ms:.4f} ms; one-pass "
            f"bound {bound_ms:.4f} ms by {bound_by} ({row['gflop']:.2f} GFLOP, "
            f"{row['mbytes']:.1f} MB), share of bound {row['share_of_bound']:.3f}, "
            f"{row['tflops']:.1f} TFLOP/s")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return rows


def planted_faults(tensors, kw, want):
    """Kernel faults the backward check must reject, made with the real
    kernel by hiding keys or queries through the segment ids while lse and
    delta stay those of the whole input: dq without the last 64 keys, dk/dv
    without the last 64 queries, and dk/dv that leave out every key of the
    second half (rows that are small under a causal mask).  Raises if a
    fault's worst row is within its limit; returns each fault's worst-row
    ratio and its max abs error over max |plain|."""
    q, k, v, out, do, lse = tensors
    bwd = torch.ops.tpu_parallel_torch.flash_bwd
    s = q.shape[2]
    none = torch.zeros(q.shape[0], s, dtype=torch.int32, device=q.device)
    last_tile, second_half = none.clone(), none.clone()
    last_tile[:, -64:] = 1
    second_half[:, s // 2:] = 1
    opts = (kw["causal"], kw.get("window", 0), kw.get("q_offset", 0))
    dq = bwd(q, k, v, out, do, lse, None, none, last_tile, *opts)[0]
    dkv_tile = bwd(q, k, v, out, do, lse, None, last_tile, none, *opts)[1:]
    dkv_half = bwd(q, k, v, out, do, lse, None, none, second_half, *opts)[1:]
    faults = {}
    for fault, got, w in (("dq_without_last_64_keys", dq, want[0]),
                          ("dk_without_last_64_queries", dkv_tile[0], want[1]),
                          ("dv_without_last_64_queries", dkv_tile[1], want[2]),
                          ("dk_without_second_half_keys", dkv_half[0], want[1]),
                          ("dv_without_second_half_keys", dkv_half[1], want[2])):
        w = w.float()
        faults[fault] = dict(worst_row_ratio=grad_error_ratio(got, w),
                             max_abs_over_max=((got.float() - w).abs().max() / w.abs().max()).item())
        if faults[fault]["worst_row_ratio"] <= 1:
            raise AssertionError(f"the backward check passes a planted fault: {fault} {faults[fault]}")
    return faults


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


# kinds of device kernels in a profile, by a substring of their names
PROFILE_GROUPS = (
    ("flash kernels", ("flash_fwd_kernel", "flash_bwd_")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
    ("softmax/CE", ("SoftMax", "softmax", "nll_loss")),
    ("LayerNorm", ("layer_norm", "GammaBeta")),
    ("copies/casts", ("copy", "Memcpy", "Memset")),
)


def _profile(name, fn, grad=False):
    """Device time by kernel and the device's idle share over one call of
    ``fn`` after a warm-up call (``torch.profiler``)."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.inference_mode():
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
    groups = {}
    for key, _, t in events:
        group = next((g for g, marks in PROFILE_GROUPS if any(m in key for m in marks)), "other")
        groups[group] = groups.get(group, 0.0) + t
    log("  by kind: " + ", ".join(f"{g} {t / 1e3:.3f} ms ({100 * t / busy_us:.1f}%)"
                                  for g, t in sorted(groups.items(), key=lambda e: -e[1])))
    for label, mark in (("forward", "flash_fwd_"), ("backward", "flash_bwd_")):
        picked = [(c, t) for key, c, t in events if mark in key]
        if picked:
            log(f"  flash {label} kernels: {sum(t for _, t in picked) / 1e3:.3f} ms in "
                f"{sum(c for c, _ in picked)} launches")
    # copy kernels by name: layout copies, dtype casts and concatenations all
    # run through PyTorch's copy kernels
    copies = [e for e in events if "copy" in e[0].lower()]
    log(f"  copy kernels: {sum(c for _, c, _ in copies)} launches, "
        f"{sum(t for _, _, t in copies) / 1e3:.3f} ms")
    for key, count, t in sorted(copies, key=lambda e: -e[2]):
        log(f"    {t / 1e3:9.3f} ms x{count:<5d} {key[:150]}")
    for key, count, t in sorted(events, key=lambda e: -e[2])[:12]:
        log(f"  {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% x{count:<5d} {key[:90]}")


def profile_phase(model, seed):
    """Phase 5: one forward [8, 1024] and 8 decode steps at batch 4."""
    from tpu_parallel_torch.models.generate import generate

    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, model.config.vocab_size, (8, 1024), generator=gen).cuda()
    prompt = tokens[:4, :128].contiguous()
    _profile("forward [8, 1024]", lambda: model(tokens))
    _profile("generate [4, 128] + 8 new", lambda: generate(model, prompt, max_new_tokens=8))


LAUNCH_COUNTERS = ("flash_fwd_launches", "flash_bwd_launches")


def train_phase(seed, card_name):
    """Phase 6: bench.py's training loop on the port's Trainer, launches per
    step, throughput and memory; flash against xla gradients on one
    minibatch; a profile of one step.  Returns the main path's launches."""
    import dataclasses
    import math

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig
    from tpu_parallel_torch.utils.profiling import peak_flops, transformer_flops_per_token

    warmup, timed = 3, 12
    config = TrainerConfig(
        model="gpt2_125m", global_batch_size=256, num_minibatches=16, steps=warmup + timed,
        seed=seed, model_overrides=dict(dropout_rate=0.0, remat=True, remat_policy="proj_attn",
                                        attn_impl="flash", scan_layers=False),
    )
    start = time.perf_counter()
    trainer = Trainer(config, device="cuda")
    state = trainer.init()
    batch = trainer.example_batch
    cfg = trainer.model_config
    log(f"[train] GPT-2 125M trainer (fp32 masters, AdamW) built in "
        f"{time.perf_counter() - start:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for name in LAUNCH_COUNTERS:  # the training main path starts here
        setattr(fa, name, 0)
    per_step, step_metrics = [], []
    t0 = None
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = [getattr(fa, name) for name in LAUNCH_COUNTERS]
        state, metrics = trainer.step_fn(state, None, batch)
        per_step.append([getattr(fa, name) - n for name, n in zip(LAUNCH_COUNTERS, before)])
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: getattr(fa, name) for name in LAUNCH_COUNTERS}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [compute(m)["loss"] for m in step_metrics]
    want = cfg.n_layers * config.num_minibatches
    if any(n != [want] * len(LAUNCH_COUNTERS) for n in per_step):
        raise AssertionError(f"launches per step (fwd, bwd) {per_step}, want {want} each")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: {losses}")
    tokens = config.global_batch_size * cfg.seq_len
    step_ms = dt / timed * 1e3
    tokens_per_s = tokens * timed / dt
    peak = peak_flops(card_name)
    mfu = tokens_per_s * transformer_flops_per_token(cfg) / peak if peak else None
    log(f"[train] losses by step {[round(x, 5) for x in losses]}")
    log(f"[train] launches per step (flash_fwd, flash_bwd) {per_step[-1]} "
        f"in every step, {launches} over {warmup + timed} steps")
    log(f"[train] {step_ms:.2f} ms per step of {tokens} tokens ({config.num_minibatches} "
        f"minibatches of [16, 1024]), {tokens_per_s:.0f} tokens/s, MFU {mfu} against "
        f"{peak} FLOP/s ({card_name}); max memory allocated {peak_mem / 2**30:.2f} GiB")

    # one minibatch's loss and gradients, flash against xla on the same weights
    mb = batch.rows(0, config.global_batch_size // config.num_minibatches)
    ref = GPTLM(dataclasses.replace(cfg, attn_impl="xla"), device="cuda", seed=seed)
    ref.load_state_dict(trainer.model.state_dict())
    results = {}
    for name, model in (("flash", trainer.model), ("xla", ref)):
        loss, _ = make_gpt_loss(model.config)(model, mb)
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.float() for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    del ref
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model, device="cuda") % (3 * dh)) // dh != 1
    rel = {}
    for n, g_x in results["xla"][1].items():
        g_f = results["flash"][1][n]
        if n.endswith("attn.qkv.bias"):
            g_f, g_x = g_f[not_key], g_x[not_key]
        rel[n] = ((g_f - g_x).norm() / g_x.norm().clamp(min=1e-30)).item()
    worst = max(rel, key=rel.get)
    loss_diff = abs(results["flash"][0] - results["xla"][0])
    log(f"[train] minibatch loss flash {results['flash'][0]:.6f} xla {results['xla'][0]:.6f} "
        f"(|diff| {loss_diff:.2e}, tol {LOSS_TOL}); gradient relative L2 error median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e}, max {rel[worst]:.3e} ({worst}), tol "
        f"{TRAIN_GRAD_TOL}")
    if loss_diff > LOSS_TOL or rel[worst] > TRAIN_GRAD_TOL:
        raise AssertionError("flash training gradients disagree with the xla path")
    del results
    torch.cuda.empty_cache()

    _profile("train step [256, 1024] in 16 minibatches",
             lambda: trainer.step_fn(trainer.state, None, batch), grad=True)
    return launches, dict(
        losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu, peak_flops=peak,
        max_memory_allocated=peak_mem, launches_per_step=per_step[-1],
        flash_xla_loss=(loss_diff, LOSS_TOL), flash_xla_grad_rel_l2_max=(rel[worst], worst),
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = setup()
    kernel_rows = kernel_phase(SEED)
    bwd_rows = backward_kernel_phase(SEED)

    from tpu_parallel_torch.ops import flash_attention as fa

    for name in LAUNCH_COUNTERS:  # the inference main path starts here
        setattr(fa, name, 0)
    model, fwd = forward_phase(SEED)
    gen = generate_phase(model, SEED)
    inference_launches = fa.flash_fwd_launches
    if inference_launches == 0:
        raise AssertionError("the inference path never launched flash_fwd")
    log(f"[inference] flash_fwd launches over phases 3-4: {inference_launches}")
    profile_phase(model, SEED)
    del model
    torch.cuda.empty_cache()
    launches, train = train_phase(SEED, smi.split(",")[0].strip())
    if not all(launches.values()):
        raise AssertionError(f"the training path left a kernel unlaunched: {launches}")

    # one row per kernel and main path, each at the shape that path gives it:
    # the forward at (a) for inference and at the training pass;
    # the backward, one pass for dq, dk and dv, at the training pass
    train_row = bwd_rows["t_train_pass"]
    kernels = {"kernels": [
        dict(name="flash_fwd", route="cuda", source="tpu_parallel_torch/csrc/flash_fwd.cu",
             replaces="tpu_parallel/ops/flash_attention.py:240", path=path,
             shape=kernel_rows[shape]["shape"], layout=kernel_rows[shape]["layout"], launches=n,
             max_abs_err=kernel_rows[shape]["max_abs_err"], ms=kernel_rows[shape]["ms"],
             plain_ms=kernel_rows[shape]["plain_ms"], bound_ms=kernel_rows[shape]["bound_ms"],
             bound_by=kernel_rows[shape]["bound_by"], library_ms=kernel_rows[shape]["library_ms"])
        for path, shape, n in (("inference", "a_main", inference_launches),
                               ("training", "t_train_pass", launches["flash_fwd_launches"]))
    ] + [
        dict(name="flash_bwd", route="cuda", source="tpu_parallel_torch/csrc/flash_bwd.cu",
             replaces="tpu_parallel/ops/flash_attention.py:464,563", path="training",
             shape=train_row["shape"], launches=launches["flash_bwd_launches"],
             max_abs_err=train_row["max_abs_err"], ms=train_row["ms"],
             plain_ms=train_row["plain_ms"], bound_ms=train_row["bound_ms"],
             bound_by=train_row["bound_by"], library_ms=train_row["library_ms"],
             library_covers="dq+dk+dv", ms_main_path_layout=train_row["main_path_layout"]["ms"])
    ]}
    summary = dict(card=smi, forward=fwd, generate=gen, train=train,
                   inference_flash_fwd_launches=inference_launches,
                   kernel_shapes=kernel_rows, bwd_kernel_shapes=bwd_rows)
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
