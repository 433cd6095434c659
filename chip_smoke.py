"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``multihmr_tpu_torch/csrc`` and drives
the port's paths with seeded random weights and the synthetic SMPL-X-sized
body model: single-image ``multiHMR_896_L`` inference through the demo's
per-image entry point, ``multiHMR_896_L`` training through ``Trainer.fit``,
and the BEDLAM training CLI (``cli/train.py``) with its epoch-end BEDLAM and
EHF evaluation, on the ViT's standard stream (``--tp_mode ring``, K5) and its
channels-major one (``heads``, K1 and K2). Phases, one line each:

  1. the card, its name and power limit (nvidia-smi);
  2. the kernel build;
  3. K1 (flash-attention forward) against its plain version at the ViT's
     lengths: bf16 at the pre-padded lengths (2,312, 4,104 and 8,472 tokens,
     junk past kv_len = 2,305, 4,097 and 8,465), fp32 at the true odd
     lengths, and at batch 2 (the training path's shape);
  4. K2 (channels-major LayerNorm) against its plain version;
  5. multiHMR_672_S in fp32 (LayerScale 0.5, so that the blocks move the
     stream): the card (kernels) against the CPU (plain versions), same
     weights and image, with 12 K1 and 24 K2 launches;
  6. multiHMR_896_L in bf16 on three images: finite meshes, and 24 K1 and
     48 K2 launches per image;
  7. times (CUDA events, medians after warm-up): the 896_L forward at batch 1,
     and each forward kernel against its plain version at the 896_L shapes
     (K1 on the pre-padded [1, 16, 64, 4104] with kv_len 4097; its bound and
     SDPA's forward on the 4,097 true tokens);
  8. K3 (fused flash backward) and K4a + K4b (two-pass, the path of
     ``_flash_bwd_impl_t(fused=False)``, whose launches are counted here)
     against the plain backward on phase 3's cases, and at batch 2 writing
     one packed [B, 3, H, 64, N] gradient as the training path does; dk and
     dv past kv_len exact zeros; K3 against K4a + K4b;
  9. one multiHMR_672_S fp32 train step at batch 2 (ViT cut to 4 of its 12
     blocks), the card against the CPU: loss terms and gradients;
 10. multiHMR_896_L bf16 training, max_people 8, batch 2: 5 steps through
     ``Trainer.fit`` on collated synthetic samples (finite losses; 24 K1,
     24 K3 and 48 K2 launches per step), then, for both ViT streams, train
     steps with remat none, "mlp" and "block" at batch 2 (launches per step,
     step time, peak memory) and batch 1 (peak memory), and the fit of
     ``train/memory.py``'s constants to those peaks;
 11. times of the backward kernels and their plain version at
     [1, 16, 64, 4104] bf16 with kv_len 4097, and PyTorch's
     scaled_dot_product_attention backward at [1, 16, 4097, 64], with the
     least time the card could take for each kernel's work on the 4,097
     true tokens;
 12. K5 (standard-layout flash-attention forward) against its plain version
     at the ViT's lengths, bf16 and fp32, batch 1 and 2, on strided views of
     one [B, N, 3 * 16 * 64] projection, into the merged [B, N, H, 64] and
     the [B, H, 64, N] output layouts; deliberately broken copies of K5 (4),
     K1 (2) and K3 (2), each built from its kernel's source with one textual
     change in a temporary directory, which phase 12's, phase 3's and phase
     8's limits must fail; then K5, K1 and the SDPA forward timed at
     [1, 16, 4097, 64] bf16, with K5's bound;
 13. the standard stream (``tp_mode="ring"``): multiHMR_672_S fp32 card
     against CPU (inference at LayerScale 0.5 as in phase 5, and one batch-2
     train step cut to 4 blocks), then multiHMR_896_L bf16 at
     LayerScale 0.5, ring against heads and each against the fp32 stream, on
     the same weights (patch tokens), the ring path's finite meshes with 24
     K5 and no K1 or K2 per image, and both streams' batch-1 forward times;
 14. the training CLI at full width and depth in a temporary directory
     holding seeded BEDLAM (1280x720) and EHF (1600x1200) trees: 896_L,
     ``--tp_mode ring``, batch 2, 4 steps, then evaluation of 2 BEDLAM and 2
     EHF images (finite losses, K5/K3 launches per step as the remat policy
     ``--remat auto`` chose implies and no K1 or K2, 24 K5 per eval image, a
     checkpoint, finite PVE on both valsets); ``--eval_only 1 --pretrained``
     of that checkpoint on EHF GT rewritten as its own predictions (24 K5 per
     image, recall 100, PA-PVE under 1 mm); then 2 steps with
     ``--tp_mode heads`` (24 K1, 24 K3, 48 K2 per step).

Then a JSON line of the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before those.
Exits non-zero at once without a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# flash forward (K1, K5) against its plain version, computed in fp32 from the
# same inputs and rounded to the kernel's dtype. fp32 out: 1e-5 abs (sums in
# another order). bf16 out, elementwise:
#   |out - ref| <= 2^-7 |ref| + 2^-5 rms(ref)
# Both sides round out to bf16, so they may differ by one ulp (at most 2^-7
# of the value); and the kernel rounds P to bf16 (2^-8 relative) before P.V,
# a random error of std ~2^-10 of the outputs' scale per element, whose
# maximum over millions of elements the 2^-5 rms(ref) floor covers ~4x.
# lse (fp32 statistics on both sides, in both dtypes): 5e-5 abs.
FWD_TOL_FP32 = 1e-5
BF16_ULP = 2 ** -7
BF16_FLOOR_RMS = 2 ** -5
LSE_TOL = 5e-5
K2_TOL_FP32 = 1e-5  # abs, fp32 output
K2_TOL_BF16_REL = 2 ** -8  # relative, bf16 output: half an ulp + fp32 noise
E2E_TOL = 1e-3  # 672_S card vs CPU, relative to each output's largest magnitude
# flash backward vs the plain fp32 backward, max error relative to each
# gradient's largest magnitude: fp32 sums in other orders (dq's by atomics);
# bf16 p and ds rounded before their products, outputs rounded to bf16
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# 672_S fp32 train step, card vs CPU: loss terms and each parameter's
# gradient, relative to the largest magnitude
TRAIN_TOL = 1e-3
# 896_L bf16 on the same weights: relative L2 error of the final-norm patch
# tokens, ring against heads and each stream against the fp32 heads stream
# (the control). bf16 rounds at other places on the two streams (F.linear
# against baddbmm epilogues, K5 against K1, fp32 F.layer_norm against K2)
# over 24 blocks
STREAM_TOL = 2e-2
# ring no further from the fp32 control than heads is, by more than this
STREAM_RATIO = 1.1
# LayerScale init of the models whose outputs phases 5 and 13 compare:
# DINOv2's 1e-5 scales every block's branches down to about 1e-5 of the
# stream, so a check of the outputs would not see the blocks (nor their
# kernels); at 0.5 each block moves the stream by its own size. The train
# steps of phases 9 and 13 keep 1e-5: their gradient checks, each relative
# to its parameter's own largest gradient, see every block at any scale
LAYERSCALE = 0.5
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, reps: int = 5, warmup: int = 3) -> float:
    """Milliseconds per ``fn()``: CUDA events around ``iters`` back-to-back
    calls (so host launch overhead hides behind queued device work), the
    median of ``reps`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of its operations over
    the bf16 tensor-core peak and its bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qkv_views(n, dtype, heads=16, seed=0, kv_len=None, batch=1):
    """q, k, v as the ViT makes them: strided [B, H, 64, N] views of one
    [B, 3*H*64, N] projection output; junk past kv_len."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((batch, 3 * heads * 64, n), device="cuda", generator=g).to(dtype)
    if kv_len is not None:
        qkv[..., kv_len:] = 30.0
    return qkv.reshape(batch, 3, heads, 64, n).unbind(1)


def case_name(n, dt, kv_len, batch):
    return (f"[{batch},16,64,{n}] {str(dt)[6:]}" + (f" kv_len={kv_len}" if kv_len else ""))


# (N, dtype, kv_len, batch): the ViT's three token counts, in bf16 on its
# stream pre-padded to a multiple of 8 (junk past kv_len) and in fp32 (any
# stride) at the true odd lengths; the training path's batch 2 at 896_L
CASES = ([(n_pad, torch.bfloat16, n, 1) for n_pad, n in ((2312, 2305), (4104, 4097), (8472, 8465))]
         + [(n, torch.float32, None, 1) for n in (2305, 4097, 8465)]
         + [(4104, torch.bfloat16, 4097, 2), (4097, torch.float32, None, 2)])
K1_MAIN = [(4104, torch.bfloat16, 4097, b) for b in (1, 2)]  # the 896_L shapes


def fwd_check(out, ref_out, lse, ref_lse):
    """One flash forward against its plain version: (ok, max abs out error,
    text without the verdict). bf16: the text gives what the error needs beyond one ulp of
    |ref| against the floor 2^-5 rms(ref)."""
    r = ref_out.float()
    d = (out.float() - r).abs()
    e_out, e_lse = d.max().item(), (lse - ref_lse).abs().max().item()
    if out.dtype == torch.float32:
        ok, tol = e_out <= FWD_TOL_FP32, f"tol {FWD_TOL_FP32:g}"
    else:
        beyond = (d - BF16_ULP * r.abs()).max().item()
        floor = BF16_FLOOR_RMS * r.square().mean().sqrt().item()
        ok, tol = beyond <= floor, (f"beyond 2^-7|ref| {beyond:.3e}, tol 2^-7|ref| + "
                                    f"2^-5 rms(ref) = {floor:.3e}")
    ok = ok and e_lse <= LSE_TOL
    return ok, e_out, f"out err {e_out:.3e} ({tol}), lse err {e_lse:.3e} (tol {LSE_TOL:g})"


def check_k1(attention):
    errs = {}
    for n, dt, kv_len, batch in CASES:
        q, k, v = qkv_views(n, dt, kv_len=kv_len, batch=batch)
        out, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=kv_len)
        ref_out, ref_lse = attention.mha_reference_t(q, k, v, kv_len=kv_len)
        lim = n if kv_len is None else kv_len
        ok, e_out, text = fwd_check(out[..., :lim], ref_out[..., :lim], lse[..., :lim],
                                    ref_lse[..., :lim])
        name = case_name(n, dt, kv_len, batch)
        log(3, f"K1 {name}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        errs[(n, dt, kv_len, batch)] = e_out
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return max(errs[c] for c in K1_MAIN)


def check_k2(norm):
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, 1024, 4097), device="cuda", generator=g) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(1024, device="cuda", generator=g)
    bias = 0.1 * torch.randn(1024, device="cuda", generator=g)
    worst = 0.0
    for in_dt, out_dt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                          (torch.float32, torch.float32)):
        xi = x.to(in_dt)
        y = norm.layernorm_cm(xi, scale, bias, 1e-6, out_dt)
        ref = norm.layernorm_cm_reference(xi, scale, bias, 1e-6, torch.float32)
        err = (y.float() - ref).abs()
        if out_dt == torch.float32:
            ok = err.max().item() <= K2_TOL_FP32
            tol = f"tol {K2_TOL_FP32:g}"
        else:
            ok = bool((err <= ref.abs() * K2_TOL_BF16_REL + 1e-6).all())
            tol = f"tol {K2_TOL_BF16_REL:g} x |y|"
        log(4, f"K2 [1,1024,4097] {str(in_dt)[6:]}->{str(out_dt)[6:]}: max err "
               f"{err.max().item():.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K2 disagrees with its plain version")
        if in_dt == out_dt == torch.bfloat16:
            worst = err.max().item()
    return worst


def synthetic_image(seed, h, w):
    """A seeded uint8 RGB image with smooth structure (not just noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(xx / (17 + 5 * c) + c) * np.cos(yy / (23 + 3 * c)) for c in range(3)], -1)
    img = 127.5 * (base + 1) + rng.normal(scale=12, size=(h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def rel_err(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / max(a.abs().max().item(), 1.0)).item()


# forward launches (K1, K2, K5) of one 672_S image (12 blocks) per stream
E2E_LAUNCHES = {"heads": (12, 24, 0), "ring": (0, 0, 12)}


def check_e2e(build_model, named_config, demo, cuda_lib, attention, norm, phase=5,
              tp_mode="heads"):
    base = named_config("multiHMR_672_S")
    cfg = dataclasses.replace(base, compute_dtype="float32", vit_override=dataclasses.replace(
        base.vit, layerscale_init=LAYERSCALE))
    img = synthetic_image(7, 480, 640)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model("multiHMR_672_S", device=dev, seed=0, cfg=cfg, tp_mode=tp_mode)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        outs[dev] = demo.predict(model, img)
        torch.cuda.synchronize()
        counts = tuple(cuda_lib.LAUNCHES[k] for k in (attention.KERNEL, norm.KERNEL,
                                                      attention.KERNEL_STD))
        log(phase, f"672_S fp32 forward ({tp_mode}) on {dev}: {time.perf_counter() - t0:.2f} s")
    a, b = outs["cpu"], outs["cuda"]
    same_det = all(torch.equal(getattr(a["det"], f), getattr(b["det"], f).cpu())
                   for f in ("rows", "cols", "valid"))
    errs = {k: rel_err(a[k], b[k]) for k in
            ("scores", "scores_det", "loc", "dist", "rotvec", "v3d", "j3d", "j2d")}
    n_a, n_b = int(a["det"].valid.sum()), int(b["det"].valid.sum())
    ok = (same_det and n_a == n_b and max(errs.values()) <= E2E_TOL
          and counts == E2E_LAUNCHES[tp_mode])
    log(phase, f"672_S ({tp_mode}) card vs CPU: detections {'equal' if same_det else 'DIFFER'}, "
               f"persons {n_b} vs {n_a}, rel errs "
               + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
               + f" (tol {E2E_TOL:g}); card launches K1/K2/K5 {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("672_S on the card disagrees with the CPU")


def run_896(build_model, demo, cast_backbone_bf16, cuda_lib, attention, norm, out_dir):
    model = build_model("multiHMR_896_L", device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    images = [synthetic_image(s, h, w) for s, (h, w) in
              enumerate([(480, 640), (800, 450), (896, 896)])]
    os.makedirs(out_dir, exist_ok=True)
    cuda_lib.reset_launches()  # the inference path's run starts here
    for i, img in enumerate(images):
        before = dict(cuda_lib.LAUNCHES)
        out, persons = demo.run_image(model, img, f"smoke{i}", out_dir, "multiHMR_896_L",
                                      save_mesh=True)
        k1 = cuda_lib.LAUNCHES[attention.KERNEL] - before.get(attention.KERNEL, 0)
        k2 = cuda_lib.LAUNCHES[norm.KERNEL] - before.get(norm.KERNEL, 0)
        v3d = out["v3d"]
        ok = (tuple(v3d.shape) == (1, 16, 10475, 3) and bool(torch.isfinite(v3d).all())
              and k1 == 24 and k2 == 48)
        log(6, f"896_L bf16 image {i} {img.shape[1]}x{img.shape[0]}: v3d {tuple(v3d.shape)} "
               f"finite={bool(torch.isfinite(v3d).all())}, {len(persons)} persons, "
               f"K1 launches {k1}, K2 launches {k2} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("896_L main path check failed")
    launches = dict(cuda_lib.LAUNCHES)  # read just after the inference path's run
    return model, launches


def time_forward(model, attention, norm, card):
    x = torch.randn((1, 896, 896, 3), device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    K = torch.tensor([[[776.0, 0, 448], [0, 776.0, 448], [0, 0, 1]]], device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.forward(x, K), iters=5)
    log(7, f"896_L bf16 forward, batch 1: {fwd_ms:.3f} ms [{card}]")
    F = torch.nn.functional
    N = 4097  # the true tokens: the bound and SDPA's work
    q, k, v = qkv_views(4104, torch.bfloat16, kv_len=N)
    B, H, Dh, _ = q.shape
    k1 = cuda_ms(lambda: attention._flash_fwd_impl_t(q, k, v, kv_len=N), iters=20)
    k1_plain = cuda_ms(lambda: attention.mha_reference_t(q, k, v, kv_len=N), iters=20)
    qs, ks, vs = (t[..., :N].transpose(-1, -2).contiguous() for t in (q, k, v))  # [B, H, N, Dh]
    k1_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), iters=20)
    k1_bound = bound_ms(4 * N * N * Dh * B * H, (4 * B * H * Dh * N) * 2 + B * H * N * 4)
    log(7, f"K1 [1,16,64,4104] kv_len 4097 bf16: kernel {k1:.4f} ms, plain {k1_plain:.4f} ms, "
           f"SDPA forward [1,16,4097,64] {k1_lib:.4f} ms, bound (4,097 tokens) "
           f"{k1_bound[0]:.4f} ms ({k1_bound[1]}) [{card}]")

    xn = torch.randn((1, 1024, 4097), device="cuda").to(torch.bfloat16)
    s, b = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
    k2 = cuda_ms(lambda: norm.layernorm_cm(xn, s, b), iters=50)
    k2_plain = cuda_ms(lambda: norm.layernorm_cm_reference(xn, s, b), iters=50)
    xt = xn.transpose(1, 2).contiguous()  # [1, 4097, 1024]
    sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
    k2_lib = cuda_ms(lambda: F.layer_norm(xt, (1024,), sb, bb, 1e-6), iters=50)
    k2_bound = bound_ms(8 * 1024 * 4097, 2 * 1024 * 4097 * 2 + 2 * 1024 * 4)
    log(7, f"K2 [1,1024,4097] bf16->bf16: kernel {k2:.4f} ms, plain {k2_plain:.4f} ms, "
           f"F.layer_norm {k2_lib:.4f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}) [{card}]")
    return {"fwd_ms": fwd_ms, "k1": (k1, k1_plain, k1_lib, *k1_bound),
            "k2": (k2, k2_plain, k2_lib, *k2_bound)}


def _grad_rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def check_bwd(attention, cuda_lib):
    """K3 and K4a + K4b against the plain backward. Returns the max abs
    errors at [B, 16, 64, 4104] bf16 with kv_len 4097, B = 1 and 2 (K3's
    dq/dk/dv, K4a's dq, K4b's dk/dv), and the launches of the two-pass path
    ``_flash_bwd_impl_t(fused=False)``, counted from 0 just before each of
    its calls."""
    errs = {"K3": 0.0, "K4a": 0.0, "K4b": 0.0}
    two_pass = {attention.KERNEL_BWD_DQ: 0, attention.KERNEL_BWD_DKV: 0}
    for n, dt, kv_len, batch in CASES:
        q, k, v = qkv_views(n, dt, seed=n, kv_len=kv_len, batch=batch)
        o, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=kv_len)
        do = torch.randn(q.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(5)).to(dt)
        ref = attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=kv_len)
        # batch 2 writes into one packed [B, 3, H, 64, N] gradient, as the
        # training path's autograd Function does
        packed = [torch.full((batch, 3) + q.shape[1:], float("nan"), dtype=dt, device="cuda")
                  for _ in range(2)] if batch > 1 else [None, None]
        out = lambda i: None if packed[i] is None else packed[i].unbind(1)  # noqa: E731
        fused = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=True,
                                            out=out(0))
        cuda_lib.reset_launches()  # the two-pass path's run starts here
        two = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=False,
                                          out=out(1))
        for name in two_pass:  # read just after it
            two_pass[name] += cuda_lib.LAUNCHES[name]
        torch.cuda.synchronize()
        lim = n if kv_len is None else kv_len  # the pad lanes' dq is junk on both sides
        cut = lambda ts: [t[..., :lim] for t in ts]  # noqa: E731
        e3 = [_grad_rel(a, r) for a, r in zip(cut(fused), cut(ref))]
        e4 = [_grad_rel(a, r) for a, r in zip(cut(two), cut(ref))]
        e34 = [_grad_rel(a, r) for a, r in zip(cut(fused), cut(two))]
        zeros = kv_len is None or not any(t[..., kv_len:].any() for t in fused[1:] + two[1:])
        tol = BWD_TOL[dt]
        ok = all(e <= tol for e in e3 + e4 + e34) and zeros  # NaN fails
        name = case_name(n, dt, kv_len, batch) + (", packed gradient" if batch > 1 else "")
        fmt = lambda es: "/".join(f"{e:.2e}" for e in es)  # noqa: E731
        log(8, f"{name}: rel err dq/dk/dv K3 {fmt(e3)}, K4a+K4b {fmt(e4)}, K3 vs K4 "
               f"{fmt(e34)} (tol {tol:g})" + ("" if kv_len is None else
               f", dk/dv past kv_len {'exact zeros' if zeros else 'NOT ZERO'}")
               + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash backward {name} disagrees with its plain version")
        if (n, dt, kv_len, batch) in K1_MAIN:
            abs_err = lambda a, r: (a.float() - r.float()).abs().max().item()  # noqa: E731
            errs["K3"] = max(errs["K3"], *(abs_err(a, r) for a, r in zip(fused, ref)))
            errs["K4a"] = max(errs["K4a"], abs_err(two[0], ref[0]))
            errs["K4b"] = max(errs["K4b"], *(abs_err(a, r) for a, r in zip(two[1:], ref[1:])))
        del q, k, v, o, lse, do, ref, fused, two, packed
        torch.cuda.empty_cache()
    log(8, "two-pass path launches K4a/K4b " + "/".join(str(c) for c in two_pass.values()))
    return errs, two_pass


# train-step launches (K1, K3, K2, K5) with 4 ViT blocks, per stream
TRAIN_E2E_LAUNCHES = {"heads": (4, 4, 8, 0), "ring": (0, 4, 0, 4)}


def check_train_e2e(cuda_lib, attention, norm, phase=9, tp_mode="heads"):
    """One 672_S fp32 train step at batch 2 (4 ViT blocks), card against CPU."""
    from multihmr_tpu_torch.config import VITS
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.tools.train_smoke import synthetic_batch, train_config
    from multihmr_tpu_torch.train.trainer import make_train_step, to_device

    cfg = dataclasses.replace(train_config("multiHMR_672_S", max_people=4),
                              compute_dtype="float32",
                              vit_override=dataclasses.replace(VITS, depth=4))
    batch = synthetic_batch(2, cfg.max_people, cfg.img_size, seed=1)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model("multiHMR_672_S", device=dev, seed=0, cfg=cfg, tp_mode=tp_mode)
        step = make_train_step(model, torch.optim.SGD(model.net.parameters(), lr=0.0))
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        terms = step(to_device(batch, dev), 0)
        grads = {k: p.grad.detach().cpu() for k, p in model.net.named_parameters()
                 if p.grad is not None}
        res[dev] = ({k: v.cpu() for k, v in terms.items()}, grads, dict(cuda_lib.LAUNCHES))
        log(phase, f"672_S fp32 train step ({tp_mode}) on {dev}: "
                   f"{time.perf_counter() - t0:.2f} s")
    (ta, ga, _), (tb, gb, launches) = res["cpu"], res["cuda"]
    if sorted(ga) != sorted(gb):
        raise AssertionError("the card and the CPU gave gradients to other parameters")
    e_terms = max(_grad_rel(tb[k], ta[k]) for k in ta if float(ta[k].abs()) > 0)
    e_grads = {k: _grad_rel(gb[k], ga[k]) for k in ga if float(ga[k].abs().max()) > 0}
    worst = max(e_grads, key=e_grads.get)
    counts = tuple(launches.get(k, 0) for k in (attention.KERNEL, attention.KERNEL_BWD,
                                                norm.KERNEL, attention.KERNEL_STD))
    ok = (e_terms <= TRAIN_TOL and e_grads[worst] <= TRAIN_TOL
          and counts == TRAIN_E2E_LAUNCHES[tp_mode] and float(tb["finite"]) == 1.0)
    log(phase, f"672_S fp32 train step ({tp_mode}), batch 2 (ViT cut to 4 of 12 blocks), card "
               f"vs CPU: loss total {float(tb['total']):.4f} vs {float(ta['total']):.4f}, worst "
               f"loss-term rel err {e_terms:.2e}, worst gradient rel err {e_grads[worst]:.2e} "
               f"({worst}) over {len(e_grads)} parameters (tol {TRAIN_TOL:g}); card launches "
               f"K1/K3/K2/K5 {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("672_S train step on the card disagrees with the CPU")


def train_samples(n_batches, batch, max_people, seed=0):
    """Collated batches as the BEDLAM training CLI builds them: a
    contain-resized, normalised image with its K, and per person the 53
    SMPL-X axis-angle rotations, betas and translation."""
    from multihmr_tpu_torch.data.collate import collate_padded, resize_with_K
    from multihmr_tpu_torch.io.preprocessing import normalize_nhwc

    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        samples = []
        for j in range(batch):
            h, w = [(480, 640), (720, 1280), (900, 600)][(i + j) % 3]
            K0 = np.array([[1.1 * w, 0, w / 2], [0, 1.1 * w, h / 2], [0, 0, 1]], np.float32)
            img, K = resize_with_K(synthetic_image(100 * i + j, h, w), K0, 896)
            humans = [{"pose": rng.normal(scale=0.2, size=(53, 3)).astype(np.float32),
                       "shape": rng.normal(size=(10,)).astype(np.float32),
                       "transl": np.array([rng.uniform(-1.5, 1.5), rng.uniform(-0.5, 0.5),
                                           rng.uniform(3, 8)], np.float32)}
                      for _ in range(int(rng.integers(1, max_people + 3)))]
            samples.append({"image": normalize_nhwc(img), "K": K, "humans": humans})
        yield collate_padded(samples, max_people)


# launches per train step (K1, K3, K2, K5) per ViT stream and remat policy
STEP_LAUNCHES = {
    "heads": {"none": (24, 24, 48, 0), "mlp": (24, 24, 48, 0), "block": (48, 24, 96, 0)},
    "ring": {"none": (0, 24, 0, 24), "mlp": (0, 24, 0, 24), "block": (0, 24, 0, 48)},
}


def run_train_896(cuda_lib, attention, norm):
    """The training path: 5 steps of Trainer.fit, then train steps with each
    remat policy."""
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.tools.train_smoke import run, train_config
    from multihmr_tpu_torch.train.trainer import Trainer

    names = (attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL)
    cfg = train_config("multiHMR_896_L", "none")
    model = build_model("multiHMR_896_L", device="cuda", seed=0, cfg=cfg)
    trainer = Trainer(model, torch.optim.Adam(model.net.parameters(), lr=5e-6, eps=1e-8),
                      sync_every=5, log_fn=lambda s: log(10, s))
    per_step, totals = [], []
    step = trainer.train_step

    def counted_step(batch, epoch):
        before = dict(cuda_lib.LAUNCHES)
        terms = step(batch, epoch)
        per_step.append(tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names))
        totals.append((terms["total"], terms["finite"]))
        return terms

    trainer.train_step = counted_step
    batches = list(train_samples(5, 2, cfg.max_people))
    cuda_lib.reset_launches()  # the training path's run starts here
    trainer.fit(lambda: iter(batches), epochs=1)
    launches = dict(cuda_lib.LAUNCHES)  # read just after the training path's run
    losses = [(float(t), float(f)) for t, f in totals]
    ok = (len(per_step) == 5 and all(p == (24, 24, 48) for p in per_step)
          and all(np.isfinite(t) and f == 1.0 for t, f in losses))
    log(10, f"896_L bf16 Trainer.fit, batch 2, max_people 8, remat none: losses "
           + ", ".join(f"{t:.3f}" for t, _ in losses)
           + f"; launches per step K1/K3/K2 {per_step} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("896_L training path check failed")
    del model, trainer, step, counted_step  # free the weights and Adam state
    torch.cuda.empty_cache()

    # each variant on a fresh model: batch 2 for 6 steps (steps 0-1 warm up),
    # batch 1 for 3 steps (its peak memory, for the memory fit)
    names += (attention.KERNEL_STD,)
    steps, peaks = {}, {}
    for tp_mode in ("heads", "ring"):
        for policy, counts in STEP_LAUNCHES[tp_mode].items():
            for batch, n_steps in ((2, 6), (1, 3)):
                cuda_lib.reset_launches()  # this variant's run starts here
                r = run("multiHMR_896_L", batch=batch, steps=n_steps, remat_policy=policy,
                        device="cuda", log=lambda s: None, tp_mode=tp_mode)
                got = tuple(cuda_lib.LAUNCHES[k] / n_steps for k in names)  # read just after it
                ok = got == counts and r["finite"] and all(np.isfinite(r["losses"]))
                label = f"{tp_mode} remat {policy}"
                log(10, f"896_L bf16 train step ({label}), batch {batch}: "
                        f"{r['median_ms']:.1f} ms/step (CUDA events, median of steps 2-"
                        f"{n_steps - 1}), peak memory {r['peak_gib']:.2f} GiB, losses "
                        + ", ".join(f"{x:.3f}" for x in r["losses"])
                        + f"; launches per step K1/K3/K2/K5 {got} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"896_L train step ({label}, batch {batch}) check failed")
                peaks[(tp_mode, policy, batch)] = r["peak_gib"]
                if batch == 2:
                    steps[label] = (r["median_ms"], r["peak_gib"])
                torch.cuda.empty_cache()
    memory_fit(peaks, train_config("multiHMR_896_L"))
    return launches, steps


def memory_fit(peaks, cfg):
    """Per stream and remat policy, the peak's slope between batch 1 and 2 in
    bytes per ViT token-dim, and what is left at batch 1 once the weights'
    16 bytes per parameter and the activations are taken off: the constants
    of ``train/memory.py``."""
    from multihmr_tpu_torch.train.memory import approx_param_count, token_dims

    td, weights = token_dims(cfg, 1), approx_param_count(cfg) * 16
    fit = {}
    for (tp_mode, policy, batch), peak in peaks.items():
        if batch == 1:
            p1, p2 = peak * 2 ** 30, peaks[(tp_mode, policy, 2)] * 2 ** 30
            slope = (p2 - p1) / td
            fit[(tp_mode, policy)] = (slope, p1 - slope * td - weights)
    for (tp_mode, policy), (slope, fixed) in fit.items():
        log(10, f"memory fit ({tp_mode}, remat {policy}): {slope:.2f} bytes per token-dim, "
                f"{fixed / 1e9:.3f} GB fixed (token-dims per image {td}, weights "
                f"{weights / 1e9:.3f} GB)")
    act = {p: max(fit[(t, p)][0] for t in ("heads", "ring")) for p in STEP_LAUNCHES["heads"]}
    log(10, "memory fit, larger of the two streams: _ACT_BYTES_PER_TOKEN_DIM "
            + ", ".join(f"{p} {a:.2f}" for p, a in act.items())
            + f"; _FIXED_BYTES {max(f for _, f in fit.values()) / 1e9:.3f} GB")


def time_bwd(attention, card):
    """Times at [1, 16, 64, 4104] bf16 with kv_len 4097 (the pre-padded
    896_L stream): K3, K4a, K4b and the plain backward; the SDPA backward
    (one forward graph, backward with retain_graph) on the 4,097 true
    tokens."""
    F = torch.nn.functional
    N = 4097  # the true tokens: the bounds and SDPA's work
    q, k, v = qkv_views(4104, torch.bfloat16, seed=11, kv_len=N)
    B, H, Dh, _ = q.shape
    o, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=N)
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    dd = (do.float() * o.float()).sum(2)
    outs = [torch.empty_like(o) for _ in range(3)]
    scale = Dh ** -0.5

    def kern(name):
        return lambda: attention._flash_bwd_t_cuda(name, q, k, v, do, lse, dd, scale, N, *outs)

    t = {name: cuda_ms(kern(name), iters=10) for name in
         (attention.KERNEL_BWD, attention.KERNEL_BWD_DQ, attention.KERNEL_BWD_DKV)}
    whole = cuda_ms(lambda: attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=N), iters=10)
    plain = cuda_ms(lambda: attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=N),
                    iters=3)
    qs, ks, vs = (x[..., :N].transpose(-1, -2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs)
    g = do[..., :N].transpose(-1, -2).contiguous()
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), g, retain_graph=True), iters=10)
    nbytes = lambda n_tensors: n_tensors * B * H * Dh * N * 2 + B * H * N * 4  # noqa: E731
    prod = 2 * N * N * Dh * B * H  # one N x N x 64 product
    bounds = {attention.KERNEL_BWD: bound_ms(5 * prod, nbytes(8)),  # q k v o dO in, dq dk dv out
              attention.KERNEL_BWD_DQ: bound_ms(3 * prod, nbytes(6)),  # s, dp, dq
              attention.KERNEL_BWD_DKV: bound_ms(4 * prod, nbytes(7))}  # s, dp, dv, dk
    log(11, f"flash backward [1,16,64,4104] kv_len 4097 bf16 [{card}]: K3 "
            f"{t[attention.KERNEL_BWD]:.4f} ms "
            f"(whole fused backward with D and the dq cast {whole:.4f} ms), "
            f"K4a {t[attention.KERNEL_BWD_DQ]:.4f} ms + K4b {t[attention.KERNEL_BWD_DKV]:.4f} ms, "
            f"plain {plain:.4f} ms, SDPA backward [1,16,4097,64] {lib:.4f} ms; bounds "
            f"(4,097 tokens) K3/K4a/K4b "
            + "/".join(f"{b[0]:.4f}" for b in bounds.values()) + " ms (operations)")
    return {name: (t[name], plain, lib if name == attention.KERNEL_BWD else None, *bounds[name])
            for name in t}


def std_qkv_views(n, dtype, heads=16, seed=0, batch=1):
    """q, k, v as the standard-stream ViT makes them: [B, H, N, 64] views of
    one [B, N, 3*H*64] projection output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((batch, n, 3 * heads * 64), device="cuda", generator=g).to(dtype)
    return qkv.reshape(batch, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)


# K5's output layouts: the merged [B, N, H, 64] buffer the ViT reads, and the
# JAX kernel's [B, H, 64, N]
K5_LAYOUTS = {
    "[B,N,H,64]": lambda B, H, N, dt: torch.empty((B, N, H, 64), dtype=dt,
                                                  device="cuda").transpose(1, 2),
    "[B,H,64,N]": lambda B, H, N, dt: torch.empty((B, H, 64, N), dtype=dt,
                                                  device="cuda").transpose(2, 3),
}


def check_k5(attention):
    """K5 against its plain version; returns the max abs out error at
    [B, 16, 4097, 64] bf16, B = 1 and 2."""
    worst = 0.0
    for n in (2305, 4097, 8465):
        for dt in (torch.bfloat16, torch.float32):
            for batch in (1, 2):
                q, k, v = std_qkv_views(n, dt, seed=n, batch=batch)
                ref = [attention.flash_fwd_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1])
                       for b in range(batch)]  # one image at a time: [16, N, N] fp32 each
                ref_out, ref_lse = (torch.cat(parts) for parts in zip(*ref))
                del ref
                for layout, make in K5_LAYOUTS.items():
                    out, lse = attention._flash_fwd_std(q, k, v, out=make(batch, 16, n, dt))
                    ok, e_out, text = fwd_check(out, ref_out, lse, ref_lse)
                    name = f"[{batch},16,{n},64] {str(dt)[6:]} into {layout}"
                    log(12, f"K5 {name}: {text} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"K5 {name} disagrees with its plain version")
                    if (n, dt) == (4097, torch.bfloat16):
                        worst = max(worst, e_out)
                    del out, lse
                del q, k, v, ref_out, ref_lse
                torch.cuda.empty_cache()
    return worst


# deliberately broken copies of the bf16 flash kernels, one textual change
# each to the kernel's source: the limit that holds the sound kernel to its
# plain version (phase 12's for K5, phase 3's for K1, phase 8's for K3) must
# fail every one. The earlier 2e-2 abs limit passes K5's last, whose error
# is 1/64 of |out| (|out| < 0.3 on these inputs)
_PV_MMA = "mma_bf16(o[2 * dp + 1], a, b[2], b[3]);"
K5_MUTANTS = {
    "P.V k-step 3 reads the neighbouring v sub-tile": [
        ("8 * (2 * dp + mi / 2)]);", "8 * (2 * (kk == 3 ? dp ^ 1 : dp) + mi / 2)]);")],
    "channels 56-63 of keys 48-63 of every kv tile dropped": [
        (_PV_MMA, "if (kk != 3 || dp != 3) " + _PV_MMA)],
    "channels 56-63 of keys 48-63 of the first kv tile dropped": [
        (_PV_MMA, "if (j != 0 || kk != 3 || dp != 3) " + _PV_MMA)],
    "output normalised by a row sum 1/64 too large": [
        ("inv[r] = 1.f / l;", "inv[r] = 1.f / (l * 1.015625f);")],
}
_K1_PV = "wgmma_m64n64k16<0>(o, pf[kk], wgmma_desc(sV + 16 * kk, 0, 1024), 1);"
K1_MUTANTS = {
    "P.V k-step 3 (keys 48-63) of every kv tile dropped": [(_K1_PV, "if (kk != 3) " + _K1_PV)],
    "P.V k-step 3 (keys 48-63) of the first kv tile dropped": [
        (_K1_PV, "if (j != 0 || kk != 3) " + _K1_PV)],
}
_K3_DQ = "wDQ[ch * kLdDQ + 16 * (warp % 4) + g + 8 * (i / 2)] = dqa[j][i] * scale;"
K3_MUTANTS = {
    "dq channels 24-31 and 56-63 dropped from the partial of every query tile": [
        (_K3_DQ, _K3_DQ.replace("= dqa[j][i] * scale;", "= j == 3 ? 0.f : dqa[j][i] * scale;"))],
    "dq channels 24-31 and 56-63 dropped from the partial of the first query tile": [
        (_K3_DQ, _K3_DQ.replace("= dqa[j][i] * scale;",
                                "= t == 0 && j == 3 ? 0.f : dqa[j][i] * scale;"))],
}


def check_mutants(attention, cuda_lib):
    """Build the mutants of K5, K1 and K3 (cuda_lib.build_variants: one nvcc
    each, all started together), run each through its kernel's wrapper at the 896_L shape
    ([1, 16, 4097, 64] for K5; [1, 16, 64, 4104] with kv_len 4097 for K1
    and K3) and hold it to its sound kernel's limit, which must fail.
    Returns {kernel: {mutant: max abs error}}."""
    import tempfile

    counted = (attention.KERNEL_STD, attention.KERNEL, attention.KERNEL_BWD)
    launches = {k: cuda_lib.LAUNCHES[k] for k in counted}
    readings = {"K5": {}, "K1": {}, "K3": {}}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"K5": cuda_lib.build_variants("flash_fwd_std.cu", K5_MUTANTS, tmp),
                  "K1": cuda_lib.build_variants("flash_fwd.cu", K1_MUTANTS, tmp),
                  "K3": cuda_lib.build_variants("flash_bwd.cu", K3_MUTANTS, tmp)}
        q, k, v = std_qkv_views(4097, torch.bfloat16, seed=4097)
        ref_out, ref_lse = attention.flash_fwd_reference(q, k, v)
        for name, build in builds["K5"].items():
            with cuda_lib.use_variant(name, build, "mhmr_flash_fwd_std"):
                out, lse = attention._flash_fwd_std(q, k, v)
            passed, e_out, text = fwd_check(out, ref_out, lse, ref_lse)
            log(12, f"K5 mutant ({name}) [1,16,4097,64] bf16: {text}; the old "
                    f"2e-2 abs limit {'passes' if e_out <= 2e-2 else 'fails'} it; phase 12's "
                    f"limit {'PASSES IT: FAIL' if passed else 'fails it: ok'}")
            if passed:
                raise AssertionError(f"phase 12's limit passes the broken K5 ({name})")
            readings["K5"][name] = e_out
        n = 4097
        q, k, v = qkv_views(4104, torch.bfloat16, seed=n, kv_len=n)
        ref_out, ref_lse = attention.mha_reference_t(q, k, v, kv_len=n)
        for name, build in builds["K1"].items():
            with cuda_lib.use_variant(name, build, "mhmr_flash_fwd_t"):
                out, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=n)
            passed, e_out, text = fwd_check(out[..., :n], ref_out[..., :n], lse[..., :n],
                                            ref_lse[..., :n])
            log(12, f"K1 mutant ({name}) [1,16,64,4104] kv_len 4097 bf16: {text}; phase 3's "
                    f"limit {'PASSES IT: FAIL' if passed else 'fails it: ok'}")
            if passed:
                raise AssertionError(f"phase 3's limit passes the broken K1 ({name})")
            readings["K1"][name] = e_out
        o, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=n)
        do = torch.randn(q.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(5)).to(torch.bfloat16)
        ref = attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=n)
        for name, build in builds["K3"].items():
            with cuda_lib.use_variant(name, build, "mhmr_flash_bwd_t"):
                grads = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=n)
            errs = [_grad_rel(a[..., :n], r[..., :n]) for a, r in zip(grads, ref)]
            passed = max(errs) <= BWD_TOL[torch.bfloat16]
            log(12, f"K3 mutant ({name}) [1,16,64,4104] kv_len 4097 bf16: rel err dq/dk/dv "
                    + "/".join(f"{e:.2e}" for e in errs) + f" (tol {BWD_TOL[torch.bfloat16]:g}); "
                    f"phase 8's limit {'PASSES IT: FAIL' if passed else 'fails it: ok'}")
            if passed:
                raise AssertionError(f"phase 8's limit passes the broken K3 ({name})")
            readings["K3"][name] = max((a[..., :n].float() - r[..., :n].float()).abs().max().item()
                                       for a, r in zip(grads, ref))
    for kern in counted:  # the mutants' launches do not count
        cuda_lib.LAUNCHES[kern] = launches[kern]
    return readings


def time_k5(attention, card):
    """K5, its plain version, the SDPA forward (on the same views) and K1
    (on the channels-major views) at the 896_L shape, bf16."""
    F = torch.nn.functional
    q, k, v = std_qkv_views(4097, torch.bfloat16)
    B, H, N, Dh = q.shape
    k5 = cuda_ms(lambda: attention._flash_fwd_std(q, k, v), iters=20)
    plain = cuda_ms(lambda: attention.flash_fwd_reference(q, k, v), iters=20)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=20)
    qt, kt, vt = qkv_views(4104, torch.bfloat16, kv_len=N)
    k1 = cuda_ms(lambda: attention._flash_fwd_impl_t(qt, kt, vt, kv_len=N), iters=20)
    bound = bound_ms(4 * N * N * Dh * B * H, 4 * B * H * N * Dh * 2 + B * H * N * 4)
    log(12, f"K5 [1,16,4097,64] bf16 (strided views of the projection): kernel {k5:.4f} ms, "
            f"plain {plain:.4f} ms, SDPA forward on the same views {lib:.4f} ms, "
            f"K1 [1,16,64,4104] kv_len 4097 {k1:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) "
            f"[{card}]")
    return (k5, plain, lib, *bound)


def check_streams_896(build_model, named_config, demo, cast_backbone_bf16, cuda_lib, attention,
                      norm, card):
    """896_L bf16 with LayerScale LAYERSCALE, ring against heads on the card
    with the same weights, and each against the fp32 heads stream: patch
    tokens; then the ring path's launches and finite meshes per image, and
    both streams' batch-1 forward times (turns heads, ring, ring, heads)."""
    from multihmr_tpu_torch.io.preprocessing import preprocess_array

    base = named_config("multiHMR_896_L")
    cfg = dataclasses.replace(base, vit_override=dataclasses.replace(
        base.vit, layerscale_init=LAYERSCALE))
    pre = preprocess_array(synthetic_image(0, 480, 640), 896)
    x, K = (torch.from_numpy(a)[None].cuda() for a in (pre.x, pre.K))
    control = build_model(device="cuda", seed=0, cfg=dataclasses.replace(
        cfg, compute_dtype="float32"), tp_mode="heads")
    with torch.inference_mode():
        tok = {"fp32": control.net.backbone(x)["patch_tokens"].float()}
    del control
    models = {}
    for tp_mode in ("heads", "ring"):
        models[tp_mode] = build_model(device="cuda", seed=0, cfg=cfg, tp_mode=tp_mode)
        cast_backbone_bf16(models[tp_mode].net)
        with torch.inference_mode():
            tok[tp_mode] = models[tp_mode].net.backbone(x)["patch_tokens"].float()
    rel = lambda a, b: ((tok[a] - tok[b]).norm() / tok[b].norm()).item()  # noqa: E731
    errs = {"ring vs heads": rel("ring", "heads"), "ring vs fp32": rel("ring", "fp32"),
            "heads vs fp32": rel("heads", "fp32")}
    ok = (max(errs.values()) <= STREAM_TOL
          and errs["ring vs fp32"] <= STREAM_RATIO * errs["heads vs fp32"])
    log(13, f"896_L bf16 patch tokens (LayerScale {LAYERSCALE:g}), rel L2 err "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {STREAM_TOL:g}, and ring vs fp32 <= {STREAM_RATIO:g} x heads vs fp32); "
            f"max abs err ring vs heads "
            f"{(tok['ring'] - tok['heads']).abs().max().item():.3e}, |fp32 tokens| max "
            f"{tok['fp32'].abs().max().item():.3e} {'ok' if ok else 'FAIL'}")
    del tok
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    for i, (h, w) in enumerate([(480, 640), (800, 450), (896, 896)]):
        before = dict(cuda_lib.LAUNCHES)
        out = demo.predict(models["ring"], synthetic_image(i, h, w))
        counts = tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names)
        finite = bool(torch.isfinite(out["v3d"]).all())
        ok_i = counts == (0, 0, 24) and finite and tuple(out["v3d"].shape) == (1, 16, 10475, 3)
        log(13, f"896_L bf16 ring image {i} {w}x{h}: v3d {tuple(out['v3d'].shape)} finite={finite}, "
                f"launches K1/K2/K5 {counts} {'ok' if ok_i else 'FAIL'}")
        ok = ok and ok_i
    if not ok:
        raise AssertionError("896_L standard-stream check failed")
    times = {"heads": [], "ring": []}
    with torch.inference_mode():
        for tp_mode in ("heads", "ring", "ring", "heads"):
            times[tp_mode].append(cuda_ms(lambda: models[tp_mode].forward(x, K), iters=5))
    fwd = {tp: float(np.mean(t)) for tp, t in times.items()}
    log(13, "896_L bf16 forward, batch 1 (turns heads, ring, ring, heads): "
            + ", ".join(f"{tp} {fwd[tp]:.3f} ms ({'/'.join(f'{t:.3f}' for t in times[tp])})"
                        for tp in fwd) + f" [{card}]")
    return fwd


def write_datasets(root, seed=0):
    """Seeded BEDLAM (training: 4 images, validation: 2; 3 people each) and
    EHF (2 images) trees in their on-disk layouts, with real-sized images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n_img in (("training", 4), ("validation", 2)):
        img_dir = root / "data" / "BEDLAM" / split / "seq0" / "png"
        npz_dir = root / "data" / "BEDLAM" / f"all_npz_12_{split}"
        img_dir.mkdir(parents=True)
        npz_dir.mkdir(parents=True)
        n_person = 3
        rows = n_img * n_person
        transl = np.stack([rng.uniform(-1.5, 1.5, rows), rng.uniform(-0.5, 0.5, rows),
                           rng.uniform(3, 8, rows)], -1)
        np.savez(npz_dir / "seq0.npz",
                 pose_cam=rng.normal(scale=0.2, size=(rows, 165)).astype(np.float32),
                 cam_int=np.tile(np.array([[1400.0, 0, 640], [0, 1400, 360], [0, 0, 1]]),
                                 (rows, 1, 1)),
                 cam_ext=np.tile(np.eye(4), (rows, 1, 1)),
                 shape=rng.normal(size=(rows, 11)).astype(np.float32),
                 imgname=np.array([f"im{i}.png" for i in range(n_img) for _ in range(n_person)]),
                 trans_cam=transl.astype(np.float32))
        for i in range(n_img):
            Image.fromarray(synthetic_image(200 + i, 720, 1280)).save(img_dir / f"im{i}.png")
    ehf = root / "data" / "EHF"
    ehf.mkdir(parents=True)
    verts = rng.normal(scale=0.3, size=(10475, 3))  # SMPL-X vertex count
    for i in range(2):
        write_ply(ehf / f"{i:02d}_align.ply", verts)
        Image.fromarray(synthetic_image(300 + i, 1200, 1600)).save(ehf / f"{i:02d}_img.png")


def write_ply(path, verts):
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n").encode()
    path.write_bytes(header + np.asarray(verts, "<f4").tobytes())


def self_consistent_ehf(ckpt, tp_mode):
    """Rewrite the EHF tree's GT meshes as the checkpoint's own first
    person on each image (through the EHF camera, back into its world
    frame): evaluating that checkpoint must then match every GT person."""
    from pathlib import Path

    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.data import ehf as ehf_mod
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.checkpoint import load_checkpoint

    cfg = ModelConfig(backbone="dinov2_vitl14", img_size=896, max_people=8)  # the CLI's
    model = build_model(device="cuda", cfg=cfg, tp_mode=tp_mode)
    model.net.load_state_dict(load_checkpoint(ckpt)[0])
    R = ehf_mod._rotvec_to_rotmat_np(ehf_mod.EHF_CAM_ROTVEC)
    ds = ehf_mod.EHF(img_size=896)
    for i in range(len(ds)):
        x, annot = ds[i]
        with torch.inference_mode():
            out = model.forward(torch.from_numpy(x[None]).cuda(),
                                torch.from_numpy(annot["K"][None]).cuda(), det_thresh=0.2)
        v_cam = model.extract_persons(out, fields=["v3d"])[0][0]["v3d"].astype(np.float64)
        write_ply(Path("data/EHF") / annot["imagename"].replace("img.png", "align.ply"),
                  (v_cam - ehf_mod.EHF_CAM_T) @ R)  # inverse of v @ R.T + T
    os.remove(os.path.join("data", "ehf_test.pkl"))  # the dataset rebuilds its annotations


def run_cli(cuda_lib, attention, norm):
    """The training CLI at full width and depth: a ring run (4 steps, eval
    of 2 BEDLAM + 2 EHF images) and a heads run (2 steps, eval of 1 EHF
    image), each counted from 0 just before it, and between them an
    ``--eval_only --pretrained`` run of the ring checkpoint on EHF GT made
    from its own predictions. Returns the ring training run's launches."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from multihmr_tpu_torch.cli import train as train_cli
    from multihmr_tpu_torch.train import trainer as trainer_mod

    names = (attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL, attention.KERNEL_STD)
    per_step, losses = [], []
    make = trainer_mod.make_train_step

    def counting_make(*args, **kwargs):  # Trainer builds its step through this
        step = make(*args, **kwargs)

        def counted(batch, epoch):
            before = dict(cuda_lib.LAUNCHES)
            terms = step(batch, epoch)
            per_step.append(tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names))
            losses.append((float(terms["total"]), float(terms["finite"])))
            return terms
        return counted

    def cli(argv):
        per_step.clear()
        losses.clear()
        buf = io.StringIO()
        cuda_lib.reset_launches()  # this run starts here
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                train_cli.main(argv)
        finally:
            for line in buf.getvalue().splitlines():
                log(14, "  " + line)
        launches = {k: cuda_lib.LAUNCHES[k] for k in names}  # read just after it
        policy = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("remat auto"))
        policy = "none" if policy.endswith("no remat") else policy.rsplit("remat=", 1)[1]
        return launches, policy, time.perf_counter() - t0

    def eval_metrics(name):
        recs = [json.loads(ln) for ln in open(os.path.join("logs", name, "metrics.jsonl"))]
        return {r["tag"]: r["value"] for r in recs}

    common = ["--backbone", "dinov2_vitl14", "--img_size", "896", "--n_devices", "1",
              "--batch_size", "2", "--max_people", "8", "--n_epoch", "1", "--nb_max_ckpt", "1"]
    cwd = os.getcwd()
    trainer_mod.make_train_step = counting_make
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            write_datasets(Path(tmp))
            argv = common + ["--tp_mode", "ring", "--iter_per_epoch", "4", "--valset", "bedlam",
                             "ehf", "--val_n", "2", "2", "--name", "ring"]
            log(14, "cli.train " + " ".join(argv))
            launches, policy, secs = cli(argv)
            want = STEP_LAUNCHES["ring"][policy]
            in_steps = [sum(c[i] for c in per_step) for i in range(len(names))]
            in_eval = [launches[k] - n for k, n in zip(names, in_steps)]
            metrics = eval_metrics("ring")
            pves = {v: metrics.get(f"{v}/pve") for v in ("bedlam-validation-1", "ehf-test-1")}
            ok = (len(per_step) == 4 and all(c == want for c in per_step)
                  and all(np.isfinite(t) and f == 1.0 for t, f in losses)
                  and in_eval == [0, 0, 0, 24 * 4]
                  and os.path.isfile(os.path.join("ckpts", "ring", "ckpt_000000.pt"))
                  and all(p is not None and np.isfinite(p) for p in pves.values()))
            log(14, f"ring CLI run ({secs:.1f} s): remat auto chose {policy}; losses "
                    + ", ".join(f"{t:.3f}" for t, _ in losses)
                    + f"; launches per step K1/K3/K2/K5 {per_step} (want {want}); in the eval "
                    f"of 4 images K1/K3/K2/K5 {in_eval} (want 0/0/0/96); checkpoint "
                    f"{os.listdir(os.path.join('ckpts', 'ring'))}; pve {pves} "
                    f"{'ok' if ok else 'FAIL'}")
            ring_launches = launches
            # --eval_only --pretrained on the checkpoint just written, with
            # the EHF GT made from its own predictions: recall 100, PA-PVE ~0
            self_consistent_ehf(os.path.join("ckpts", "ring", "ckpt_000000.pt"), "ring")
            argv = common + ["--tp_mode", "ring", "--eval_only", "1", "--pretrained",
                             os.path.join("ckpts", "ring", "ckpt_000000.pt"), "--valset", "ehf",
                             "--name", "ring_self"]
            log(14, "cli.train " + " ".join(argv))
            launches, _, secs = cli(argv)
            metrics = eval_metrics("ring_self")
            ok_s = (launches[attention.KERNEL_STD] == 48 and metrics["ehf-test-1/recall"] == 100.0
                    and metrics["ehf-test-1/pa_pve"] < 1.0 and np.isfinite(metrics["ehf-test-1/pve"]))
            log(14, f"ring CLI eval of its own checkpoint on self-consistent EHF GT ({secs:.1f} s): "
                    + ", ".join(f"{k.split('/')[1]} {v:.4g}" for k, v in metrics.items())
                    + f"; K5 launches {launches[attention.KERNEL_STD]} (want 48) "
                    f"{'ok' if ok_s else 'FAIL'}")
            argv = common + ["--tp_mode", "heads", "--iter_per_epoch", "2", "--valset", "ehf",
                             "--val_n", "1", "--name", "heads"]
            log(14, "cli.train " + " ".join(argv))
            launches, policy, secs = cli(argv)
            want = STEP_LAUNCHES["heads"][policy]
            ok_h = (len(per_step) == 2 and all(c == want for c in per_step)
                    and all(np.isfinite(t) and f == 1.0 for t, f in losses))
            log(14, f"heads CLI run ({secs:.1f} s): remat auto chose {policy}; losses "
                    + ", ".join(f"{t:.3f}" for t, _ in losses)
                    + f"; launches per step K1/K3/K2/K5 {per_step} (want {want}); whole run "
                    f"{launches} {'ok' if ok_h else 'FAIL'}")
    finally:
        os.chdir(cwd)
        trainer_mod.make_train_step = make
    if not (ok and ok_s and ok_h):
        raise AssertionError("training CLI check failed")
    return ring_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    card = nvidia_smi_line()
    log(1, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} device(s)")

    # the port itself; in a directory without it, this import fails
    from multihmr_tpu_torch.cli import demo
    from multihmr_tpu_torch.config import named_config
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.ops import attention, cuda_lib, norm
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    so, seconds = cuda_lib.build()
    cuda_lib.library()
    log(2, f"kernels built in {seconds:.1f} s ({so.name}); TF32 off for matmul and cuDNN")

    failed = []

    def phase(n, fn, *args):
        try:
            return fn(*args)
        except Exception:  # report every phase, then fail
            failed.append(n)
            log(n, "FAIL\n" + traceback.format_exc())
            return None

    k1_err = phase(3, check_k1, attention)
    k2_err = phase(4, check_k2, norm)
    phase(5, check_e2e, build_model, named_config, demo, cuda_lib, attention, norm)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "chip_smoke")
    res = phase(6, run_896, build_model, demo, cast_backbone_bf16, cuda_lib, attention,
                norm, out_dir)
    fwd = phase(7, time_forward, res[0], attention, norm, card) if res else None
    del res
    torch.cuda.empty_cache()
    bwd_check = phase(8, check_bwd, attention, cuda_lib)
    phase(9, check_train_e2e, cuda_lib, attention, norm)
    train = phase(10, run_train_896, cuda_lib, attention, norm)
    bwd = phase(11, time_bwd, attention, card)
    k5_err = phase(12, check_k5, attention)
    mutants = phase(12, check_mutants, attention, cuda_lib)
    k5_times = phase(12, time_k5, attention, card)
    phase(13, check_e2e, build_model, named_config, demo, cuda_lib, attention, norm, 13, "ring")
    phase(13, check_train_e2e, cuda_lib, attention, norm, 13, "ring")
    fwd_streams = phase(13, check_streams_896, build_model, named_config, demo,
                        cast_backbone_bf16, cuda_lib, attention, norm, card)
    torch.cuda.empty_cache()
    cli_launches = phase(14, run_cli, cuda_lib, attention, norm)
    if failed or None in (fwd, bwd_check, train, bwd, k5_err, mutants, k5_times, fwd_streams,
                          cli_launches):
        log("end", f"failed phases: {failed}")
        return 1
    launches, steps = train
    bwd_err, two_pass = bwd_check
    launches.update(two_pass)  # K4a/K4b: the two-pass path of phase 8
    launches[attention.KERNEL_STD] = cli_launches[attention.KERNEL_STD]  # K5: phase 14's ring run
    for label, (ms, peak) in steps.items():
        log("end", f"896_L bf16 train step, batch 2, {label}: {ms:.1f} ms, peak memory "
                   f"{peak:.2f} GiB [{card}]")
    log("end", f"896_L bf16 forward, batch 1: heads {fwd['fwd_ms']:.3f} ms (phase 7); "
               f"heads {fwd_streams['heads']:.3f} ms, ring {fwd_streams['ring']:.3f} ms "
               f"(phase 13) [{card}]")

    def entry(name, source, replaces, err, times):
        ms, plain_ms, library_ms, b_ms, b_by = times
        return {"name": name, "route": "cuda", "source": f"multihmr_tpu_torch/csrc/{source}",
                "replaces": f"multihmr_tpu/ops/{replaces}",
                "launches": launches.get(name, 0), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms}

    kernels = [
        entry(attention.KERNEL, "flash_fwd.cu", "attention.py:399", k1_err, fwd["k1"]),
        entry(norm.KERNEL, "layernorm_cm.cu", "norm.py:26", k2_err, fwd["k2"]),
        entry(attention.KERNEL_BWD, "flash_bwd.cu", "attention.py:738", bwd_err["K3"],
              bwd[attention.KERNEL_BWD]),
        entry(attention.KERNEL_BWD_DQ, "flash_bwd.cu", "attention.py:627", bwd_err["K4a"],
              bwd[attention.KERNEL_BWD_DQ]),
        entry(attention.KERNEL_BWD_DKV, "flash_bwd.cu", "attention.py:682", bwd_err["K4b"],
              bwd[attention.KERNEL_BWD_DKV]),
        entry(attention.KERNEL_STD, "flash_fwd_std.cu", "attention.py:49", k5_err, k5_times),
    ]
    if any(kern["launches"] == 0 for kern in kernels):
        log("end", "a kernel was never launched by the path that runs it")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
