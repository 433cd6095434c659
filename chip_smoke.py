"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``multihmr_tpu_torch/csrc`` and drives
the port's two paths with seeded random weights and the synthetic
SMPL-X-sized body model: single-image ``multiHMR_896_L`` inference through
the demo's per-image entry point, and ``multiHMR_896_L`` training through
``Trainer.fit``. Phases, one line each:

  1. the card, its name and power limit (nvidia-smi);
  2. the kernel build;
  3. K1 (flash-attention forward) against its plain version at the ViT's
     lengths, bf16 and fp32, with keys masked past kv_len, and at batch 2
     (the training path's shape);
  4. K2 (channels-major LayerNorm) against its plain version;
  5. multiHMR_672_S in fp32: the card (kernels) against the CPU (plain
     versions), same weights and image;
  6. multiHMR_896_L in bf16 on three images: finite meshes, and 24 K1 and
     48 K2 launches per image;
  7. times (CUDA events, medians after warm-up): the 896_L forward at batch 1,
     and each forward kernel against its plain version at the 896_L shapes;
  8. K3 (fused flash backward) and K4a + K4b (two-pass, the path of
     ``_flash_bwd_impl_t(fused=False)``, whose launches are counted here)
     against the plain backward at the ViT's lengths, bf16 and fp32, with
     keys masked past kv_len, and at batch 2 writing one packed
     [B, 3, H, 64, N] gradient as the training path does; K3 against
     K4a + K4b;
  9. one multiHMR_672_S fp32 train step at batch 2 (ViT cut to 4 of its 12
     blocks), the card against the CPU: loss terms and gradients;
 10. multiHMR_896_L bf16 training, max_people 8, batch 2: 5 steps through
     ``Trainer.fit`` on collated synthetic samples (finite losses; 24 K1,
     24 K3 and 48 K2 launches per step), then train steps with remat none,
     "mlp" and "block", each with its launches per step, step time and
     peak memory;
 11. times of the backward kernels, their plain version and PyTorch's
     scaled_dot_product_attention backward at [1, 16, 64, 4097] bf16, with
     the least time the card could take for each kernel's work.

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

K1_TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 1e-3)}  # (out, lse)
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


# (N, dtype, kv_len, batch): the ViT's three lengths, a pre-padded stream
# with junk past kv_len, and the training path's batch 2 at 896_L
CASES = ([(n, dt, None, 1) for n in (2305, 4097, 8465) for dt in (torch.bfloat16, torch.float32)]
         + [(4224, torch.bfloat16, 4097, 1)]
         + [(4097, dt, None, 2) for dt in (torch.bfloat16, torch.float32)])


def check_k1(attention):
    errs = {}
    for n, dt, kv_len, batch in CASES:
        q, k, v = qkv_views(n, dt, kv_len=kv_len, batch=batch)
        out, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=kv_len)
        ref_out, ref_lse = attention.mha_reference_t(q, k, v, kv_len=kv_len)
        lim = n if kv_len is None else kv_len
        e_out = (out[..., :lim].float() - ref_out[..., :lim].float()).abs().max().item()
        e_lse = (lse[..., :lim] - ref_lse[..., :lim]).abs().max().item()
        t_out, t_lse = K1_TOL[dt]
        ok = e_out <= t_out and e_lse <= t_lse
        name = case_name(n, dt, kv_len, batch)
        log(3, f"K1 {name}: out err {e_out:.3e} (tol {t_out:g}), "
               f"lse err {e_lse:.3e} (tol {t_lse:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        errs[(n, dt, kv_len, batch)] = e_out
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return max(errs[(4097, torch.bfloat16, None, b)] for b in (1, 2))


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


def check_e2e(build_model, named_config, demo):
    cfg = dataclasses.replace(named_config("multiHMR_672_S"), compute_dtype="float32")
    img = synthetic_image(7, 480, 640)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model("multiHMR_672_S", device=dev, seed=0, cfg=cfg)
        t0 = time.perf_counter()
        outs[dev] = demo.predict(model, img)
        torch.cuda.synchronize()
        log(5, f"672_S fp32 forward on {dev}: {time.perf_counter() - t0:.2f} s")
    a, b = outs["cpu"], outs["cuda"]
    same_det = all(torch.equal(getattr(a["det"], f), getattr(b["det"], f).cpu())
                   for f in ("rows", "cols", "valid"))
    errs = {k: rel_err(a[k], b[k]) for k in
            ("scores", "scores_det", "loc", "dist", "rotvec", "v3d", "j3d", "j2d")}
    n_a, n_b = int(a["det"].valid.sum()), int(b["det"].valid.sum())
    ok = same_det and n_a == n_b and max(errs.values()) <= E2E_TOL
    log(5, f"672_S card vs CPU: detections {'equal' if same_det else 'DIFFER'}, "
           f"persons {n_b} vs {n_a}, rel errs "
           + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
           + f" (tol {E2E_TOL:g}) {'ok' if ok else 'FAIL'}")
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
    q, k, v = qkv_views(4097, torch.bfloat16)
    B, H, Dh, N = q.shape
    k1 = cuda_ms(lambda: attention._flash_fwd_impl_t(q, k, v), iters=20)
    k1_plain = cuda_ms(lambda: attention.mha_reference_t(q, k, v), iters=20)
    qs, ks, vs = (t.transpose(-1, -2).contiguous() for t in (q, k, v))  # [B, H, N, Dh]
    k1_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), iters=20)
    k1_bound = bound_ms(4 * N * N * Dh * B * H, (4 * B * H * Dh * N) * 2 + B * H * N * 4)
    log(7, f"K1 [1,16,64,4097] bf16: kernel {k1:.4f} ms, plain {k1_plain:.4f} ms, "
           f"SDPA forward {k1_lib:.4f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}) [{card}]")

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
    errors at [B, 16, 64, 4097] bf16, B = 1 and 2 (K3's dq/dk/dv, K4a's dq,
    K4b's dk/dv), and the launches of the two-pass path
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
        ok = max(e3 + e4 + e34) <= tol and zeros
        name = case_name(n, dt, kv_len, batch) + (", packed gradient" if batch > 1 else "")
        fmt = lambda es: "/".join(f"{e:.2e}" for e in es)  # noqa: E731
        log(8, f"{name}: rel err dq/dk/dv K3 {fmt(e3)}, K4a+K4b {fmt(e4)}, K3 vs K4 "
               f"{fmt(e34)} (tol {tol:g})" + ("" if kv_len is None else
               f", dk/dv past kv_len {'exact zeros' if zeros else 'NOT ZERO'}")
               + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash backward {name} disagrees with its plain version")
        if (n, dt, kv_len) == (4097, torch.bfloat16, None):
            abs_err = lambda a, r: (a.float() - r.float()).abs().max().item()  # noqa: E731
            errs["K3"] = max(errs["K3"], *(abs_err(a, r) for a, r in zip(fused, ref)))
            errs["K4a"] = max(errs["K4a"], abs_err(two[0], ref[0]))
            errs["K4b"] = max(errs["K4b"], *(abs_err(a, r) for a, r in zip(two[1:], ref[1:])))
        del q, k, v, o, lse, do, ref, fused, two, packed
        torch.cuda.empty_cache()
    log(8, "two-pass path launches K4a/K4b " + "/".join(str(c) for c in two_pass.values()))
    return errs, two_pass


def check_train_e2e(cuda_lib, attention, norm):
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
        model = build_model("multiHMR_672_S", device=dev, seed=0, cfg=cfg)
        step = make_train_step(model, torch.optim.SGD(model.net.parameters(), lr=0.0))
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        terms = step(to_device(batch, dev), 0)
        grads = {k: p.grad.detach().cpu() for k, p in model.net.named_parameters()
                 if p.grad is not None}
        res[dev] = ({k: v.cpu() for k, v in terms.items()}, grads, dict(cuda_lib.LAUNCHES))
        log(9, f"672_S fp32 train step on {dev}: {time.perf_counter() - t0:.2f} s")
    (ta, ga, _), (tb, gb, launches) = res["cpu"], res["cuda"]
    if sorted(ga) != sorted(gb):
        raise AssertionError("the card and the CPU gave gradients to other parameters")
    e_terms = max(_grad_rel(tb[k], ta[k]) for k in ta if float(ta[k].abs()) > 0)
    e_grads = {k: _grad_rel(gb[k], ga[k]) for k in ga if float(ga[k].abs().max()) > 0}
    worst = max(e_grads, key=e_grads.get)
    counts = (launches.get(attention.KERNEL, 0), launches.get(attention.KERNEL_BWD, 0),
              launches.get(norm.KERNEL, 0))
    ok = (e_terms <= TRAIN_TOL and e_grads[worst] <= TRAIN_TOL and counts == (4, 4, 8)
          and float(tb["finite"]) == 1.0)
    log(9, f"672_S fp32 train step, batch 2 (ViT cut to 4 of 12 blocks), card vs CPU: loss total "
           f"{float(tb['total']):.4f} vs {float(ta['total']):.4f}, worst loss-term rel err "
           f"{e_terms:.2e}, worst gradient rel err {e_grads[worst]:.2e} ({worst}) over "
           f"{len(e_grads)} parameters (tol {TRAIN_TOL:g}); card launches K1/K3/K2 "
           f"{counts[0]}/{counts[1]}/{counts[2]} {'ok' if ok else 'FAIL'}")
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

    # each variant: 6 steps on a fresh model (steps 0-1 warm up)
    want = {"none": (24, 24, 48), "mlp": (24, 24, 48), "block": (48, 24, 96)}
    steps = {}
    for policy, counts in want.items():
        cuda_lib.reset_launches()  # this variant's run starts here
        r = run("multiHMR_896_L", batch=2, steps=6, remat_policy=policy, device="cuda",
                log=lambda s: None)
        got = tuple(cuda_lib.LAUNCHES[k] / 6 for k in names)  # read just after it
        ok = got == counts and r["finite"] and all(np.isfinite(r["losses"]))
        label = f"remat {policy}"
        log(10, f"896_L bf16 train step, batch 2, {label}: {r['median_ms']:.1f} ms/step "
               f"(CUDA events, median of steps 2-5), peak memory {r['peak_gib']:.2f} GiB, losses "
               + ", ".join(f"{x:.3f}" for x in r["losses"])
               + f"; launches per step K1/K3/K2 {got} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"896_L train step ({label}) check failed")
        steps[label] = (r["median_ms"], r["peak_gib"])
        torch.cuda.empty_cache()
    return launches, steps


def time_bwd(attention, card):
    """Times at [1, 16, 64, 4097] bf16: K3, K4a, K4b, the plain backward and
    the SDPA backward (one forward graph, backward with retain_graph)."""
    F = torch.nn.functional
    q, k, v = qkv_views(4097, torch.bfloat16, seed=11)
    B, H, Dh, N = q.shape
    o, lse = attention._flash_fwd_impl_t(q, k, v)
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    dd = (do.float() * o.float()).sum(2)
    outs = [torch.empty_like(o) for _ in range(3)]
    scale = Dh ** -0.5

    def kern(name):
        return lambda: attention._flash_bwd_t_cuda(name, q, k, v, do, lse, dd, scale, N, *outs)

    t = {name: cuda_ms(kern(name), iters=10) for name in
         (attention.KERNEL_BWD, attention.KERNEL_BWD_DQ, attention.KERNEL_BWD_DKV)}
    whole = cuda_ms(lambda: attention._flash_bwd_impl_t(q, k, v, o, lse, do), iters=10)
    plain = cuda_ms(lambda: attention.flash_bwd_reference_t(q, k, v, o, lse, do), iters=3)
    qs, ks, vs = (x.transpose(-1, -2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs)
    g = do.transpose(-1, -2).contiguous()
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), g, retain_graph=True), iters=10)
    nbytes = lambda n_tensors: n_tensors * B * H * Dh * N * 2 + B * H * N * 4  # noqa: E731
    prod = 2 * N * N * Dh * B * H  # one N x N x 64 product
    bounds = {attention.KERNEL_BWD: bound_ms(5 * prod, nbytes(8)),  # q k v o dO in, dq dk dv out
              attention.KERNEL_BWD_DQ: bound_ms(3 * prod, nbytes(6)),  # s, dp, dq
              attention.KERNEL_BWD_DKV: bound_ms(4 * prod, nbytes(7))}  # s, dp, dv, dk
    log(11, f"flash backward [1,16,64,4097] bf16 [{card}]: K3 {t[attention.KERNEL_BWD]:.4f} ms "
            f"(whole fused backward with D and the dq cast {whole:.4f} ms), "
            f"K4a {t[attention.KERNEL_BWD_DQ]:.4f} ms + K4b {t[attention.KERNEL_BWD_DKV]:.4f} ms, "
            f"plain {plain:.4f} ms, SDPA backward {lib:.4f} ms; bounds K3/K4a/K4b "
            + "/".join(f"{b[0]:.4f}" for b in bounds.values()) + " ms (operations)")
    return {name: (t[name], plain, lib if name == attention.KERNEL_BWD else None, *bounds[name])
            for name in t}


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
    phase(5, check_e2e, build_model, named_config, demo)
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
    if failed or None in (fwd, bwd_check, train, bwd):
        log("end", f"failed phases: {failed}")
        return 1
    launches, steps = train
    bwd_err, two_pass = bwd_check
    launches.update(two_pass)  # K4a/K4b: the two-pass path of phase 8
    for label, (ms, peak) in steps.items():
        log(11, f"896_L bf16 train step, batch 2, {label}: {ms:.1f} ms, peak memory "
                f"{peak:.2f} GiB [{card}]")
    log(11, f"896_L bf16 forward, batch 1: {fwd['fwd_ms']:.3f} ms [{card}]")

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
