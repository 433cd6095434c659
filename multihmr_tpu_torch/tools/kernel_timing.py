"""Card times of the flash kernels and of the 896_L forward, for A/Bs, ablations and profiles.

    python -m multihmr_tpu_torch.tools.kernel_timing ab TREE [TREE ...]
    python -m multihmr_tpu_torch.tools.kernel_timing variants
    python -m multihmr_tpu_torch.tools.kernel_timing forward [--tp_mode heads|ring] [--ops 20]
    python -m multihmr_tpu_torch.tools.kernel_timing ptxas [NAME ...]
    python -m multihmr_tpu_torch.tools.kernel_timing s1
    python -m multihmr_tpu_torch.tools.kernel_timing rounding [--seeds 10]
    python -m multihmr_tpu_torch.tools.kernel_timing exp2

``ab``: one turn per TREE, in the order given (old new new old for an A/B):
a fresh ``python -m`` of that tree's own copy of this module, run from the
tree's root, builds that tree's kernels and runs its :func:`time_forward`
and :func:`time_bwd` (``chip_smoke.py`` phases 7 and 11: the 896_L bf16
forward at batch 1 and the forward kernels' times; the backward kernels'
times), then its :func:`kernel_ms` (K2, K5, K3, K4a and K4b on seeded
inputs, the host queued ahead). A TREE is a checkout of the port from the
change that moved these timings out of ``chip_smoke.py`` on (an older
tree's turn times through its own ``chip_smoke.py``), e.g. the parent
commit unpacked with ``git archive``.

``variants``: K1, K3, K4a, K4b, K5 and K2 at the 896_L shapes
([1, 16, 64, 4104] with kv_len 4097 for K1, K3, K4a and K4b,
[1, 16, 4097, 64] views of the packed projection for K5, [1, 1024, 4104]
for K2; bf16) against textual variants of their sources, each with one part
of the work removed or done another way (``VARIANTS``), built beside the
sound library with ``cuda_lib.build_variants``; turns sound, variant,
variant, sound for each, CUDA events with the host queued ahead. What a
variant saves is what that part costs on the kernel's critical path. K3 and
K4b are one kernel (``flash_bwd_dkv_bf16_kernel<kDq>``), so an edit of
their shared walk is timed at both modes of ``mhmr_flash_bwd_t``.

``ptxas``: build the kernels and print what ``-Xptxas -v`` said of each
entry whose mangled name holds one of the NAMEs (default: every entry):
registers, shared memory, spills, each entry under the kernel it is
(K1-K5, bf16 or fp32); and every warning of the build.

``s1``: the 672_S fp32 train step at batch 2 (ViT cut to 4 blocks, as
``chip_smoke.py`` phases 9 and 13) at LayerScale 0.5 on each stream: once
on the CPU, twice on the card, once on the card with the flash kernels and
K2 swapped for their plain versions (called on the CUDA tensors; the
dispatch in ``ops/`` is untouched), and once on the card with the image
changed by one part in 2^22. Each parameter's gradient is compared, as max
|difference| over that gradient's largest magnitude, run against run,
worst per ViT block and module.

``rounding``: bf16 K3's and K4b's dk against the plain fp32 backward and
against the plain backward with ds rounded to bf16 as the kernels (and the
TPU kernel) round it, per seed, on the card tests' inputs: [2, 4, 64, 2312]
views of one projection with junk (30.0) past kv_len 2305 and a random dO;
and where the largest error sits, split into what the true and the pad
queries add there.

``exp2``: ``csrc/common.cuh``'s ``poly_exp2`` (the exponentials K1 moves to
the FMA pipe) on the card, against ``torch.exp2`` in fp64: the largest
relative error over x = -k 2^-23 for k < 2^23 (reduced arguments on a
2^-23 grid of (0, 1], and 0) and x = -(1 - ulp), and over 2^24 points spread
over [-126, 0]; its own kernel, built beside common.cuh in a temporary
directory.

``forward``: the 896_L bf16 forward at batch 1 on one stream (seeded random
weights, a seeded random image): CUDA events around back-to-back forwards,
then ``torch.profiler`` over three: the wall and the device's busy time per
forward and the ``--ops`` kernels with the most device time.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from multihmr_tpu_torch.utils.profiling import cuda_ms, device_line, profile_steps

# (source, C entry, modes) -> {variant: [(old, new), ...]}; modes: the
# modes of mhmr_flash_bwd_t a variant is timed at (K3 0, K4a 1, K4b 2; K3 and
# K4b share their kernel's walk), None for the other entries
_K5_EXP = "fast_exp2(s[nt][2 * r]"
_K5_EXP1 = "fast_exp2(s[nt][2 * r + 1]"
_K1_EXP = "(kPolyTiles >> nt & 1) ? poly_exp2(x) : fast_exp2(x);"
_K3_EXP = "fast_exp2(fmaf(s[nt][i], scale_log2, -tLse[c] * kLog2e))"
_K4A_EXP = "fast_exp2(fmaf(s[nt][i], scale_log2, -lse2[i / 2]))"
VARIANTS = {
    ("flash_fwd.cu", "mhmr_flash_fwd_t", None): {
        "exp2f (accurate) for ex2.approx": [
            (_K1_EXP, _K1_EXP.replace("fast_exp2", "exp2f")),
            ("corr[r] = fast_exp2(m[r] - mc[r]);", "corr[r] = exp2f(m[r] - mc[r]);")],
        "no exp2": [(_K1_EXP, "x;")],
        "exp2 all on the SFU": [("constexpr uint32_t kPolyTiles = 0x0808;",
                                 "constexpr uint32_t kPolyTiles = 0;")],
        "no S = q k^T product": [("  for (int ks = 0; ks < 4; ++ks) {",
                                  "  for (int ks = 0; ks < 0; ++ks) {")],
        "no P.V product": [("    wgmma_m64n64k16<0>(o, pf[kk]",
                            "    if (0) wgmma_m64n64k16<0>(o, pf[kk]")],
        "no ping-pong between the consumer warpgroups": [
            ("  const auto my_turn = [&] { named_barrier<256>(4 + cw); };",
             "  const auto my_turn = [&] {};"),
            ("    if (!(final_turn && cw == kConsumers - 1))\n"
             "      named_barrier_arrive<256>(4 + (cw + 1) % kConsumers);\n", ""),
            ("  if (cw == kConsumers - 1) named_barrier_arrive<256>(4);", "")],
        "no k/v copies after the first kStages tiles": [
            ("        mbar_expect_tx(&full[st], 2 * atoms * kTileBytes);\n",
             "        if (j >= kStages) {\n          mbar_arrive(&full[st]);\n          continue;\n"
             "        }\n        mbar_expect_tx(&full[st], 2 * atoms * kTileBytes);\n")],
    },
    ("flash_bwd.cu", "mhmr_flash_bwd_t", (0, 2)): {
        "exp2f (accurate) for ex2.approx": [(_K3_EXP, _K3_EXP.replace("fast_exp2", "exp2f"))],
        "no exp2": [(_K3_EXP, _K3_EXP.replace("fast_exp2", ""))],
        "no S^T/dP^T products": [
            ("      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sKw",
             "      if (0) wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sKw"),
            ("      wgmma_m64n64k16_ss<1, 1>(ds, wgmma_desc(sVw",
             "      if (0) wgmma_m64n64k16_ss<1, 1>(ds, wgmma_desc(sVw")],
        "no S^T product": [("      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sKw",
                            "      if (0) wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sKw")],
        "no dP^T product": [("      wgmma_m64n64k16_ss<1, 1>(ds, wgmma_desc(sVw",
                             "      if (0) wgmma_m64n64k16_ss<1, 1>(ds, wgmma_desc(sVw")],
        "no dV/dK products": [
            ("      wgmma_m64n64k16<0>(dv_acc, ap[kk]", "      if (0) wgmma_m64n64k16<0>(dv_acc, ap[kk]"),
            ("      wgmma_m64n64k16<0>(dk_acc, as[kk]", "      if (0) wgmma_m64n64k16<0>(dk_acc, as[kk]")],
        "no q/dO copies after the first tile": [
            ("    if (t + 1 < n_tiles)\n", "    if (0 && t + 1 < n_tiles)\n")],
    },
    ("flash_bwd.cu", "mhmr_flash_bwd_t", (0,)): {
        "no dq product": [("      wgmma_m64n32k16_ss<1, 0>(", "      if (0) wgmma_m64n32k16_ss<1, 0>(")],
        "no dq bulk reduce": [("      bulk_reduce_add_f32(dqb", "      if (0) bulk_reduce_add_f32(dqb")],
    },
    ("flash_bwd.cu", "mhmr_flash_bwd_t", (1,)): {
        "K4a exp2f (accurate) for ex2.approx": [
            (_K4A_EXP, _K4A_EXP.replace("fast_exp2", "exp2f"))],
        "K4a no exp2": [(_K4A_EXP, _K4A_EXP.replace("fast_exp2", ""))],
        "K4a no S = q k^T product": [("      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sQw",
                                      "      if (0) wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sQw")],
        "K4a no dP = dO v^T product": [
            ("      wgmma_m64n64k16_ss<1, 1>(dp, wgmma_desc(sDOw",
             "      if (0) wgmma_m64n64k16_ss<1, 1>(dp, wgmma_desc(sDOw")],
        "K4a no dq product": [("      wgmma_m64n64k16<0>(acc, af[kk]",
                               "      if (0) wgmma_m64n64k16<0>(acc, af[kk]")],
        "K4a no k/v copies after the first kStages - 1 tiles": [
            ("      if (jn < n_tiles) {", "      if (0 && jn < n_tiles) {")],
    },
    ("flash_fwd_std.cu", "mhmr_flash_fwd_std", None): {
        "no S = q k^T product": [("    wgmma_m64n64k16_ss<0, 0>(s, ",
                                  "    if (0) wgmma_m64n64k16_ss<0, 0>(s, ")],
        "no P.V product": [("    wgmma_m64n64k16<1>(o, pf[kk]", "    if (0) wgmma_m64n64k16<1>(o, pf[kk]")],
        "no exp2": [(_K5_EXP + " - mx)", "(s[nt][2 * r] - mx)"),
                    (_K5_EXP1 + " - mx)", "(s[nt][2 * r + 1] - mx)")],
        "no ping-pong between the consumer warpgroups": [
            ("  const auto my_turn = [&] { named_barrier<256>(3 + cw); };",
             "  const auto my_turn = [&] {};"),
            ("    if (!(last && cw == 1)) named_barrier_arrive<256>(4 - cw);", ""),
            ("  if (cw == 1) named_barrier_arrive<256>(3);", "")],
        "no k/v copies after the first kStages tiles": [
            ("        mbar_expect_tx(&full[st], 2 * kTileBytes);\n",
             "        if (j >= kStages) {\n          mbar_arrive(&full[st]);\n          continue;\n"
             "        }\n        mbar_expect_tx(&full[st], 2 * kTileBytes);\n")],
    },
    ("layernorm_cm.cu", "mhmr_layernorm_cm", None): {
        "no variance pass": [
            ("  // variance of the centred values\n", "#if 0\n"),
            ("  for (int t = 0; t < V; ++t) acc[t] = rsqrtf(acc[t] / D + eps);",
             "#endif\n  for (int t = 0; t < V; ++t) acc[t] = 1.f;")],
        "no stores": [("      store<Out, V>(y + off, v);", "      if (0) store<Out, V>(y + off, v);")],
    },
}


# deliberately broken copies of the bf16 flash kernels and of K2, which
# chip_smoke.py phase 12 builds, one textual change each to the kernel's
# source (the same form as VARIANTS): the limit that holds the sound
# kernel to its plain version (phase 12's for K5, phase 3's for K1, phase 8's
# for K3, phase 4's for K2) must fail every one. The earlier 2e-2 abs limit
# passes K5's last, whose error is 1/64 of |out| (|out| < 0.3 on these inputs)
_K5_PV = "wgmma_m64n64k16<1>(o, pf[kk], wgmma_desc(sV + 16 * kk * 64, 1024, 1024), 1);"
K5_MUTANTS = {
    "P.V k-step 3 (keys 48-63) of every kv tile dropped": [(_K5_PV, "if (kk != 3) " + _K5_PV)],
    "P.V k-step 3 (keys 48-63) of the first kv tile dropped": [
        (_K5_PV, "if (tile != 0 || kk != 3) " + _K5_PV)],
    "P.V k-step 3 reads the v rows of k-step 2": [
        ("wgmma_desc(sV + 16 * kk * 64,", "wgmma_desc(sV + 16 * (kk == 3 ? 2 : kk) * 64,")],
    "output normalised by a row sum 1/64 too large": [
        ("inv[r] = 1.f / l;", "inv[r] = 1.f / (l * 1.015625f);")],
}
_K1_PV = "wgmma_m64n64k16<0>(o, pf[kk], desc_plus(dv, (kk / 4) * kTileBytes + 32 * (kk % 4)), 1);"
K1_MUTANTS = {
    "P.V k-step 3 (keys 48-63) of every kv tile dropped": [(_K1_PV, "if (kk != 3) " + _K1_PV)],
    "P.V k-step 3 (keys 48-63) of the first kv tile dropped": [
        (_K1_PV, "if (tile != 0 || kk != 3) " + _K1_PV)],
}
K2_MUTANTS = {
    "channels 0-7 (warp 0's first load) left out of the variance sum": [
        ("acc[t] = fmaf(d, d, acc[t]);", "acc[t] = warp == 0 && i == 0 ? acc[t] : fmaf(d, d, acc[t]);")],
    "mean taken over D - 8 channels": [("mu[t] = acc[t] / D;", "mu[t] = acc[t] / (D - 8);")],
}
_K3_DQ = "wDQ[ch * kLdDQ + 16 * (warp % 4) + g + 8 * (i / 2)] = dqa[j][i] * scale;"
_K4A_DQ = "wgmma_m64n64k16<0>(acc, af[kk], wgmma_desc(sK + 16 * kk, 0, 1024), 1);"
K4A_MUTANTS = {
    "dq product reads the v tile in place of k": [(_K4A_DQ, _K4A_DQ.replace("sK +", "sV +"))],
    "no kv_len mask (p and the zeroed k/v of the last tile)": [
        ("const bool tail = n0 + kKBlk > kv_len;", "const bool tail = false;")],
}
# K4b is K3's kernel without the dq partial (kDq = false): its mutants change
# that instance alone
_K4B_DS = "ds[nt][i] = p * (ds[nt][i] - tD[c]);"
_K4B_DK = "sK[o] = BF16::store(dk_acc[d][i] * scale);"
K4B_MUTANTS = {
    "ds without the -D term": [
        (_K4B_DS, "ds[nt][i] = kDq ? p * (ds[nt][i] - tD[c]) : p * ds[nt][i];")],
    "dk not scaled": [(_K4B_DK, "sK[o] = BF16::store(kDq ? dk_acc[d][i] * scale : dk_acc[d][i]);")],
}
K3_MUTANTS = {
    "dq channels 24-31 and 56-63 dropped from the partial of every query tile": [
        (_K3_DQ, _K3_DQ.replace("= dqa[j][i] * scale;", "= j == 3 ? 0.f : dqa[j][i] * scale;"))],
    "dq channels 24-31 and 56-63 dropped from the partial of the first query tile": [
        (_K3_DQ, _K3_DQ.replace("= dqa[j][i] * scale;",
                                "= t == 0 && j == 3 ? 0.f : dqa[j][i] * scale;"))],
}
# kernel -> (source, its mutants), in the order phase 12 checks them
MUTANTS = {"K5": ("flash_fwd_std.cu", K5_MUTANTS), "K1": ("flash_fwd.cu", K1_MUTANTS),
           "K3": ("flash_bwd.cu", K3_MUTANTS), "K4a": ("flash_bwd.cu", K4A_MUTANTS),
           "K4b": ("flash_bwd.cu", K4B_MUTANTS), "K2": ("layernorm_cm.cu", K2_MUTANTS)}


# ---- card times of the kernels and of the 896_L forward: chip_smoke.py phases 7,
# 11 and 12, and each turn of ``ab`` ----


PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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


def time_forward(model, attention, norm, card):
    """Phase 7: ``model``'s forward at batch 1 (896_L), then K1 and K2 against
    their plain versions, the library calls and their bounds."""
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

    k2 = time_k2(norm, card)
    return {"fwd_ms": fwd_ms, "k1": (k1, k1_plain, k1_lib, *k1_bound), "k2": k2}


def rotation(fn, inputs):
    """A call of ``fn`` on the next of ``inputs`` in turn."""
    turn = [0]

    def call():
        fn(inputs[turn[0] % len(inputs)])
        turn[0] += 1
    return call


def time_k2(norm, card, D=1024, phase=7):
    """K2, its plain version and ``F.layer_norm`` at [1, D, 4104] bf16 (D =
    1024: ViT-L; 1536: ViT-g/14, K2's wide path): back to back on one tensor
    (input and output stay in the 50 MB L2) and over a rotation of 8 inputs
    (read from device memory), the host queued ahead of the device. Returns
    (K2, plain, F.layer_norm, bound, bound_by), the device-memory readings."""
    F = torch.nn.functional
    N = 4104  # the pre-padded 896 px stream
    xs = [torch.randn((1, D, N), device="cuda").to(torch.bfloat16) for _ in range(8)]
    xts = [x.transpose(1, 2).contiguous() for x in xs]  # [1, 4104, D]
    s, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
    sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
    kern = lambda x: norm.layernorm_cm(x, s, b)  # noqa: E731
    lib = lambda x: F.layer_norm(x, (D,), sb, bb, 1e-6)  # noqa: E731
    one = {name: cuda_ms(lambda: fn(x), iters=48, ahead_ms=5)
           for name, fn, x in (("K2", kern, xs[0]), ("F.layer_norm", lib, xts[0]))}
    rot = {name: cuda_ms(rotation(fn, x), iters=48, ahead_ms=5)
           for name, fn, x in (("K2", kern, xs), ("F.layer_norm", lib, xts))}
    plain = cuda_ms(lambda: norm.layernorm_cm_reference(xs[0], s, b), iters=20)
    bound = bound_ms(8 * D * N, 2 * D * N * 2 + 2 * D * 4)
    log(phase, f"K2 [1,{D},4104] bf16->bf16: kernel {rot['K2']:.4f} ms over 8 rotating "
               f"inputs, {one['K2']:.4f} ms on one tensor (L2); F.layer_norm [1,4104,{D}] "
               f"{rot['F.layer_norm']:.4f} / {one['F.layer_norm']:.4f} ms; plain {plain:.4f} "
               f"ms; bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    return (rot["K2"], plain, rot["F.layer_norm"], *bound)


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
    pair = t[attention.KERNEL_BWD_DQ] + t[attention.KERNEL_BWD_DKV]
    log(11, f"flash backward [1,16,64,4104] kv_len 4097 bf16 [{card}]: K3 "
            f"{t[attention.KERNEL_BWD]:.4f} ms "
            f"(whole fused backward with D and the dq cast {whole:.4f} ms), "
            f"K4a {t[attention.KERNEL_BWD_DQ]:.4f} ms + K4b {t[attention.KERNEL_BWD_DKV]:.4f} ms "
            f"= {pair:.4f} ms (the two-pass backward, {pair / lib:.2f}x SDPA's, "
            f"{pair / t[attention.KERNEL_BWD]:.2f}x K3's), plain {plain:.4f} ms, SDPA backward "
            f"[1,16,4097,64] {lib:.4f} ms; bounds (4,097 tokens) K3/K4a/K4b "
            + "/".join(f"{b[0]:.4f}" for b in bounds.values()) + " ms (operations)")
    # SDPA's backward computes dq, dk and dv: K3's function, and K4a's and
    # K4b's together
    return {name: (t[name], plain, lib, *bounds[name]) for name in t}


def std_qkv_views(n, dtype, heads=16, seed=0, batch=1):
    """q, k, v as the standard-stream ViT makes them: [B, H, N, 64] views of
    one [B, N, 3*H*64] projection output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((batch, n, 3 * heads * 64), device="cuda", generator=g).to(dtype)
    return qkv.reshape(batch, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)


def time_k5(attention, cuda_lib, card):
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
    encode_us = cuda_lib.library().mhmr_flash_fwd_std_encode_ns(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, N, *q.stride()[:3], 1000) / 1e3
    n_calls = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        attention._flash_fwd_std(q, k, v)
    host_us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    log(12, f"K5 [1,16,4097,64] bf16 (strided views of the projection): kernel {k5:.4f} ms, "
            f"plain {plain:.4f} ms, SDPA forward on the same views {lib:.4f} ms, "
            f"K1 [1,16,64,4104] kv_len 4097 {k1:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
            f"host: {encode_us:.2f} us per call encoding the three tensor maps, "
            f"{host_us:.2f} us per call of the whole wrapper [{card}]")
    return (k5, plain, lib, *bound)


def ab(trees) -> int:
    for tree in trees:
        print(f"== turn: {os.path.abspath(tree)}", flush=True)
        rc = subprocess.run([sys.executable, "-m", "multihmr_tpu_torch.tools.kernel_timing",
                             "_turn"], cwd=tree).returncode
        if rc:
            return rc
    return 0


def _turn() -> int:
    """One turn of ``ab``, in the tree it runs from (``python -m`` puts that
    tree's port first on the path)."""
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.ops import attention, cuda_lib, norm
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    card = device_line("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, secs = cuda_lib.build()
    print(f"kernels built in {secs:.1f} s", flush=True)
    model = build_model("multiHMR_896_L", device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    time_forward(model, attention, norm, card)
    del model
    torch.cuda.empty_cache()
    time_bwd(attention, card)
    for line in kernel_ms(attention, norm):
        print(f"{line} [{card}]", flush=True)
    return 0


def _inputs():
    """The 896_L bf16 inputs of K5 (q, k, v views of one packed [1, N, 3 * 16
    * 64] projection, N = 4097) and K2 (8 x [1, 1024, 4104]), seeded."""
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((1, 4097, 3 * 16 * 64), device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = qkv.reshape(1, 4097, 3, 16, 64).permute(2, 0, 3, 1, 4).unbind(0)
    xs = [torch.randn((1, 1024, 4104), device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(8)]
    return (q, k, v), xs


def _bwd_inputs(attention):
    """The 896_L bf16 inputs of K1, K3, K4a and K4b, seeded: q, k, v views
    of one [1, 3 * 16 * 64, 4104] projection (kv_len 4097), o and lse of the
    given module's forward, dO, D, and three output tensors. Returns
    (q, k, v, o, lse, do, dd, outs)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((1, 3 * 16 * 64, 4104), device="cuda", generator=g).to(
        torch.bfloat16).reshape(1, 3, 16, 64, 4104).unbind(1)
    o, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=4097)
    do = torch.randn(q.shape, device="cuda", generator=g).to(torch.bfloat16)
    dd = (do.float() * o.float()).sum(2)
    return q, k, v, o, lse, do, dd, [torch.empty_like(o) for _ in range(3)]


def _bwd_call(attention, kernel, inputs):
    """One launch of a backward kernel (K3, K4a or K4b) on ``inputs``."""
    q, k, v, _, lse, do, dd, outs = inputs
    return lambda: attention._flash_bwd_t_cuda(kernel, q, k, v, do, lse, dd, 64 ** -0.5, 4097,
                                               *outs)


def kernel_ms(attention, norm):
    """K5 at [1, 16, 4097, 64], K2 at [1, 1024, 4104] and, on its wide path,
    at ViT-g/14's [1, 1536, 4104] (one tensor, and 8 rotating inputs), and
    K3, K4a, K4b at [1, 16, 64, 4104] with kv_len 4097, through the given
    modules' wrappers, bf16, the host queued ahead: lines of text."""
    (q, k, v), xs = _inputs()
    s, b = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
    k5 = cuda_ms(lambda: attention._flash_fwd_std(q, k, v), iters=20, ahead_ms=2)
    k2 = cuda_ms(lambda: norm.layernorm_cm(xs[0], s, b), iters=48, ahead_ms=5)
    k2_rot = cuda_ms(rotation(lambda x: norm.layernorm_cm(x, s, b), xs), iters=48, ahead_ms=5)
    g = torch.Generator(device="cuda").manual_seed(1)
    xw = [torch.randn((1, 1536, 4104), device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(8)]
    sw, bw = torch.ones(1536, device="cuda"), torch.zeros(1536, device="cuda")
    k2w = cuda_ms(lambda: norm.layernorm_cm(xw[0], sw, bw), iters=48, ahead_ms=5)
    k2w_rot = cuda_ms(rotation(lambda x: norm.layernorm_cm(x, sw, bw), xw), iters=48,
                      ahead_ms=5)
    k2w_bound = bound_ms(8 * 1536 * 4104, 2 * 1536 * 4104 * 2 + 2 * 1536 * 4)
    del xw
    inputs = _bwd_inputs(attention)
    bwd = {label: cuda_ms(_bwd_call(attention, kernel, inputs), iters=10, ahead_ms=2)
           for label, kernel in (("K3", attention.KERNEL_BWD), ("K4a", attention.KERNEL_BWD_DQ),
                                 ("K4b", attention.KERNEL_BWD_DKV))}
    return [f"K5 [1,16,4097,64] bf16: {k5:.4f} ms",
            f"K2 [1,1024,4104] bf16: {k2_rot:.4f} ms over 8 rotating inputs, {k2:.4f} ms on one "
            f"tensor (L2)",
            f"K2 wide [1,1536,4104] bf16: {k2w_rot:.4f} ms over 8 rotating inputs, {k2w:.4f} ms "
            f"on one tensor (L2), bound {k2w_bound[0]:.4f} ms ({k2w_bound[1]})",
            "[1,16,64,4104] kv_len 4097 bf16: "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in bwd.items())
            + f", K4a + K4b {bwd['K4a'] + bwd['K4b']:.4f} ms"]


def variants() -> int:
    from multihmr_tpu_torch.ops import attention, cuda_lib, norm

    card = device_line("cuda")
    cuda_lib.build()
    inputs = _bwd_inputs(attention)
    q, k, v = inputs[:3]
    (qs, ks, vs), xs = _inputs()
    s, b = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
    flash = "[1,16,64,4104] kv_len 4097"
    calls = {  # (entry, mode) -> (kernel, call, shape, iters, ahead_ms)
        ("mhmr_flash_fwd_t", None): (
            "K1", lambda: attention._flash_fwd_impl_t(q, k, v, kv_len=4097), flash, 20, 2),
        ("mhmr_flash_bwd_t", 0): (
            "K3", _bwd_call(attention, attention.KERNEL_BWD, inputs), flash, 20, 2),
        ("mhmr_flash_bwd_t", 1): (
            "K4a", _bwd_call(attention, attention.KERNEL_BWD_DQ, inputs), flash, 20, 2),
        ("mhmr_flash_bwd_t", 2): (
            "K4b", _bwd_call(attention, attention.KERNEL_BWD_DKV, inputs), flash, 20, 2),
        ("mhmr_flash_fwd_std", None): (
            "K5", lambda: attention._flash_fwd_std(qs, ks, vs), "[1,16,4097,64]", 20, 2),
        ("mhmr_layernorm_cm", None): (
            "K2", lambda: norm.layernorm_cm(xs[0], s, b), "[1,1024,4104]", 48, 5),
    }
    with tempfile.TemporaryDirectory() as tmp:
        builds = {key: cuda_lib.build_variants(key[0], table, tmp)
                  for key, table in VARIANTS.items()}
        for (source, entry, modes), table in builds.items():
            for name, build in table.items():
                for mode in modes or (None,):
                    kern, fn, shape, iters, ahead = calls[(entry, mode)]
                    turns = []
                    for use in (False, True, True, False):
                        if use:
                            with cuda_lib.use_variant(name, build, entry):
                                turns.append(cuda_ms(fn, iters=iters, ahead_ms=ahead))
                        else:
                            turns.append(cuda_ms(fn, iters=iters, ahead_ms=ahead))
                    sound, var = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                    print(f"{kern} ({source}) {shape} bf16, {name}: {var:.4f} ms against "
                          f"{sound:.4f} sound (turns {'/'.join(f'{t:.4f}' for t in turns)}) "
                          f"[{card}]", flush=True)
    return 0


def forward(tp_mode: str, top: int) -> int:
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    card = device_line("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model("multiHMR_896_L", device="cuda", seed=0, tp_mode=tp_mode)
    cast_backbone_bf16(model.net)
    x = torch.randn((1, 896, 896, 3), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    K = torch.tensor([[[776.0, 0, 448], [0, 776.0, 448], [0, 0, 1]]], device="cuda")
    with torch.inference_mode():
        ms = cuda_ms(lambda: model.forward(x, K), iters=5)
        print(f"896_L bf16 forward ({tp_mode}), batch 1: {ms:.3f} ms (CUDA events) [{card}]")
        profile_steps(lambda batch, epoch: model.forward(x, K), None, top, steps=3)
    return 0


# substrings of the mangled entry names -> the kernel each entry is
_ENTRY_KERNELS = {
    "flash_fwd_t_bf16_kernel": "K1 bf16", "flash_fwd_t_f32_kernel": "K1 fp32",
    "flash_bwd_dkv_bf16_kernelILb1": "K3 bf16", "flash_bwd_dkv_bf16_kernelILb0": "K4b bf16",
    "flash_bwd_dq_bf16_kernel": "K4a bf16", "flash_bwd_dq_f32_kernel": "K3/K4a fp32 (dq)",
    "flash_bwd_dkv_f32_kernel": "K3/K4b fp32 (dk, dv)", "flash_fwd_std_bf16_kernel": "K5 bf16",
    "flash_fwd_std_f32_kernel": "K5 fp32", "layernorm_cm_kernel": "K2",
}


def ptxas(names) -> int:
    from multihmr_tpu_torch.ops import cuda_lib

    so, secs = cuda_lib.build()
    print(f"kernels built in {secs:.1f} s ({so.name})")
    keep = False
    for line in (cuda_lib.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            keep = not names or any(n in line for n in names)
            if keep:
                print("== " + next((k for s, k in _ENTRY_KERNELS.items() if s in line), "?"))
        if keep or "warning" in line.lower():
            print(line)
    return 0


def s1() -> int:
    import dataclasses
    from unittest import mock

    import torch.nn.functional as F

    from multihmr_tpu_torch.config import VITS
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.ops import attention, norm
    from multihmr_tpu_torch.tools.train_smoke import synthetic_batch, train_config
    from multihmr_tpu_torch.train import trainer
    from multihmr_tpu_torch.train.trainer import make_train_step, to_device

    card = device_line("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(train_config("multiHMR_672_S", max_people=4),
                              compute_dtype="float32",
                              vit_override=dataclasses.replace(VITS, depth=4, layerscale_init=0.5))
    batch = synthetic_batch(2, cfg.max_people, cfg.img_size, seed=1)
    nudged = dict(batch, image=batch["image"] * (1 + 2.0 ** -22))

    def plain_bwd(q, k, v, o, lse, do, scale=None, kv_len=None, fused=True, out=None):
        grads = attention.flash_bwd_reference_t(q, k, v, o, lse, do, scale, kv_len)
        return grads if out is None else tuple(t.copy_(g) for t, g in zip(out, grads))

    def plain_std(q, k, v, scale=None, out=None):
        o, lse = attention.flash_fwd_reference(q, k, v, scale)
        return (o, lse) if out is None else (out.copy_(o), lse)

    plain = {  # each kernel of the fp32 train step -> its plain version
        "K1": mock.patch.object(attention, "_flash_fwd_impl_t", attention.mha_reference_t),
        "K3": mock.patch.object(attention, "_flash_bwd_impl_t", plain_bwd),
        "K5": mock.patch.object(attention, "_flash_fwd_std", plain_std),
        "K2": mock.patch.object(norm, "_layernorm_cm_fwd", norm.layernorm_cm_reference)}

    def step(dev, tp_mode, data=batch, patches=(), threads=None):
        """The step's gradients, its loss terms, the ViT's patch tokens z,
        their gradient dz, each loss term's share of it (dz of the term),
        and which ReLU units of the score head (mlp_classif) are active, as
        the run's own device computes them."""
        model = build_model("multiHMR_672_S", device=dev, seed=0, cfg=cfg, tp_mode=tp_mode)
        train = make_train_step(model, torch.optim.SGD(model.net.parameters(), lr=0.0))
        seen = {}
        loss_fn = trainer.multihmr_loss

        def hook(module, args, out):
            z = out["patch_tokens"]
            seen["z_live"] = z
            seen["z"] = z.detach().double().cpu()
            z.register_hook(lambda g: seen.__setitem__("dz", g.detach().double().cpu()))

        def relu_hook(module, args, out):
            x = args[0]
            pre = F.linear(x, module.fc0.weight.to(x.dtype), module.fc0.bias.to(x.dtype))
            seen["active"] = (pre > 0).cpu()

        def loss_by_term(*args, **kwargs):
            total, terms = loss_fn(*args, **kwargs)
            for k in ("bce", "offset", "rotmat", "shape", "dist", "transl", "j3d", "v3d"):
                g, = torch.autograd.grad(terms[k], seen["z_live"], retain_graph=True,
                                         allow_unused=True)
                seen[f"dz {k}"] = (torch.zeros(seen["z"].shape, dtype=torch.float64) if g is None
                                   else g.detach().double().cpu())
            return total, terms

        n_threads = torch.get_num_threads()
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            stack.callback(model.net.backbone.register_forward_hook(hook).remove)
            stack.callback(model.net.mlp_classif.register_forward_hook(relu_hook).remove)
            stack.enter_context(mock.patch.object(trainer, "multihmr_loss", loss_by_term))
            if threads:
                torch.set_num_threads(threads)
                stack.callback(torch.set_num_threads, n_threads)
            terms = train(to_device(data, dev), 0)
        grads = {k: p.grad.detach().double().cpu() for k, p in model.net.named_parameters()
                 if p.grad is not None}
        return grads, {k: float(v) for k, v in terms.items()}, seen

    def group(name):
        parts = name.split(".")
        if "blocks" in parts:  # a ViT block
            return "backbone block " + parts[parts.index("blocks") + 1]
        return ".".join(parts[:2]) if parts[0] == "backbone" else parts[0]

    def rel(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return ((a - b).abs().max() / max(b.abs().max().item(), 1e-30)).item()

    streams = {"heads": ("K1", "K2", "K3"), "ring": ("K5", "K3")}
    for tp_mode, kernels in streams.items():
        runs = {"cpu": step("cpu", tp_mode), "cpu 1 thread": step("cpu", tp_mode, threads=1),
                "card 1": step("cuda", tp_mode), "card 2": step("cuda", tp_mode),
                "card plain": step("cuda", tp_mode, patches=[plain[k] for k in kernels]),
                "card nudged": step("cuda", tp_mode, data=nudged),
                "card plain nudged": step("cuda", tp_mode, data=nudged,
                                          patches=[plain[k] for k in kernels])}
        for k in kernels:
            runs[f"card plain {k}"] = step("cuda", tp_mode, patches=[plain[k]])
        pairs = [("cpu 1 thread", "cpu"), ("card 1", "cpu"), ("card 2", "card 1"),
                 ("card plain", "cpu"), ("card plain", "card 1"), ("card nudged", "card 1"),
                 ("card plain nudged", "card plain")]
        pairs += [(f"card plain {k}", "card 1") for k in kernels]
        names = [k for k in runs["cpu"][0] if runs["cpu"][0][k].abs().max() > 0]
        errs = {pair: {k: rel(runs[pair[0]][0][k], runs[pair[1]][0][k]) for k in names}
                for pair in pairs}
        print(f"== S1, 672_S fp32 train step ({tp_mode}), batch 2, 4 blocks, LayerScale 0.5, "
              f"{len(names)} parameters; each entry max |a - b| / max |b| [{card}]")
        groups = sorted({group(k) for k in names}, key=lambda s: (not s.startswith("backbone"), s))
        for a, b in pairs:
            ra, rb = runs[a], runs[b]
            print(f"{a} vs {b}: gradients worst {max(errs[(a, b)].values()):.3e} ("
                  + ", ".join(f"{k} {errs[(a, b)][k]:.2e}" for k in
                              sorted(errs[(a, b)], key=errs[(a, b)].get, reverse=True)[:3])
                  + "); by group " + ", ".join(
                      f"{gn} {max(e for k, e in errs[(a, b)].items() if group(k) == gn):.2e}"
                      for gn in groups)
                  + f"; score-head ReLU units active in one run only "
                  f"{int((ra[2]['active'] != rb[2]['active']).sum())} of "
                  f"{ra[2]['active'].numel()}"
                  + f"; patch tokens z {rel(ra[2]['z'], rb[2]['z']):.2e}, dL/dz "
                  f"{rel(ra[2]['dz'], rb[2]['dz']):.2e} (of the term "
                  + ", ".join(f"{k[3:]} {rel(ra[2][k], rb[2][k]):.1e}" for k in ra[2]
                              if k.startswith("dz ")) + "); loss terms "
                  + ", ".join(f"{k} {rel(ra[1][k], rb[1][k]):.1e}" for k in rb[1]
                              if rb[1][k] != 0), flush=True)
    return 0


def rounding(seeds: int) -> int:
    from multihmr_tpu_torch.ops import attention

    card = device_line("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, kv, scale = 2312, 2305, 64 ** -0.5
    keep = torch.arange(n, device="cuda") < kv

    def rel(a, b):
        return ((a.float() - b.float())[..., :kv].abs().max()
                / b.float()[..., :kv].abs().max()).item()

    for seed in range(seeds):
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn((2, 3 * 4 * 64, n), device="cuda", generator=g).to(torch.bfloat16)
        qkv[..., kv:] = 30.0
        q, k, v = qkv.reshape(2, 3, 4, 64, n).unbind(1)
        o, lse = attention.mha_reference_t(q, k, v, kv_len=kv)
        do = torch.randn(q.shape, device="cuda", generator=g).to(torch.bfloat16)
        ref = attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=kv)[1]
        k3, k4b = (attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv, fused=f)[1]
                   for f in (True, False))
        qf = q.float()
        s = torch.einsum("bhdn,bhdm->bhnm", qf, k.float()) * scale
        p = torch.exp(s.masked_fill(~keep, float("-inf")) - lse[..., None])
        dp = torch.einsum("bhdn,bhdm->bhnm", do.float(), v.float())
        ds = (p * (dp - (do.float() * o.float()).sum(2)[..., None])).to(torch.bfloat16).float()
        emu = (torch.einsum("bhnm,bhdn->bhdm", ds, qf) * scale).to(torch.bfloat16)
        err = (k4b.float() - ref.float())[..., :kv].abs()
        b, h, d, m = (int(i) for i in torch.unravel_index(err.argmax(), err.shape))
        part = lambda sl: (scale * (ds[b, h, sl, m] * qf[b, h, d, sl]).sum()).item()  # noqa: E731
        print(f"seed {seed}: dk max err / max |dk| K3 {rel(k3, ref):.4f}, K4b {rel(k4b, ref):.4f}, "
              f"plain with ds in bf16 {rel(emu, ref):.4f}; K4b against it {rel(k4b, emu):.4f}; "
              f"largest error at (b {b}, h {h}, ch {d}, key {m}): K4b "
              f"{k4b[b, h, d, m].item():.5f}, "
              f"plain {ref[b, h, d, m].item():.5f}, of which true queries "
              f"{part(slice(0, kv)):.5f} and pad queries {part(slice(kv, n)):.5f} [{card}]",
              flush=True)
    return 0


_POLY_SRC = r"""
#include "common.cuh"

__global__ void poly_exp2_kernel(const float* x, float* y, long long n) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i < n) y[i] = mhmr::poly_exp2(x[i]);
}

extern "C" int poly_exp2_run(const float* x, float* y, long long n) {
  poly_exp2_kernel<<<static_cast<unsigned>((n + 255) / 256), 256>>>(x, y, n);
  return cudaDeviceSynchronize();
}
"""


def poly_exp2_error(tmp) -> dict:
    """``poly_exp2``'s largest relative error on the card, against
    ``torch.exp2`` in fp64: "[0, 1)" over x = -k 2^-23 (k < 2^23) and
    -(1 - ulp), whose reduced arguments cover [0, 1) on a 2^-23 grid;
    "[-126, 0]" over 2^24 points spread over that range."""
    from multihmr_tpu_torch.ops import cuda_lib

    d = Path(tmp)
    shutil.copy(cuda_lib.CSRC / "common.cuh", d)
    (d / "poly.cu").write_text(_POLY_SRC)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(d / "poly.so"),
                    str(d / "poly.cu")], check=True, capture_output=True)
    run = ctypes.CDLL(str(d / "poly.so")).poly_exp2_run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    one = torch.tensor(1.0, device="cuda")
    unit = -(torch.arange(1 << 23, device="cuda", dtype=torch.int32) * 2.0 ** -23)  # (-1, 0]
    unit = torch.cat([unit, -torch.nextafter(one, -one)[None]])  # and -(1 - ulp)
    spread = torch.linspace(-126.0, 0.0, 1 << 24, device="cuda")
    out = {}
    for name, x in (("[0, 1)", unit), ("[-126, 0]", spread)):
        y = torch.empty_like(x)
        err = run(x.data_ptr(), y.data_ptr(), x.numel())
        if err:
            raise RuntimeError(f"poly_exp2 kernel: CUDA error {err}")
        ref = torch.exp2(x.double())
        out[name] = ((y.double() - ref).abs() / ref).max().item()
    return out


def exp2() -> int:
    card = device_line("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        errs = poly_exp2_error(tmp)
    print("poly_exp2 largest relative error: " + ", ".join(
        f"x in {k}: {e:.3e} (2^{math.log2(e):.2f})" for k, e in errs.items()) + f" [{card}]",
        flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ab", help="phases 7 and 11 of each tree in turn")
    p.add_argument("trees", nargs="+")
    sub.add_parser("variants", help="K1, K3, K4a, K4b, K5 and K2 against textual variants")
    p = sub.add_parser("forward", help="time and profile the 896_L forward")
    p.add_argument("--tp_mode", default="heads", choices=("heads", "ring"))
    p.add_argument("--ops", type=int, default=20)
    p = sub.add_parser("ptxas", help="ptxas's registers, shared memory and spills per kernel")
    p.add_argument("names", nargs="*")
    sub.add_parser("s1", help="the 672_S fp32 train step's gradients, card against CPU")
    p = sub.add_parser("rounding", help="bf16 dk against the plain backward, with and "
                                        "without ds rounded to bf16")
    p.add_argument("--seeds", type=int, default=10)
    sub.add_parser("exp2", help="poly_exp2's relative error on the card")
    sub.add_parser("_turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA card", file=sys.stderr)
        return 2
    if args.cmd == "ab":
        return ab(args.trees)
    if args.cmd == "_turn":
        return _turn()
    if args.cmd == "variants":
        return variants()
    if args.cmd == "ptxas":
        return ptxas(args.names)
    if args.cmd == "s1":
        return s1()
    if args.cmd == "rounding":
        return rounding(args.seeds)
    if args.cmd == "exp2":
        return exp2()
    return forward(args.tp_mode, args.ops)


if __name__ == "__main__":
    raise SystemExit(main())
