"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``multihmr_tpu_torch/csrc`` and drives
the port's paths with seeded random weights and the synthetic SMPL-X-sized
body model: single-image ``multiHMR_896_L`` inference through the demo's
per-image entry point, ``multiHMR_896_L`` training through ``Trainer.fit``,
the BEDLAM training CLI (``cli/train.py``) with its epoch-end BEDLAM and EHF
evaluation, and the same entry points from seeded checkpoints in the
reference ``multiHMR_*.pt`` layout (the demo's ``--ckpt``, the CLI's
``--pretrained`` with its 3DPW evaluation), on the ViT's standard stream
(``--tp_mode ring``, K5) and its channels-major one (``heads``, K1 and K2),
serving ``multiHMR_672_B`` at batch 8 through the HTTP server with its
overlay renderer, the same model exported with ``torch.export`` and
served from the artifact, and the multi-device paths (tensor parallelism,
ring attention, FSDP, data parallelism, the torchrun launch) on the one
card. Phases, one line each:

  1. the card, its name and power limit (nvidia-smi);
  2. the kernel build;
  3. K1 (flash-attention forward) against its plain version at the ViT's
     lengths: bf16 at the pre-padded lengths (2,312, 4,104 and 8,472 tokens,
     junk past kv_len = 2,305, 4,097 and 8,465), fp32 at the true odd
     lengths, and at batch 2 (the training path's shape);
  4. K2 (channels-major LayerNorm) against its plain version at the
     channels-major stream's shapes ([1, 1024, N] for N = 2,312, 4,104 and
     8,472, and [2, 1024, 4104]), and its wide path (``layernorm_cm_wide``)
     at ViT-g/14's [1, 1536, 4104] and [8, 1536, 4104] and at [1, 1056,
     4104] (the last warp's second group of 32 channels absent), bf16 and
     fp32; an odd N raises;
  5. multiHMR_672_S in fp32 (LayerScale 0.5, so that the blocks move the
     stream): the card (kernels) against the CPU (plain versions), same
     weights and image, with 12 K1 and 24 K2 launches;
  6. multiHMR_896_L in bf16 on three images: finite meshes, and 24 K1 and
     48 K2 launches per image;
  7. times (CUDA events, medians after warm-up): the 896_L forward at batch 1,
     and each forward kernel against its plain version at the 896_L shapes
     (K1 on the pre-padded [1, 16, 64, 4104] with kv_len 4097; its bound and
     SDPA's forward on the 4,097 true tokens; K2 and ``F.layer_norm`` at
     [1, 1024, 4104], back to back on one tensor (in L2) and over a rotation
     of 8 inputs (from device memory), with the host queued ahead);
  8. K3 (fused flash backward) and K4a + K4b (two-pass, the path of
     ``_flash_bwd_impl_t(fused=False)``, whose launches are counted here)
     against the plain backward on phase 3's cases, and at batch 2 writing
     one packed [B, 3, H, 64, N] gradient as the training path does; dk and
     dv past kv_len exact zeros; K3 against K4a + K4b; two calls of the
     two-pass path bitwise equal (it is the deterministic backward);
  9. one multiHMR_672_S fp32 train step at batch 2 (ViT cut to 4 of its 12
     blocks, LayerScale 0.5), the card against the CPU: loss terms and
     gradients;
 10. multiHMR_896_L bf16 training, max_people 8, batch 2: 5 steps through
     ``Trainer.fit`` on collated synthetic samples (finite losses; 24 K1,
     24 K3 and 48 K2 launches per step), then, for both ViT streams, train
     steps with remat none, "mlp" and "block" at batch 2 (launches per step,
     step time, peak memory) and batch 1 (peak memory), and the fit of
     ``train/memory.py``'s constants to those peaks;
 11. times of the backward kernels and their plain version at
     [1, 16, 64, 4104] bf16 with kv_len 4097, and PyTorch's
     scaled_dot_product_attention backward at [1, 16, 4097, 64] (the
     library call of K3, and of K4a + K4b as one function), with the least
     time the card could take for each kernel's work on the 4,097 true
     tokens;
 12. K5 (standard-layout flash-attention forward) against its plain version
     at the ViT's lengths, bf16 and fp32, batch 1 and 2, on strided views of
     one [B, N, 3 * 16 * 64] projection, into the merged [B, N, H, 64] and
     the [B, H, 64, N] output layouts; deliberately broken copies of K5 (4),
     K1 (2), K3 (2), K4a (2), K4b (2) and K2 (2), each built from its
     kernel's source with one textual change in a temporary directory, which
     phase 12's, phase 3's, phase 8's and phase 4's limits must fail; then
     K5, K1 and the SDPA forward timed at [1, 16, 4097, 64] bf16, with K5's
     bound and the host cost of encoding its tensor maps;
 13. the standard stream (``tp_mode="ring"``): multiHMR_672_S fp32 card
     against CPU (inference at LayerScale 0.5 as in phase 5, and one batch-2
     train step cut to 4 blocks as in phase 9), then multiHMR_896_L bf16 at
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
     ``--tp_mode heads`` (24 K1, 24 K3, 48 K2 per step);
 15. seeded state dicts in the reference ``multiHMR_*.pt`` layout (the
     port's ``expected_reference_shapes``, LayerScale 0.5, a 37 x 37
     pos-embed grid) for 672_S and 896_L, saved with their ``args``: their
     size, ``torch.load`` and convert seconds; 672_S fp32 built from its
     file, card against CPU on both streams (detections equal, outputs
     within phase 5's 1e-3); 896_L through ``cli/demo.py --ckpt`` on three
     images with their overlays (heads: 24 K1 and 48 K2 per image, finite
     meshes, the demo's p50 ms per image) and through the demo's per-image
     body on the ring stream (24 K5, no K1 or K2);
 16. the training CLI's 3DPW evaluation from those files, in a temporary
     directory with a seeded 3DPW sequence (3 frames of 1080 x 1920 JPEG,
     a male and a female person whose GT is the evaluated model's own first
     two predictions) and ``$SMPLX_DIR`` in the reference layout (synthetic
     SMPL pkls, a sparse smplx2smpl [6890, 10475], J_regressor_h36m
     [17, 6890]): 896_L bf16 ``--tp_mode ring --eval_only 1 --pretrained``
     (finite PVE, PA-PVE, MPJPE, PA-MPJPE, recall 100, 24 K5 per image, the
     eval's timings); 672_S fp32 on the card and on the CPU (the same
     metrics within 1e-3 relative); then two 896_L training steps from the
     same file (finite losses, 24 K3 per step) with the epoch-end 3DPW
     evaluation of one frame.
 17. the Anny family (``multiHMR_672_L_anny``: ViT-L at 672 px, 8 x 512
     decoder, 163 bones) on the synthetic Anny asset at 10,475 vertices,
     read through ``$ANNY_NPZ``: (a) fp32 with the ViT cut to 4 blocks
     (LayerScale 0.5), card against CPU on both streams (detections equal,
     every output within phase 5's 1e-3, 4 K1 + 8 K2 or 4 K5 launches);
     (b) a seeded reference-layout ``multiHMR_672_L_anny.pt`` at full width
     (its size, load and convert seconds) through ``cli/demo.py --ckpt`` on
     three images per stream (24 K1 + 48 K2 and no K5 per image on heads,
     24 K5 and no K1/K2 on ring; finite meshes; persons sorted near to far;
     the demo's p50 ms per image); (c) the file's weights in bf16, ring
     against heads and each against an fp32 control (patch tokens, phase
     13's limits); (d) per stream the forward's wall, device busy ms and
     the body model's share of the wall, the launches of one 163-bone FK
     and the time of the product with the zero pose correctives;
 18. serving ``multiHMR_672_B`` (ViT-B/14, 2,305 tokens, 12 blocks) at batch
     8 with seeded weights and the bf16 backbone: (a) ``python -m
     multihmr_tpu_torch.cli.serve`` as a subprocess, /healthz, 4 JPEGs
     answered 200 with JSON; (b) ``make_server`` in process, 48 seeded JPEGs
     (640x480, 1280x720, 480x640) from 12 clients: all 200, /stats with 48
     requests and a mean batch above 1, 12 K1 + 24 K2 and no K5 per batch,
     and each request's persons equal to its image alone in slot 0 of a
     batch-8 forward (1e-5); a ring server: 12 K5 and no K1/K2 per batch;
     (c) K1 [8,12,64,2312] kv_len 2305, K2 [8,768,2312] and K5
     [8,12,2305,64] against their plain versions under phases 3, 4 and 12's
     limits; (d) ``?render=1``: a PNG of the original size whose
     X-Person-Count is the JSON count, equal to the compiled render of the
     request's meshes, and the compiled rasterizer bitwise equal to its
     numpy version on one of them, with both times; (e) a burst of 32 past
     ``max_queue`` 4 gives 429 with Retry-After, a 1 ms deadline gives 503,
     never a 500; (f) 256 requests from 16 clients against the full and the
     ``json_only`` server: images/s, latency p50/p95, mean batch, the
     worker's dispatch and extract p50, the card's busy share (profiler),
     and again with the readback synced inside ``batch_fn``; (g)
     ``cli/app.build_infer`` on 672_S: overlay and ``.glb``, then the cache;
     (h) ``cli/demo.py --extra_views 1 --distance 1 --save_mesh 1`` on two
     images at 896_L: every file the JAX demo writes, 24 K1 + 48 K2 each.
 19. export (``io/export.py``, K1/K2/K5 as ``torch.ops.mhmr`` operators):
     (a) ``multiHMR_672_B`` at batch 8, bf16 backbone, exported with
     ``torch.export`` on both streams, saved and loaded (seconds, the
     ``model.pt2`` size): 12 K1 + 24 K2 operators in the heads graph, 12 K5
     in the ring graph, no token-by-token score matrix in either and 24
     fewer aten LayerNorms on heads; every output on a seeded batch against
     the live forward (1e-5, the JAX export test's), and the launches per
     batch through the artifact; (b) a fresh ``python3 -c`` process with
     the port's ``models``, ``factory`` and ``bodymodel`` blocked loads
     the heads artifact and runs it on the card against the same
     reference outputs; (c) the batch-8 forward's host enqueue, wall
     (CUDA events) and device busy time, artifact against live module,
     and each operator's host cost per call against its direct wrapper at
     the 672_B shapes; (d) ``cli/serve.build_server --artifact`` (heads):
     phase 18's 48 requests, each bitwise equal to slot 0 of a batch-8
     forward, 12 K1 + 24 K2 per batch, phase 18 (f)'s saturation traffic
     beside phase 18's figures, and
     ``memory_allocated`` after start against a live server's; (e)
     ``multiHMR_672_L_anny`` at batch 1 on heads: the artifact against the
     live forward and 24 K1 + 48 K2 launches;
 20. the host pieces of the single-card user's path: (a) a probe that
     compiles a file including jpeglib.h and png.h linked with -ljpeg
     -lpng, then the build of ``csrc/image_io.cpp``; JPEG and PNG files at
     five sizes decoded against PIL (mean |d| < 1.5 levels) and
     preprocessed at S = 896, 672 and 674 against PIL contain + pad +
     normalize and ``preprocess_array`` (max |d| < 0.018, mean < 1e-3),
     ``NativeImageLoader`` bitwise equal to ``preprocess_file``, a bad path
     giving -1, and host times (``preprocess_file`` against the PIL path,
     the loader's images/s at 1 thread and at all CPUs); (b) ``cli/demo.py``
     ``multiHMR_896_L`` over 8 JPEGs in turns with the PIL loop it replaced:
     ``"loader": "native"`` exactly when the probe compiles, each image's
     JSON bitwise equal to a forward of its ``preprocess_file`` tensor, 24
     K1 + 48 K2 per image, p50 ms per image of each; (c) flax-layout
     ``ckpt_000000.msgpack`` files of the JAX tree of phase 15's seeded
     896_L and 672_S reference files: ``load_jax_checkpoint`` bitwise equal
     to the ``.pt`` route, and ``cli/train.py --eval_only 1 --pretrained``
     of each 672_S file with bitwise equal metrics; (d) ``cli/data.py``
     ``create_jpeg``, ``create_annots``, ``dataloader`` and ``visualize``
     on seeded BEDLAM and EHF trees (GT vertices on the card within 1e-4 m
     of the CPU's).
 21. multi-device execution (``multihmr_tpu_torch/parallel``) on the one
     card: K1 and K3 at 8 and 4 heads (tensor parallelism's shares of
     896_L's 16) against their plain versions under phases 3 and 8's
     limits; then two spawned ranks on cuda:0 joined by gloo, which stage
     through host memory the calls gloo does not take on CUDA tensors
     (``stage_collectives``: ``batch_isend_irecv`` and FSDP2's all-gather
     and reduce-scatter; each rank prints them with their bytes): (a)
     896_L bf16 with heads TP at model 2 (LayerScale 0.5) against one
     rank on the same weights, patch tokens and v3d (under one rank's
     detections) within phase 13's stream limit and no further from the
     fp32 stream than one rank is, 24 K1 at 8 heads + 48 K2 per rank; (b)
     a 672_S fp32 4-block TP train step against one rank (gradients within
     2e-3, updated parameters within 1e-3 of the step), and one 896_L bf16
     step at full depth (finite, 24 K1 + 24 K3 + 48 K2 per rank); (c) the
     ring at model 2 against the one-rank standard stream; (d) FSDP at data
     2 with 4 and 1 valid slots on the ranks, the step against one rank and
     the Adam moments' bytes per rank about half one rank's; then in this
     process (e) ``folder_inference`` and a ``--dp`` server over [cuda:0,
     cuda:0] at 672_B batch 8, each answer bitwise equal to its batch-4
     chunk's single-device forward, 24 K1 + 48 K2 per batch; (f) ``torchrun
     --nproc_per_node 1 -m multihmr_tpu_torch.cli.train --n_devices 1`` for
     two steps on NCCL. Times here come from two ranks sharing one card
     through staged collectives and are no scaling figure.

 22. the measurement tools (``multihmr_tpu_torch/tools``, timing through
     ``utils/profiling.py``), in process: (a) ``profile_model`` over the
     six SMPL-X configurations at batch 1, bf16, heads (finite outputs,
     ms/img, 12 K1 + 24 K2 per forward for S and B, 24 + 48 for L, peak
     memory), ``multiHMR_1288_L_bedlam`` also with ``--stages`` and ``--ops
     10`` (the ViT alone, device busy per forward, the top kernels) and on
     ring (24 K5, no K1 or K2); (b) ``sweep_capacity`` at 672_B and 896_L
     over 16, 32 and 64 slots; (c) ``bf16_sensitivity`` at 672_S, 672_L,
     896_L and 1288_L_bedlam (1 seed, 1 image, 3 persons) beside the JAX
     package's figures; (d) ``bench_eval`` at 672_S over 100 fixture
     images, the u8 wire and the same pixels normalized on the host, each
     pipelined and serial (images/s, the phases' share of the wall, equal
     F1); (e) ``parity_harness`` at 672_S fp32 (LayerScale 0.5) on three
     seeded JPEGs and a reference-layout checkpoint, the card against
     ``stage_*`` dumps of the CPU plain path, exit 0; (f) 3 training steps
     of ``multiHMR_1288_L_bedlam`` at batch 1 through ``tools/train_smoke``
     (finite losses, 24 K1 + 24 K3 + 48 K2 per step, ms per step, peak
     memory). Cut to fit the script's time: ``latency_stats`` chains of 4
     and 8 forwards, 3 repeats.

 23. ``multiHMR_896_G`` (DINOv2 ViT-g/14: 40 blocks of 1,536, a SwiGLU FFN;
     ``port_config.py``) in bf16 through ``folder_inference`` at batch 8
     over 8 images of the folder cells' four sizes, after one warm-up call:
     40 K1 and 80 K2 launches per batch, all 80 on K2's wide path, counted
     from 0 just before the call; finite outputs; K2's wide path timed at
     [1, 1536, 4104] as phase 7 times the narrow one.

Then a JSON line of the kernels (each with ``artifact_launches``, its
launches per 672_B batch through phase 19's artifacts; ``launches`` adds
phase 21's, all ranks, and phase 22's; K2's wide path is its own entry,
``layernorm_cm_wide``, with phase 23's launches), the nvidia-smi
line, and last
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

from multihmr_tpu_torch.tools.kernel_timing import (MUTANTS, bound_ms, log, qkv_views,
                                                    std_qkv_views, time_bwd, time_forward,
                                                    time_k2, time_k5)
from multihmr_tpu_torch.utils.profiling import cuda_ms, device_line

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
# 672_S fp32 train step at LayerScale LAYERSCALE, card vs CPU: loss terms and
# each parameter's gradient, relative to the largest magnitude. The patch
# tokens agree to ~1e-6, but the score head's ReLU (mlp_classif) makes the
# gradient jump where a unit's input sits within rounding of 0: any change of
# ~1e-7 (an image nudged by 2^-22, a kernel swapped for its plain version)
# flips units and moves gradients by fixed steps of up to 9.6e-4
# (tools/kernel_timing.py s1); the limit is twice that
TRAIN_TOL = 2e-3
# 896_L bf16 on the same weights: relative L2 error of the final-norm patch
# tokens, ring against heads and each stream against the fp32 heads stream
# (the control). bf16 rounds at other places on the two streams (F.linear
# against baddbmm epilogues, K5 against K1, fp32 F.layer_norm against K2)
# over 24 blocks
STREAM_TOL = 2e-2
# ring no further from the fp32 control than heads is, by more than this
STREAM_RATIO = 1.1
# LayerScale init of the models whose outputs and gradients phases 5, 9 and
# 13 compare: DINOv2's 1e-5 scales every block's branches down to about 1e-5
# of the stream, so a check of the outputs would not see the blocks (nor
# their kernels); at 0.5 each block moves the stream by its own size
LAYERSCALE = 0.5


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


# K2's cases (batch, N): the channels-major stream's pre-padded token counts
# at 672, 896 and 1288 px, and 896 px at the training batch; its dtype pairs
K2_CASES = [(1, 2312), (1, 4104), (1, 8472), (2, 4104)]
# its wide path (batch, D, N): ViT-g/14's stream at batch 1 and at the
# folder cell's batch 8, and D = 1056, where the last warp owns one group of
# 32 channels and not two
K2_WIDE_CASES = [(1, 1536, 4104), (8, 1536, 4104), (1, 1056, 4104)]
K2_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.float32, torch.float32)]


def k2_inputs(batch, n, seed=1, d=1024):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, d, n), device="cuda", generator=g) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    bias = 0.1 * torch.randn(d, device="cuda", generator=g)
    return x, scale, bias


def k2_cases(norm, x, scale, bias):
    """K2 against its plain version in every dtype pair: [(pair, ok, max abs
    err, text)] under phase 4's limits."""
    res = []
    for in_dt, out_dt in K2_DTYPES:
        xi = x.to(in_dt)
        y = norm.layernorm_cm(xi, scale, bias, 1e-6, out_dt)
        ref = norm.layernorm_cm_reference(xi, scale, bias, 1e-6, torch.float32)
        err = (y.float() - ref).abs()
        if out_dt == torch.float32:
            ok, tol = err.max().item() <= K2_TOL_FP32, f"tol {K2_TOL_FP32:g}"
        else:
            ok = bool((err <= ref.abs() * K2_TOL_BF16_REL + 1e-6).all())
            tol = f"tol {K2_TOL_BF16_REL:g} x |y|"
        pair = f"{str(in_dt)[6:]}->{str(out_dt)[6:]}"
        res.append((pair, ok, err.max().item(), f"max err {err.max().item():.3e} ({tol})"))
    return res


def check_k2(norm):
    """K2 at the stream's shapes, its wide path at ViT-g/14's; returns the
    max abs bf16->bf16 error of each kernel ({name: error}): at [B, 1024,
    4104], B = 1 and 2 (the 896_L shapes), and at [B, 1536, 4104], B = 1
    and 8 (the 896_G shapes)."""
    worst = {norm.KERNEL: 0.0, norm.KERNEL_WIDE: 0.0}
    cases = [(b, 1024, n) for b, n in K2_CASES] + K2_WIDE_CASES
    for batch, d, n in cases:
        x, scale, bias = k2_inputs(batch, n, d=d)
        for pair, ok, err, text in k2_cases(norm, x, scale, bias):
            log(4, f"K2 [{batch},{d},{n}] {pair}: {text} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K2 disagrees with its plain version")
            if n == 4104 and d in (1024, 1536) and pair == "bfloat16->bfloat16":
                name = norm.KERNEL if d == 1024 else norm.KERNEL_WIDE
                worst[name] = max(worst[name], err)
        del x, scale, bias
    x = torch.zeros((1, 1024, 4097), device="cuda", dtype=torch.bfloat16)
    s = torch.ones(1024, device="cuda")
    try:
        norm.layernorm_cm(x, s, s)
    except ValueError as e:
        log(4, f"K2 [1,1024,4097] bf16 (odd N) raises: {e} ok")
    else:
        raise AssertionError("K2 took an odd N on the card")
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


def _grad_rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def _bits(t):
    """``t``'s bits as integers: equal exactly when the values are bitwise
    equal, NaN included."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_bwd(attention, cuda_lib):
    """K3 and K4a + K4b against the plain backward, and a second call of the
    two-pass path against the first, bit for bit. Returns the max abs
    errors at [B, 16, 64, 4104] bf16 with kv_len 4097, B = 1 and 2 (K3's
    dq/dk/dv, K4a's dq, K4b's dk/dv), and the launches of the two-pass path
    ``_flash_bwd_impl_t(fused=False)``, counted from 0 just before each of
    its first calls."""
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
                  for _ in range(3)] if batch > 1 else [None] * 3
        out = lambda i: None if packed[i] is None else packed[i].unbind(1)  # noqa: E731
        fused = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=True,
                                            out=out(0))
        cuda_lib.reset_launches()  # the two-pass path's run starts here
        two = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=False,
                                          out=out(1))
        for name in two_pass:  # read just after it
            two_pass[name] += cuda_lib.LAUNCHES[name]
        again = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=False,
                                            out=out(2))
        torch.cuda.synchronize()
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(two, again))
        lim = n if kv_len is None else kv_len  # the pad lanes' dq is junk on both sides
        cut = lambda ts: [t[..., :lim] for t in ts]  # noqa: E731
        e3 = [_grad_rel(a, r) for a, r in zip(cut(fused), cut(ref))]
        e4 = [_grad_rel(a, r) for a, r in zip(cut(two), cut(ref))]
        e34 = [_grad_rel(a, r) for a, r in zip(cut(fused), cut(two))]
        zeros = kv_len is None or not any(t[..., kv_len:].any() for t in fused[1:] + two[1:])
        tol = BWD_TOL[dt]
        ok = all(e <= tol for e in e3 + e4 + e34) and zeros and same  # NaN fails
        name = case_name(n, dt, kv_len, batch) + (", packed gradient" if batch > 1 else "")
        fmt = lambda es: "/".join(f"{e:.2e}" for e in es)  # noqa: E731
        log(8, f"{name}: rel err dq/dk/dv K3 {fmt(e3)}, K4a+K4b {fmt(e4)}, K3 vs K4 "
               f"{fmt(e34)} (tol {tol:g})" + ("" if kv_len is None else
               f", dk/dv past kv_len {'exact zeros' if zeros else 'NOT ZERO'}")
               + f"; K4a+K4b twice: {'bitwise equal' if same else 'DIFFER'}"
               + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash backward {name} disagrees with its plain version")
        if (n, dt, kv_len, batch) in K1_MAIN:
            abs_err = lambda a, r: (a.float() - r.float()).abs().max().item()  # noqa: E731
            errs["K3"] = max(errs["K3"], *(abs_err(a, r) for a, r in zip(fused, ref)))
            errs["K4a"] = max(errs["K4a"], abs_err(two[0], ref[0]))
            errs["K4b"] = max(errs["K4b"], *(abs_err(a, r) for a, r in zip(two[1:], ref[1:])))
        del q, k, v, o, lse, do, ref, fused, two, again, packed
        torch.cuda.empty_cache()
    log(8, "two-pass path launches K4a/K4b " + "/".join(str(c) for c in two_pass.values()))
    return errs, two_pass


# train-step launches (K1, K3, K2, K5) with 4 ViT blocks, per stream
TRAIN_E2E_LAUNCHES = {"heads": (4, 4, 8, 0), "ring": (0, 4, 0, 4)}


def check_train_e2e(cuda_lib, attention, norm, phase=9, tp_mode="heads"):
    """One 672_S fp32 train step at batch 2 (4 ViT blocks, LayerScale
    LAYERSCALE), card against CPU."""
    from multihmr_tpu_torch.config import VITS
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.tools.train_smoke import synthetic_batch, train_config
    from multihmr_tpu_torch.train.trainer import make_train_step, to_device

    cfg = dataclasses.replace(train_config("multiHMR_672_S", max_people=4),
                              compute_dtype="float32",
                              vit_override=dataclasses.replace(VITS, depth=4,
                                                               layerscale_init=LAYERSCALE))
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
    log(phase, f"672_S fp32 train step ({tp_mode}), batch 2 (ViT cut to 4 of 12 blocks, "
               f"LayerScale {LAYERSCALE:g}), card "
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


def check_mutants(attention, norm, cuda_lib):
    """Build the mutants of K5, K1, K3, K4a, K4b and K2
    (cuda_lib.build_variants: one nvcc each, all started together), run each
    through its kernel's wrapper at the 896_L shape ([1, 16, 4097, 64] for
    K5; [1, 16, 64, 4104] with kv_len 4097 for K1, K3 and the two-pass
    K4a + K4b; [1, 1024, 4104] for K2, in every dtype pair) and hold it to
    its sound kernel's limit, which must fail. Returns {kernel: {mutant: max
    abs error}}."""
    import tempfile

    counted = (attention.KERNEL_STD, attention.KERNEL, attention.KERNEL_BWD,
               attention.KERNEL_BWD_DQ, attention.KERNEL_BWD_DKV, norm.KERNEL)
    launches = {k: cuda_lib.LAUNCHES[k] for k in counted}
    readings = {"K5": {}, "K1": {}, "K3": {}, "K4a": {}, "K4b": {}, "K2": {}}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {kern: cuda_lib.build_variants(source, table, tmp)
                  for kern, (source, table) in MUTANTS.items()}
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
        for kern, fused in (("K3", True), ("K4a", False), ("K4b", False)):
            for name, build in builds[kern].items():
                with cuda_lib.use_variant(name, build, "mhmr_flash_bwd_t"):
                    grads = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=n,
                                                        fused=fused)
                errs = [_grad_rel(a[..., :n], r[..., :n]) for a, r in zip(grads, ref)]
                passed = all(e <= BWD_TOL[torch.bfloat16] for e in errs)  # NaN fails
                log(12, f"{kern} mutant ({name}) [1,16,64,4104] kv_len 4097 bf16"
                        f"{'' if fused else ', two-pass path'}: rel err dq/dk/dv "
                        + "/".join(f"{e:.2e}" for e in errs)
                        + f" (tol {BWD_TOL[torch.bfloat16]:g}); phase 8's limit "
                        f"{'PASSES IT: FAIL' if passed else 'fails it: ok'}")
                if passed:
                    raise AssertionError(f"phase 8's limit passes the broken {kern} ({name})")
                readings[kern][name] = max((a[..., :n].float() - r[..., :n].float()).abs()
                                           .max().item() for a, r in zip(grads, ref))
        x, scale, bias = k2_inputs(1, 4104)
        for name, build in builds["K2"].items():
            with cuda_lib.use_variant(name, build, "mhmr_layernorm_cm"):
                res = k2_cases(norm, x, scale, bias)
            passed = all(ok for _, ok, _, _ in res)
            log(12, f"K2 mutant ({name}) [1,1024,4104]: "
                    + "; ".join(f"{pair} {text} {'passes' if ok else 'fails'}"
                                for pair, ok, _, text in res)
                    + f"; phase 4's limit {'PASSES IT: FAIL' if passed else 'fails it: ok'}")
            if passed:
                raise AssertionError(f"phase 4's limit passes the broken K2 ({name})")
            readings["K2"][name] = max(err for _, _, err, _ in res)
    for kern in counted:  # the mutants' launches do not count
        cuda_lib.LAUNCHES[kern] = launches[kern]
    return readings


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
    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.checkpoint import load_checkpoint

    cfg = ModelConfig(backbone="dinov2_vitl14", img_size=896, max_people=8)  # the CLI's
    model = build_model(device="cuda", cfg=cfg, tp_mode=tp_mode)
    model.net.load_state_dict(load_checkpoint(ckpt)[0])
    ehf_gt_from(model)


def ehf_gt_from(model):
    """Rewrite the EHF tree's GT meshes as ``model``'s first person on each
    image, at its image size."""
    from pathlib import Path

    from multihmr_tpu_torch.data import ehf as ehf_mod

    R = ehf_mod._rotvec_to_rotmat_np(ehf_mod.EHF_CAM_ROTVEC)
    ds = ehf_mod.EHF(img_size=model.cfg.img_size)
    for i in range(len(ds)):
        x, annot = ds[i]
        with torch.inference_mode():
            out = model.forward(torch.from_numpy(x[None]).cuda(),
                                torch.from_numpy(annot["K"][None]).cuda(), det_thresh=0.2)
        v_cam = model.extract_persons(out, fields=["v3d"])[0][0]["v3d"].astype(np.float64)
        write_ply(Path("data/EHF") / annot["imagename"].replace("img.png", "align.ply"),
                  (v_cam - ehf_mod.EHF_CAM_T) @ R)  # inverse of v @ R.T + T
    os.remove(os.path.join("data", "ehf_test.pkl"))  # the dataset rebuilds its annotations


class CountedCLI:
    """Runs ``cli/train.py::main`` with the launches counted from 0 just
    before the run and read just after it, and each train step's launches
    and loss terms recorded (Trainer builds its step through
    ``make_train_step``, which this wraps while in a ``with`` block)."""

    def __init__(self, cuda_lib, names, phase):
        from multihmr_tpu_torch.train import trainer as trainer_mod

        self.cuda_lib, self.names, self.phase = cuda_lib, names, phase
        self.trainer_mod, self.make = trainer_mod, trainer_mod.make_train_step
        self.per_step, self.losses = [], []

    def __enter__(self):
        def counting_make(*args, **kwargs):
            step = self.make(*args, **kwargs)

            def counted(batch, epoch):
                before = dict(self.cuda_lib.LAUNCHES)
                terms = step(batch, epoch)
                self.per_step.append(tuple(self.cuda_lib.LAUNCHES[k] - before.get(k, 0)
                                           for k in self.names))
                self.losses.append((float(terms["total"]), float(terms["finite"])))
                return terms
            return counted

        self.trainer_mod.make_train_step = counting_make
        return self

    def __exit__(self, *exc):
        self.trainer_mod.make_train_step = self.make

    def __call__(self, argv):
        """(launches of the run, its stdout lines, seconds)."""
        import contextlib
        import io

        from multihmr_tpu_torch.cli import train as train_cli

        self.per_step.clear()
        self.losses.clear()
        buf = io.StringIO()
        log(self.phase, "cli.train " + " ".join(argv))
        self.cuda_lib.reset_launches()  # this run starts here
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                train_cli.main(argv)
        finally:
            for line in buf.getvalue().splitlines():
                log(self.phase, "  " + line)
        launches = {k: self.cuda_lib.LAUNCHES[k] for k in self.names}  # read just after it
        return launches, buf.getvalue().splitlines(), time.perf_counter() - t0


def run_cli(cuda_lib, attention, norm):
    """The training CLI at full width and depth: a ring run (4 steps, eval
    of 2 BEDLAM + 2 EHF images) and a heads run (2 steps, eval of 1 EHF
    image), each counted from 0 just before it, and between them an
    ``--eval_only --pretrained`` run of the ring checkpoint on EHF GT made
    from its own predictions. Returns the ring training run's launches."""
    import tempfile
    from pathlib import Path

    names = (attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL, attention.KERNEL_STD)
    counted_cli = CountedCLI(cuda_lib, names, 14)
    per_step, losses = counted_cli.per_step, counted_cli.losses

    def cli(argv):
        launches, lines, secs = counted_cli(argv)
        policy = next(ln for ln in lines if ln.startswith("remat auto"))
        policy = "none" if policy.endswith("no remat") else policy.rsplit("remat=", 1)[1]
        return launches, policy, secs

    def eval_metrics(name):
        recs = [json.loads(ln) for ln in open(os.path.join("logs", name, "metrics.jsonl"))]
        return {r["tag"]: r["value"] for r in recs}

    common = ["--backbone", "dinov2_vitl14", "--img_size", "896", "--n_devices", "1",
              "--batch_size", "2", "--max_people", "8", "--n_epoch", "1", "--nb_max_ckpt", "1"]
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp, counted_cli:
            os.chdir(tmp)
            write_datasets(Path(tmp))
            argv = common + ["--tp_mode", "ring", "--iter_per_epoch", "4", "--valset", "bedlam",
                             "ehf", "--val_n", "2", "2", "--name", "ring"]
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
    if not (ok and ok_s and ok_h):
        raise AssertionError("training CLI check failed")
    return ring_launches


def reference_state_dict(cfg, seed=0):
    """A seeded state dict in the reference ``multiHMR_*.pt`` layout, from the
    port's ``expected_reference_shapes``: unit normals scaled by fan_in^-0.5,
    LayerNorms at 1 and 0, LayerScale LAYERSCALE (so the blocks move the
    stream), a 37 x 37 DINOv2 pos-embed grid (resampled by the converter),
    the score head's output bias at 0 (a drawn one can put every patch
    below the detection threshold), and the head's depth output pinned to
    1.5 (every person about 5 m away, so the synthetic bodies stand in front
    of the camera)."""
    from multihmr_tpu_torch.io.checkpoint import expected_reference_shapes

    g = torch.Generator().manual_seed(seed)
    wild = {"backbone.encoder.pos_embed": 1 + 37 * 37,
            "x_attention_head.transformer.pos_embedding": 1}
    sd = {}
    for k, shape in sorted(expected_reference_shapes(cfg).items()):
        shape = [wild[k] if d is None else d for d in shape]
        if ".norm" in k or "norm1" in k or "norm2" in k:
            t = torch.ones(shape) if k.endswith("weight") else torch.zeros(shape)
        elif k.endswith("gamma"):
            t = torch.full(shape, LAYERSCALE)
        else:
            t = torch.randn(shape, generator=g)
            if k.endswith("weight") and len(shape) >= 2:
                t /= float(np.prod(shape[1:])) ** 0.5
        sd[k] = t
    sd["mlp_classif.2.bias"].zero_()
    sd["x_attention_head.deccam.weight"][0] = 0.0
    sd["x_attention_head.deccam.bias"][0] = 0.0
    sd["x_attention_head.init_cam"][0, 0] = 1.5
    return sd


def write_reference_ckpt(path, name, seed=0):
    """torch.save of a reference-layout checkpoint for ``name`` with its
    ``args`` namespace; returns (bytes, seconds)."""
    import argparse

    from multihmr_tpu_torch.config import named_config

    cfg = named_config(name)
    t0 = time.perf_counter()
    args = argparse.Namespace(backbone=cfg.backbone, img_size=[cfg.img_size])
    torch.save({"model_state_dict": reference_state_dict(cfg, seed), "args": args}, path)
    return os.path.getsize(path), time.perf_counter() - t0


def run_reference_ckpt(build_model, named_config, demo, cast_backbone_bf16, cuda_lib, attention,
                       norm, card, tmp):
    """Reference-layout multiHMR_672_S and multiHMR_896_L files: 672_S fp32
    card against CPU on both streams; 896_L through the demo's ``--ckpt``
    (heads) and its per-image body (ring), three images each. Returns the
    two paths and the figures for the end lines."""
    import contextlib
    import io

    from multihmr_tpu_torch.io.checkpoint import convert_reference_checkpoint

    paths, figures = {}, {}
    for name in ("multiHMR_672_S", "multiHMR_896_L"):
        paths[name] = os.path.join(tmp, f"{name}.pt")
        nbytes, secs = write_reference_ckpt(paths[name], name)
        t0 = time.perf_counter()
        ckpt = torch.load(paths[name], map_location="cpu", weights_only=False)
        t_load = time.perf_counter() - t0
        convert_reference_checkpoint(ckpt, named_config(name))
        t_conv = time.perf_counter() - t0 - t_load
        del ckpt
        figures[name] = (nbytes, t_load, t_conv)
        log(15, f"{name} reference checkpoint: {nbytes / 2**20:.1f} MiB written in {secs:.2f} s; "
                f"torch.load {t_load:.2f} s, convert {t_conv:.2f} s (host) [{card}]")

    cfg = dataclasses.replace(named_config("multiHMR_672_S"), compute_dtype="float32")
    img = synthetic_image(7, 480, 640)
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    ok = True
    for tp_mode in ("heads", "ring"):
        outs = {}
        for dev in ("cpu", "cuda"):
            model = build_model("multiHMR_672_S", device=dev, cfg=cfg, tp_mode=tp_mode,
                                checkpoint=paths["multiHMR_672_S"])
            cuda_lib.reset_launches()  # this path's run starts here
            outs[dev] = demo.predict(model, img)
            torch.cuda.synchronize()
            counts = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
        a, b = outs["cpu"], outs["cuda"]
        same_det = all(torch.equal(getattr(a["det"], f), getattr(b["det"], f).cpu())
                       for f in ("rows", "cols", "valid"))
        errs = {k: rel_err(a[k], b[k]) for k in ("scores", "loc", "dist", "rotvec", "v3d", "j2d")}
        ok_s = (same_det and max(errs.values()) <= E2E_TOL and counts == E2E_LAUNCHES[tp_mode]
                and int(b["det"].valid.sum()) > 0)
        log(15, f"672_S fp32 from the reference file ({tp_mode}), card vs CPU: detections "
                f"{'equal' if same_det else 'DIFFER'} ({int(b['det'].valid.sum())} persons), "
                "rel errs " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tol {E2E_TOL:g}); card launches K1/K2/K5 {counts} {'ok' if ok_s else 'FAIL'}")
        ok = ok and ok_s

    img_dir = os.path.join(tmp, "demo_in")
    os.makedirs(img_dir)
    from PIL import Image

    for i, (h, w) in enumerate([(480, 640), (800, 450), (896, 896)]):
        Image.fromarray(synthetic_image(i, h, w)).save(os.path.join(img_dir, f"im{i}.png"))
    # heads: the demo CLI itself, each image's launches counted around the
    # call that enqueues its forward (its meshes checked after the run, not
    # to sync inside the demo's pipeline)
    per_image, v3ds, start_image = [], [], demo.start_image

    def counted(model, *args, **kwargs):
        before = dict(cuda_lib.LAUNCHES)
        out, pending = start_image(model, *args, **kwargs)
        per_image.append(tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names))
        v3ds.append(out["v3d"])
        return out, pending

    buf = io.StringIO()
    demo.start_image = counted
    cuda_lib.reset_launches()  # the demo's run starts here
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            demo.main(["--img_folder", img_dir, "--out_folder", os.path.join(tmp, "demo_out"),
                       "--model_name", "multiHMR_896_L", "--ckpt", paths["multiHMR_896_L"],
                       "--save_mesh", "1"])
    finally:
        demo.start_image = start_image
    secs = time.perf_counter() - t0
    whole = {k: cuda_lib.LAUNCHES[k] for k in names}  # read just after it
    per_image = [(c, bool(torch.isfinite(v).all()), tuple(v.shape))
                 for c, v in zip(per_image, v3ds)]
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(15, "  " + line)
    summary = json.loads(lines[-1])
    ok_h = (len(per_image) == 3 and not any("WARNING" in ln for ln in lines)
            and all(c == (24, 48, 0) and fin and shp == (1, 16, 10475, 3)
                    for c, fin, shp in per_image))
    log(15, f"896_L bf16 demo --ckpt (heads), {secs:.1f} s with the load: per image "
            f"K1/K2/K5 launches, finite, v3d shape {per_image}; whole run {whole}; p50 "
            f"{summary['p50_image_ms']:.1f} ms per image [{card}] {'ok' if ok_h else 'FAIL'}")
    figures["demo_p50_ms"] = summary["p50_image_ms"]
    # ring: the demo's per-image body on a model built from the same file
    model = build_model("multiHMR_896_L", device="cuda", tp_mode="ring",
                        checkpoint=paths["multiHMR_896_L"])
    cast_backbone_bf16(model.net)
    ok_r = True
    cuda_lib.reset_launches()  # the ring run starts here
    for i in range(3):
        img = np.asarray(Image.open(os.path.join(img_dir, f"im{i}.png")).convert("RGB"))
        before = dict(cuda_lib.LAUNCHES)
        out, persons = demo.run_image(model, img, f"im{i}", os.path.join(tmp, "demo_out"),
                                      "ring")
        c = tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names)
        fin = bool(torch.isfinite(out["v3d"]).all())
        ok_i = c == (0, 0, 24) and fin and len(persons) > 0
        log(15, f"896_L bf16 ring image {i}: {len(persons)} persons, finite={fin}, launches "
                f"K1/K2/K5 {c} {'ok' if ok_i else 'FAIL'}")
        ok_r = ok_r and ok_i
    del model
    torch.cuda.empty_cache()
    if not (ok and ok_h and ok_r):
        raise AssertionError("reference checkpoint check failed")
    return paths, figures


def write_smpl_pkl(path, arrays, flip_shape=False):
    """A synthetic SMPL in the official pkl layout (posedirs [V, 3, 207], a
    scipy-sparse J_regressor, the root's parent as uint32 max)."""
    import pickle

    import scipy.sparse

    V = arrays["v_template"].shape[0]
    parents = arrays["parents"].astype(np.int64) % 2 ** 32
    data = {"v_template": arrays["v_template"],
            "shapedirs": -arrays["shapedirs"] if flip_shape else arrays["shapedirs"],
            "posedirs": arrays["posedirs"].T.reshape(V, 3, -1),
            "J_regressor": scipy.sparse.csc_matrix(arrays["J_regressor"]),
            "weights": arrays["lbs_weights"],
            "kintree_table": np.stack([parents, np.arange(len(parents))]).astype(np.uint32),
            "f": arrays["faces"].astype(np.uint32)}
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)


def write_3dpw_assets(smplx_dir, seed=0):
    """$SMPLX_DIR in the reference layout: synthetic SMPL_{MALE,FEMALE}.pkl
    (6,890 vertices, 24 joints), a sparse smplx2smpl [6890, 10475] (three
    SMPL-X vertices per SMPL vertex) and J_regressor_h36m [17, 6890]. Returns
    the SMPL arrays."""
    import pickle

    import scipy.sparse

    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(smplx_dir, "smpl"))
    os.makedirs(os.path.join(smplx_dir, "smplx"))
    smpl = synthetic_body_model(num_vertices=6890, num_joints=24, num_extra=0, num_lmk=0)
    write_smpl_pkl(os.path.join(smplx_dir, "smpl", "SMPL_MALE.pkl"), smpl)
    write_smpl_pkl(os.path.join(smplx_dir, "smpl", "SMPL_FEMALE.pkl"), smpl, flip_shape=True)
    w = rng.random((6890, 3))
    m = scipy.sparse.csr_matrix((
        (w / w.sum(1, keepdims=True)).ravel(),
        (np.repeat(np.arange(6890), 3), rng.integers(0, 10475, size=6890 * 3))),
        shape=(6890, 10475))
    with open(os.path.join(smplx_dir, "smplx", "smplx2smpl.pkl"), "wb") as f:
        pickle.dump({"matrix": m}, f, protocol=2)
    jr = rng.random((17, 6890))
    np.save(os.path.join(smplx_dir, "smpl", "J_regressor_h36m.npy"),
            (jr / jr.sum(1, keepdims=True)).astype(np.float32))
    return smpl


THREEDPW_FRAMES = 3


def write_3dpw_tree(meta):
    """data/3DPW: one test sequence of portrait 1080 x 1920 JPEG frames."""
    import pickle

    from PIL import Image

    root = os.path.join("data", "3DPW")
    os.makedirs(os.path.join(root, "sequenceFiles", "test"), exist_ok=True)
    os.makedirs(os.path.join(root, "imageFiles", "seq0"), exist_ok=True)
    with open(os.path.join(root, "sequenceFiles", "test", "seq0.pkl"), "wb") as f:
        pickle.dump(meta, f, protocol=2)
    for k in range(THREEDPW_FRAMES):
        path = os.path.join(root, "imageFiles", "seq0", f"image_{k:05d}.jpg")
        if not os.path.exists(path):
            Image.fromarray(synthetic_image(400 + k, 1920, 1080)).save(path, quality=90)


def self_consistent_3dpw(model, smpl):
    """Write the 3DPW tree with two persons (male, female) per frame whose GT
    is the model's own first two predictions: their first 24 rotations, zero
    shape, the translation that puts the SMPL pelvis on the predicted one;
    evaluating the same model must then find every GT person."""
    from multihmr_tpu_torch.data.threedpw import THREEDPW

    T = THREEDPW_FRAMES
    meta = {"poses": [np.zeros((T, 72), np.float32) for _ in range(2)],
            "trans": [np.tile(np.float32([0, 0, 5]), (T, 1)) for _ in range(2)],
            "betas": [np.zeros(10, np.float32) for _ in range(2)],
            "genders": ["m", "f"], "campose_valid": [np.ones(T)] * 2,
            "cam_poses": np.tile(np.eye(4), (T, 1, 1)),
            "cam_intrinsics": np.array([[1960.0, 0, 540], [0, 1960, 960], [0, 0, 1]])}
    write_3dpw_tree(meta)
    ds = THREEDPW(img_size=model.cfg.img_size, annotations_dir="scratch",
                  smpl_dir=os.environ["SMPLX_DIR"], force_build_dataset=True)
    pelvis_rest = smpl["J_regressor"][0] @ smpl["v_template"]
    for k in range(T):
        x, annot = ds[k]
        with torch.inference_mode():
            out = model.forward(torch.from_numpy(x[None]).cuda(),
                                torch.from_numpy(annot["K"][None]).cuda(), det_thresh=0.2)
        persons = model.extract_persons(out, fields=["rotvec", "transl_pelvis"])[0]
        if len(persons) < 2:
            raise AssertionError(f"3DPW frame {k}: {len(persons)} persons predicted, need 2")
        for i in range(2):
            meta["poses"][i][k] = persons[i]["rotvec"][:24].reshape(72)
            meta["trans"][i][k] = persons[i]["transl_pelvis"].reshape(3) - pelvis_rest
    write_3dpw_tree(meta)
    if os.path.exists(os.path.join("data", "3dpw_test.pkl")):
        os.remove(os.path.join("data", "3dpw_test.pkl"))  # the CLI rebuilds the annotations


def run_3dpw_cli(build_model, cuda_lib, attention, norm, card, ckpts):
    """The training CLI's 3DPW evaluation from reference checkpoints, in a
    temporary directory with a seeded 3DPW tree and $SMPLX_DIR: 896_L bf16
    ``--tp_mode ring``; 672_S fp32 on the card and on the CPU; then two
    896_L training steps from the same ``--pretrained`` with the epoch-end
    3DPW evaluation of one image."""
    import ast
    import tempfile
    from pathlib import Path

    from multihmr_tpu_torch.config import ModelConfig

    names = (attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL, attention.KERNEL_STD)
    counted_cli = CountedCLI(cuda_lib, names, 16)
    per_step, losses = counted_cli.per_step, counted_cli.losses

    def cli(argv):
        launches, lines, secs = counted_cli(argv)
        res = next(ast.literal_eval(ln.split(": ", 1)[1]) for ln in lines
                   if ln.startswith("eval[3dpw-test]"))
        return launches, res, secs

    metric_keys = ("pve", "pa_pve", "mpjpe", "pa_mpjpe")
    s_flags = ["--backbone", "dinov2_vits14", "--img_size", "672", "--amp", "0", "--n_devices",
               "1", "--max_people", "8", "--eval_only", "1", "--valset", "3dpw", "--tp_mode",
               "ring", "--pretrained", ckpts["multiHMR_672_S"]]
    l_flags = ["--backbone", "dinov2_vitl14", "--img_size", "896", "--n_devices", "1",
               "--max_people", "8", "--valset", "3dpw", "--tp_mode", "ring",
               "--pretrained", ckpts["multiHMR_896_L"]]
    cwd, env = os.getcwd(), os.environ.get("SMPLX_DIR")
    try:
        with tempfile.TemporaryDirectory() as tmp, counted_cli:
            os.chdir(tmp)
            os.environ["SMPLX_DIR"] = os.path.join(tmp, "models")
            smpl = write_3dpw_assets(os.environ["SMPLX_DIR"])
            # 896_L bf16, the CLI's configuration, GT from its own predictions
            cfg = ModelConfig(backbone="dinov2_vitl14", img_size=896, max_people=8)
            model = build_model(device="cuda", cfg=cfg, tp_mode="ring",
                                checkpoint=ckpts["multiHMR_896_L"])
            self_consistent_3dpw(model, smpl)
            del model
            launches, res, secs = cli(l_flags + ["--eval_only", "1", "--name", "l"])
            ok = (launches == {attention.KERNEL: 0, attention.KERNEL_BWD: 0, norm.KERNEL: 0,
                               attention.KERNEL_STD: 24 * THREEDPW_FRAMES}
                  and all(np.isfinite(res[k]) for k in metric_keys)
                  and res["recall"] == 100.0 and res["n_images"] == THREEDPW_FRAMES)
            log(16, f"896_L bf16 ring 3DPW eval of {res['n_images']} frames from the reference "
                    f"file ({secs:.1f} s with the load): "
                    + ", ".join(f"{k} {res[k]:.4g}" for k in metric_keys + ("recall",))
                    + f"; timings {res['timings']}; launches {launches} (want 24 K5 per "
                    f"image) [{card}] {'ok' if ok else 'FAIL'}")
            # 672_S fp32: GT from its own predictions, then the card against the CPU
            cfg = ModelConfig(backbone="dinov2_vits14", img_size=672, max_people=8,
                              compute_dtype="float32")
            model = build_model(device="cuda", cfg=cfg, tp_mode="ring",
                                checkpoint=ckpts["multiHMR_672_S"])
            self_consistent_3dpw(model, smpl)
            del model
            runs = {dev: cli(s_flags + ["--device", dev, "--name", f"s_{dev}"])
                    for dev in ("cuda", "cpu")}
            a, b = runs["cpu"][1], runs["cuda"][1]
            errs = {k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-12) for k in metric_keys}
            ok_s = (max(errs.values()) <= E2E_TOL and all(np.isfinite(b[k]) for k in metric_keys)
                    and all(a[k] == b[k] for k in ("precision", "recall", "f1_score"))
                    and b["recall"] == 100.0
                    and runs["cuda"][0][attention.KERNEL_STD] == 12 * THREEDPW_FRAMES)
            log(16, "672_S fp32 ring 3DPW eval, card vs CPU: "
                    + ", ".join(f"{k} {b[k]:.6g} vs {a[k]:.6g} (rel {errs[k]:.1e})"
                                for k in metric_keys)
                    + f" (tol {E2E_TOL:g}); recall {b['recall']} vs {a['recall']}; card K5 "
                    f"launches {runs['cuda'][0][attention.KERNEL_STD]} "
                    f"{'ok' if ok_s else 'FAIL'}")
            # two 896_L training steps from the same reference file
            write_datasets(Path(tmp))
            launches, res, secs = cli(l_flags + ["--batch_size", "2", "--iter_per_epoch", "2",
                                                 "--n_epoch", "1", "--val_n", "1",
                                                 "--nb_max_ckpt", "1", "--name", "t"])
            ok_t = (len(per_step) == 2 and all(c[1] == 24 for c in per_step)
                    and all(np.isfinite(t) and f == 1.0 for t, f in losses)
                    and all(np.isfinite(res[k]) for k in metric_keys))
            log(16, f"896_L ring training from the reference file ({secs:.1f} s): losses "
                    + ", ".join(f"{t:.3f}" for t, _ in losses)
                    + f"; launches per step K1/K3/K2/K5 {per_step} (want 24 K3); epoch-end "
                    f"3DPW pve {res['pve']:.4g} {'ok' if ok_t else 'FAIL'}")
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("SMPLX_DIR", None)
        else:
            os.environ["SMPLX_DIR"] = env
    if not (ok and ok_s and ok_t):
        raise AssertionError("3DPW CLI check failed")


# ---- phase 17: the Anny family ----

ANNY = "multiHMR_672_L_anny"
ANNY_VERTICES = 10475  # a synthetic mesh of a real body model's size (SMPL-X's)
ANNY_OUT = ("scores", "K_regressed", "fov_regressed", "loc", "dist", "shape", "rotmat",
            "rotvec", "transl", "v3d", "j3d", "j2d", "blendshape_coeffs")
# forward launches (K1, K2, K5) per image of the Anny ViT-L per stream, at
# its 24 blocks and at the 4 that the card-vs-CPU check keeps
ANNY_LAUNCHES = {"heads": (24, 48, 0), "ring": (0, 0, 24)}
ANNY_LAUNCHES_4 = {"heads": (4, 8, 0), "ring": (0, 0, 4)}


def anny_reference_shapes(cfg) -> dict:
    """The torch-side shape of every key of a reference ``multiHMR_*_anny.pt``
    (``expected_reference_keys_anny``), with a 37 x 37 DINOv2 pos-embed grid:
    this script's copy of tests/test_anny_checkpoint.py's
    ``make_anny_state_dict`` layout."""
    D, X, J = cfg.vit.embed_dim, cfg.xat_dim, cfg.n_joints
    H = int(D * cfg.vit.mlp_ratio)
    inner = cfg.xat_heads * cfg.xat_dim_head
    bb = "encoder.backbone."
    shapes = {bb + "patch_embed.proj.weight": (D, 3, 14, 14), bb + "patch_embed.proj.bias": (D,),
              bb + "cls_token": (1, 1, D), bb + "pos_embed": (1, 1 + 37 * 37, D),
              bb + "norm.weight": (D,), bb + "norm.bias": (D,)}
    for i in range(cfg.vit.depth):
        b = f"{bb}blocks.{i}."
        shapes.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,),
                       b + "attn.qkv.weight": (3 * D, D), b + "attn.qkv.bias": (3 * D,),
                       b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                       b + "ls1.gamma": (D,), b + "ls2.gamma": (D,),
                       b + "norm2.weight": (D,), b + "norm2.bias": (D,),
                       b + "mlp.fc1.weight": (H, D), b + "mlp.fc1.bias": (H,),
                       b + "mlp.fc2.weight": (D, H), b + "mlp.fc2.bias": (D,)})
    for mlp, fan_in, hidden, od in [
        ("encoder.mlp_det", D, D, 1), ("encoder.mlp_fov_unique", D, D, 1),
        ("mlp_offset", X, X, 2), ("mlp_shape", X, X, cfg.num_betas), ("mlp_dist", X, X, 1),
        ("mlp_pose", X + J * 6, X, J * 6),
    ]:
        shapes.update({f"{mlp}.0.weight": (hidden, fan_in), f"{mlp}.0.bias": (hidden,),
                       f"{mlp}.2.weight": (od, hidden), f"{mlp}.2.bias": (od,)})
    shapes.update({"dec_to_token.weight": (X, D), "dec_to_token.bias": (X,),
                   "dec_pos_emb": (cfg.grid_size ** 2, X), "init_body_pose": (1, J * 6)})
    for i in range(cfg.xat_depth):
        layer = f"decoder.transformer.layers.{i}."
        for j in (0, 1, 2):
            shapes.update({layer + f"{j}.norm.weight": (X,), layer + f"{j}.norm.bias": (X,)})
        shapes.update({
            layer + "0.fn.to_qkv.weight": (3 * inner, X),
            layer + "0.fn.to_out.0.weight": (X, inner), layer + "0.fn.to_out.0.bias": (X,),
            layer + "1.fn.to_kv.weight": (2 * inner, X), layer + "1.fn.to_q.weight": (inner, X),
            layer + "1.fn.to_out.0.weight": (X, inner), layer + "1.fn.to_out.0.bias": (X,),
            layer + "2.fn.net.0.weight": (cfg.xat_mlp_dim, X),
            layer + "2.fn.net.0.bias": (cfg.xat_mlp_dim,),
            layer + "2.fn.net.3.weight": (X, cfg.xat_mlp_dim), layer + "2.fn.net.3.bias": (X,)})
    return shapes


def anny_reference_state_dict(cfg, seed=0):
    """A seeded state dict in the reference Anny layout: unit normals scaled
    by fan_in^-0.5, LayerNorms at 1 and 0, LayerScale LAYERSCALE, the 2D
    sincos decoder embedding, and a random ``init_body_pose``; the detection
    head's output bias at 0 (so that persons are detected) and the distance
    head's at log(focal / 4 m) for the demo's FOV-60 focal, its weight scaled
    by 0.3 (persons a few metres away, at several depths); plus a
    ``body_model.*`` buffer and ``useful_rotmat``, which the converter skips."""
    from multihmr_tpu_torch.io.checkpoint import expected_reference_keys_anny
    from multihmr_tpu_torch.ops.camera import get_focal_length_from_fov
    from multihmr_tpu_torch.ops.posenc import get_2d_sincos_pos_embed

    shapes = anny_reference_shapes(cfg)
    if set(shapes) != expected_reference_keys_anny(cfg):
        raise AssertionError("the Anny reference layout differs from expected_reference_keys_anny")
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in sorted(shapes.items()):
        if ".norm" in k or "norm1" in k or "norm2" in k:
            t = torch.ones(shape) if k.endswith("weight") else torch.zeros(shape)
        elif k.endswith("gamma"):
            t = torch.full(shape, LAYERSCALE)
        elif k == "dec_pos_emb":
            t = torch.from_numpy(get_2d_sincos_pos_embed(cfg.xat_dim, cfg.grid_size)).float()
        else:
            t = torch.randn(shape, generator=g)
            if k.endswith("weight") and len(shape) >= 2:
                t /= float(np.prod(shape[1:])) ** 0.5
        sd[k] = t
    sd["encoder.mlp_det.2.bias"].zero_()
    sd["mlp_dist.2.weight"] *= 0.3
    sd["mlp_dist.2.bias"].fill_(float(np.log(get_focal_length_from_fov(60, cfg.img_size) / 4.0)))
    sd["body_model.template"] = torch.zeros(3)
    sd["useful_rotmat"] = torch.ones(1, cfg.n_joints)
    return sd


def anny_cfg_4(anny_config):
    """The Anny configuration in fp32 with the ViT cut to 4 of its 24 blocks,
    LayerScale LAYERSCALE."""
    cfg = anny_config(ANNY)
    return dataclasses.replace(cfg, compute_dtype="float32", vit_override=dataclasses.replace(
        cfg.vit, depth=4, layerscale_init=LAYERSCALE))


def check_anny_e2e(build_model, anny_config, demo, cuda_lib, attention, norm,
                   devices=("cpu", "cuda")):
    """(a) multiHMR_672_L_anny in fp32, 4 ViT blocks, seeded weights: the
    card against the CPU on both streams, with the demo's K."""
    cfg = anny_cfg_4(anny_config)
    img = synthetic_image(7, 480, 640)
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    ok = True
    for tp_mode in ("heads", "ring"):
        outs = {}
        for dev in devices:
            model = build_model(ANNY, device=dev, seed=0, cfg=cfg, tp_mode=tp_mode)
            cuda_lib.reset_launches()  # this path's run starts here
            t0 = time.perf_counter()
            outs[dev] = demo.predict(model, img)
            torch.cuda.synchronize()
            counts = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
            log(17, f"672_L_anny fp32 forward ({tp_mode}, 4 blocks) on {dev}: "
                    f"{time.perf_counter() - t0:.2f} s")
        a, b = (outs[d] for d in devices)
        same_det = all(torch.equal(getattr(a["det"], f), getattr(b["det"], f).cpu())
                       for f in ("rows", "cols", "valid"))
        errs = {k: rel_err(a[k], b[k]) for k in ANNY_OUT}
        n = int(b["det"].valid.sum())
        ok_s = (same_det and n > 0 and max(errs.values()) <= E2E_TOL
                and counts == ANNY_LAUNCHES_4[tp_mode])
        log(17, f"672_L_anny fp32 ({tp_mode}) card vs CPU: detections "
                f"{'equal' if same_det else 'DIFFER'} ({n} persons), rel errs "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tol {E2E_TOL:g}); card launches K1/K2/K5 {counts} {'ok' if ok_s else 'FAIL'}")
        ok = ok and ok_s
    if not ok:
        raise AssertionError("672_L_anny on the card disagrees with the CPU")


def run_anny_demo(demo, factory, cuda_lib, attention, norm, card, path, tmp):
    """(b) ``cli/demo.py --model_name multiHMR_672_L_anny --ckpt <path>`` on
    three images per stream (ring: the factory's ``build_model`` with
    ``tp_mode="ring"``), overlays included: per image launches, finite
    meshes, persons sorted near to far. Returns the demo's p50 ms per image
    per stream."""
    import contextlib
    import functools
    import io

    from PIL import Image

    img_dir = os.path.join(tmp, "anny_in")
    os.makedirs(img_dir)
    for i, (h, w) in enumerate([(480, 640), (800, 450), (672, 672)]):
        Image.fromarray(synthetic_image(10 + i, h, w)).save(os.path.join(img_dir, f"im{i}.png"))
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    slots = factory.anny_config(ANNY).max_people
    build, start_image, finish_image = factory.build_model, demo.start_image, demo.finish_image
    p50, ok = {}, True
    for tp_mode in ("heads", "ring"):
        launched, v3ds, found = [], [], []

        def counted(model, *args, **kwargs):
            before = dict(cuda_lib.LAUNCHES)
            out, pending = start_image(model, *args, **kwargs)
            launched.append(tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names))
            v3ds.append(out["v3d"])
            return out, pending

        def finished(*args, **kwargs):
            persons = finish_image(*args, **kwargs)
            depths = [float(p["transl"][2]) for p in persons]
            found.append((len(persons), depths == sorted(depths)))
            return persons

        buf = io.StringIO()
        demo.start_image, demo.finish_image = counted, finished
        factory.build_model = functools.partial(build, tp_mode=tp_mode)
        cuda_lib.reset_launches()  # the demo's run starts here
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                demo.main(["--img_folder", img_dir, "--out_folder",
                           os.path.join(tmp, f"anny_out_{tp_mode}"), "--model_name", ANNY,
                           "--ckpt", path, "--save_mesh", "1"])
        finally:
            demo.start_image, demo.finish_image = start_image, finish_image
            factory.build_model = build
        secs = time.perf_counter() - t0
        whole = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
        per_image = [(c, bool(torch.isfinite(v).all()), tuple(v.shape)) + f
                     for c, v, f in zip(launched, v3ds, found)]
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(17, "  " + line)
        p50[tp_mode] = json.loads(lines[-1])["p50_image_ms"]
        ok_t = (len(per_image) == 3 and not any("WARNING" in ln for ln in lines)
                and all(c == ANNY_LAUNCHES[tp_mode] and fin
                        and shp == (1, slots, ANNY_VERTICES, 3) and n > 0 and srt
                        for c, fin, shp, n, srt in per_image))
        log(17, f"672_L_anny bf16 demo --ckpt ({tp_mode}), {secs:.1f} s with the load: per image "
                f"(K1/K2/K5 launches, finite, v3d shape, persons, sorted near to far) "
                f"{per_image}; whole run K1/K2/K5 {whole}; p50 {p50[tp_mode]:.1f} ms per "
                f"image [{card}] {'ok' if ok_t else 'FAIL'}")
        ok = ok and ok_t
    if not ok:
        raise AssertionError("672_L_anny demo check failed")
    return p50


def check_anny_streams(build_model, cast_backbone_bf16, cfg, ckpt, x):
    """(c) the file's weights in bf16: final-norm patch tokens of ring
    against heads and each against the fp32 heads stream. Returns the two
    bf16 models."""
    control = build_model(ANNY, device="cuda", cfg=dataclasses.replace(
        cfg, compute_dtype="float32"), tp_mode="heads", checkpoint=ckpt)
    with torch.inference_mode():
        tok = {"fp32": control.net.encoder.backbone(x)["patch_tokens"].float()}
    del control
    models = {}
    for tp_mode in ("heads", "ring"):
        models[tp_mode] = build_model(ANNY, device="cuda", cfg=cfg, tp_mode=tp_mode,
                                      checkpoint=ckpt)
        cast_backbone_bf16(models[tp_mode].net)
        with torch.inference_mode():
            tok[tp_mode] = models[tp_mode].net.encoder.backbone(x)["patch_tokens"].float()
    rel = lambda a, b: ((tok[a] - tok[b]).norm() / tok[b].norm()).item()  # noqa: E731
    errs = {"ring vs heads": rel("ring", "heads"), "ring vs fp32": rel("ring", "fp32"),
            "heads vs fp32": rel("heads", "fp32")}
    ok = (max(errs.values()) <= STREAM_TOL
          and errs["ring vs fp32"] <= STREAM_RATIO * errs["heads vs fp32"])
    log(17, f"672_L_anny bf16 patch tokens (the file's weights, LayerScale {LAYERSCALE:g}), "
            "rel L2 err " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {STREAM_TOL:g}, and ring vs fp32 <= {STREAM_RATIO:g} x heads vs fp32) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("672_L_anny ring and heads streams disagree")
    return models


def wall_ms(fn, reps=10, warmup=2):
    """Median host milliseconds of ``fn()`` ending in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_anny(models, demo, x, K, card):
    """(d) per stream: the forward's wall and device busy time (profiler),
    the body model's share of the wall, and the demo's per-image body in
    parts; the launches of one 163-bone FK
    (``bodymodel/core.py::_forward_kinematics``) at the forward's B*K slots;
    the dense product with the zero pose correctives."""
    import io

    from multihmr_tpu_torch.bodymodel import core
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.utils.profiling import busy_ms

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    figures = {}
    with torch.inference_mode():
        for tp_mode, model in models.items():
            fwd = wall_ms(lambda: model.forward(x, K))
            out = model.net(x, K)
            net = wall_ms(lambda: model.net(x, K))
            body = wall_ms(lambda: model.apply_body_model(out))
            n = 3
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    model.forward(x, K)
                torch.cuda.synchronize()
            busy = busy_ms(prof.events()) / n
            figures[tp_mode] = (fwd, busy, body)
            img = synthetic_image(0, 480, 640)
            pre = wall_ms(lambda: preprocess_array(img, model.cfg.img_size))
            pred = wall_ms(lambda: demo.predict(model, img))
            res = demo.predict(model, img)
            ext = wall_ms(lambda: model.extract_persons(res))
            persons = model.extract_persons(res)[0]
            enc = wall_ms(lambda: json.dumps({"persons": demo.persons_to_json(persons)}))
            npy = wall_ms(lambda: np.save(io.BytesIO(), np.stack([p["v3d"] for p in persons])))
            log(17, f"672_L_anny demo per-image body ({tp_mode}), 640x480, {len(persons)} "
                    f"persons: preprocess {pre:.2f} ms, predict (preprocess + forward) "
                    f"{pred:.2f} ms, extract_persons {ext:.2f} ms, persons to JSON "
                    f"{enc:.2f} ms, meshes to .npy (in memory) {npy:.2f} ms [{card}]")
            log(17, f"672_L_anny bf16 forward ({tp_mode}), batch 1: wall {fwd:.2f} ms "
                    f"(median of 10), device busy {busy:.2f} ms per forward (profiler, 3 "
                    f"forwards), net alone {net:.2f} ms, body model (apply_body_model: "
                    f"phenotypes, LBS, FK, projection) {body:.2f} ms = {100 * body / fwd:.1f} % "
                    f"of the forward's wall [{card}]")
        bm = models["heads"].body_model
        B = out["rotmat"].shape[0] * out["rotmat"].shape[1]
        rot = out["rotmat"].reshape(B, -1, 3, 3)
        joints = torch.randn((B, rot.shape[1], 3), device=x.device)
        core._forward_kinematics(rot, joints, bm.base.parents)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            core._forward_kinematics(rot, joints, bm.base.parents)
            torch.cuda.synchronize()
        launches = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        fk = wall_ms(lambda: core._forward_kinematics(rot, joints, bm.base.parents))
        posedirs = bm.base.posedirs
        pose_feature = torch.randn((B, posedirs.shape[0]), device=x.device)
        mm = cuda_ms(lambda: pose_feature @ posedirs, iters=20)
        mm_bound = bound_ms(2 * B * posedirs.numel(), 4 * (posedirs.numel() + pose_feature.numel()
                                                           + B * posedirs.shape[1]))
        log(17, f"163-bone FK (_forward_kinematics) at {B} slots: {launches} device launches "
                f"per call, wall {fk:.2f} ms; zero pose correctives [{posedirs.shape[0]}, "
                f"{posedirs.shape[1]}] fp32 ({posedirs.numel() * 4 / 1e6:.1f} MB) x [{B}, "
                f"{posedirs.shape[0]}]: {mm:.4f} ms per product, bound {mm_bound[0]:.4f} ms "
                f"({mm_bound[1]}) [{card}]")
    figures["fk"] = (launches, fk, mm)
    return figures


def run_anny(build_model, demo, cast_backbone_bf16, cuda_lib, attention, norm, card, tmp):
    """Phase 17: the Anny family with the synthetic asset at ANNY_VERTICES
    vertices, read through $ANNY_NPZ as a converted one would be."""
    import argparse

    from multihmr_tpu_torch import factory
    from multihmr_tpu_torch.bodymodel.anny import AnnyModel, save_anny_npz, synthetic_anny_model
    from multihmr_tpu_torch.io.checkpoint import convert_reference_checkpoint_anny
    from multihmr_tpu_torch.io.preprocessing import preprocess_array

    npz = os.path.join(tmp, "anny.npz")
    save_anny_npz(npz, AnnyModel.from_arrays(synthetic_anny_model(num_vertices=ANNY_VERTICES),
                                             "cpu"))
    env = os.environ.get("ANNY_NPZ")
    os.environ["ANNY_NPZ"] = npz
    try:
        try:  # (a) fails the phase at its end: (b) to (d) still run
            check_anny_e2e(build_model, factory.anny_config, demo, cuda_lib, attention, norm)
            ok_a = True
        except AssertionError:
            ok_a = False
            log(17, "FAIL\n" + traceback.format_exc())
        cfg = factory.anny_config(ANNY)
        path = os.path.join(tmp, f"{ANNY}.pt")
        t0 = time.perf_counter()
        torch.save({"model_state_dict": anny_reference_state_dict(cfg),
                    "args": argparse.Namespace(backbone=cfg.backbone, img_size=[cfg.img_size])},
                   path)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        t_load = time.perf_counter() - t0
        convert_reference_checkpoint_anny(ckpt, cfg)
        t_conv = time.perf_counter() - t0 - t_load
        nbytes = os.path.getsize(path)
        log(17, f"{ANNY} reference checkpoint: {nbytes / 2**20:.1f} MiB written in "
                f"{t_write:.2f} s; torch.load {t_load:.2f} s, convert {t_conv:.2f} s (host) "
                f"[{card}]")
        p50 = run_anny_demo(demo, factory, cuda_lib, attention, norm, card, path, tmp)
        pre = preprocess_array(synthetic_image(0, 480, 640), cfg.img_size)
        x, K = (torch.from_numpy(a)[None].cuda() for a in (pre.x, pre.K))
        models = check_anny_streams(build_model, cast_backbone_bf16, cfg, ckpt, x)
        del ckpt
        figures = time_anny(models, demo, x, K, card)
        del models
        torch.cuda.empty_cache()
    finally:
        if env is None:
            os.environ.pop("ANNY_NPZ", None)
        else:
            os.environ["ANNY_NPZ"] = env
    if not ok_a:
        raise AssertionError("phase 17 (a) failed")
    return {"file": (nbytes, t_load, t_conv), "p50": p50, **figures}


# ---- phase 18: serving multiHMR_672_B at batch 8

SERVE = "multiHMR_672_B"
SERVE_SIZES = [(480, 640), (720, 1280), (640, 480)]  # (h, w): 640x480, 1280x720, 480x640
# a served person's JSON fields against the same image alone in slot 0 of a
# batch-8 forward through the same batch_fn, relative to each field's largest
# magnitude: each slot's computation does not read the others
SERVE_TOL = 1e-5
SERVE_LAUNCHES = {"heads": (12, 24, 0), "ring": (0, 0, 12)}  # K1/K2/K5 per 672_B batch
REPO = os.path.dirname(os.path.abspath(__file__))


def jpeg_bytes(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def decode(payload: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))


def http_post(port, payload, query="", timeout=600):
    """(status, headers, body) of POST /infer{query}."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/infer{query}", data=payload,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def http_get_json(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def run_clients(port, payloads, n_threads, query=""):
    """POST every payload from ``n_threads`` client threads, all started
    together; returns ([(status, headers, body, latency s)] in order, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(p):
        t0 = time.perf_counter()
        st, h, b = http_post(port, p, query)
        return st, h, b, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(n_threads) as ex:
        res = list(ex.map(one, payloads))
    return res, time.perf_counter() - t0


class Serving:
    """A ``make_server`` on an ephemeral port (or an already built
    ``(server, batcher)``), served from a thread."""

    def __init__(self, model=None, built=None, **kw):
        from multihmr_tpu_torch.serve import make_server, serve_forever_in_thread

        self.srv, self.batcher = built if built is not None else make_server(model, port=0,
                                                                              **kw)
        self.port = self.srv.server_address[1]
        serve_forever_in_thread(self.srv)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.batcher.close()


def host_cpu() -> str:
    """The host CPU's model name (else what /proc/cpuinfo says of it) and its
    count of logical CPUs."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                k, _, v = ln.partition(":")
                fields.setdefault(k.strip().lower(), v.strip())
    except OSError:
        pass
    name = fields.get("model name") or fields.get("cpu model") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if fields.get(k))
    return f"{name or 'model not reported'} ({platform.machine()}), {os.cpu_count()} logical CPUs"


def ellipsoid_mesh(n_lat, n_lon):
    """A closed UV ellipsoid of person-like extent: (vertices, faces)."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    v = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                  np.cos(th)[:, None] * np.ones_like(ph)[None],
                  np.sin(th)[:, None] * np.sin(ph)[None]], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
    f = np.stack([np.stack([a, a + n_lon, b], -1), np.stack([b, a + n_lon, b + n_lon], -1)],
                 2).reshape(-1, 3)
    return (v * np.array([0.25, 0.8, 0.2])).astype(np.float32), f


def serve_cli(card):
    """(a) ``python -m multihmr_tpu_torch.cli.serve`` as a user starts it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_path = os.path.join(REPO, "chiprun_out", "chip_smoke", "serve_cli.log")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "multihmr_tpu_torch.cli.serve",
                                 "--model_name", SERVE, "--port", str(port)], cwd=REPO,
                                stdout=out, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                with open(out_path) as f:
                    raise AssertionError(f"cli.serve exited with {proc.returncode}:\n"
                                         + f.read()[-4000:])
            try:
                health = http_get_json(port, "/healthz")
                break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("cli.serve gave no /healthz within 300 s")
                time.sleep(0.25)
        t_up = time.perf_counter() - t0
        payloads = [jpeg_bytes(synthetic_image(40 + i, h, w))
                    for i, (h, w) in enumerate(SERVE_SIZES + SERVE_SIZES[:1])]
        res, wall = run_clients(port, payloads, 4)
        answers = [json.loads(b) if st == 200 else None for st, _, b, _ in res]
        ok = health == {"status": "ok"} and all(a is not None and "persons" in a for a in answers)
        log(18, f"(a) python -m multihmr_tpu_torch.cli.serve --model_name {SERVE}: /healthz "
                f"after {t_up:.1f} s (start, build, warm-up batch); 4 JPEGs from 4 clients: "
                f"status {[r[0] for r in res]}, persons {[a and a['count'] for a in answers]}, "
                f"{wall:.2f} s [{card}] {'ok' if ok else 'FAIL'}")
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if not ok:
        raise AssertionError("(a) cli.serve did not answer 4 requests with 200 and JSON")


def json_err(a: dict, b: dict) -> float:
    """Largest error of a JSON person against another, each field relative
    to its largest magnitude; inf when n_j2d differs."""
    if a["n_j2d"] != b["n_j2d"]:
        return float("inf")
    errs = []
    for k in ("score", "loc", "transl", "transl_pelvis"):
        va, vb = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        errs.append(np.abs(va - vb).max() / max(np.abs(va).max(), 1.0))
    return float(max(errs))


def slot0_reference(batcher, payload, S):
    """The JSON persons of one request's image alone in slot 0 of a full
    batch, through the served batch_fn and extract_fn."""
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.serve.server import _persons_json

    pre = preprocess_array(decode(payload), S)
    x = np.zeros((batcher.max_batch, S, S, 3), np.uint8)
    x[0] = pre.resized
    K = np.tile(np.eye(3, dtype=np.float32), (batcher.max_batch, 1, 1))
    K[0] = pre.K
    persons = batcher.extract_fn(batcher.batch_fn(x, K), 1)[0]
    return json.loads(_persons_json(persons))


def serve_counted(model, ring_model, cuda_lib, names, card):
    """(b) 48 requests from 12 clients through make_server: answers, batching,
    launches per batch, each result against slot 0; then a ring server."""
    images = [synthetic_image(100 + i, *SERVE_SIZES[i % 3]) for i in range(48)]
    payloads = [jpeg_bytes(img) for img in images]
    S = model.cfg.img_size
    with Serving(model, max_batch=8, max_delay_ms=5.0) as s:
        cuda_lib.reset_launches()  # the serving path's run starts here
        res, wall = run_clients(s.port, payloads, 12)
        launches = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
        snap = http_get_json(s.port, "/stats")
        answers = [json.loads(b) if st == 200 else None for st, _, b, _ in res]
        n_ok = sum(a is not None for a in answers)
        nb = snap["batches"]
        want = tuple(nb * c for c in SERVE_LAUNCHES["heads"])
        ok = (n_ok == 48 and snap["requests"] == 48 and snap["mean_batch_size"] > 1
              and launches == want)
        log(18, f"(b) {SERVE} bf16 heads, max_batch 8, max_delay_ms 5: 48 JPEGs (640x480, "
                f"1280x720, 480x640) from 12 clients: {n_ok} answered 200 in {wall:.2f} s; "
                f"/stats requests {snap['requests']}, batches {nb}, mean batch size "
                f"{snap['mean_batch_size']}, histogram {snap['batch_size_hist']}; launches "
                f"K1/K2/K5 {launches} (want {want} = {nb} x {SERVE_LAUNCHES['heads']}) "
                f"[{card}] {'ok' if ok else 'FAIL'}")
        worst, counts_equal = 0.0, True
        for payload, a in zip(payloads, answers):
            if a is None:
                continue
            ref = slot0_reference(s.batcher, payload, S)
            counts_equal = counts_equal and ref["count"] == a["count"]
            for pa, pr in zip(a["persons"], ref["persons"]):
                worst = max(worst, json_err(pr, pa))
        persons = [a["count"] for a in answers if a is not None]
        ok_ref = counts_equal and worst <= SERVE_TOL
        log(18, f"(b) each request against its image alone in slot 0 of a batch-8 forward: "
                f"counts {'equal' if counts_equal else 'DIFFER'} ({sum(persons)} persons, "
                f"{min(persons)}-{max(persons)} per image), worst field error {worst:.3e} "
                f"(tol {SERVE_TOL:g}) {'ok' if ok_ref else 'FAIL'}")
        ok = ok and ok_ref
    with Serving(ring_model, max_batch=8, max_delay_ms=5.0, json_only=True) as s:
        cuda_lib.reset_launches()  # the ring server's run starts here
        res, wall = run_clients(s.port, payloads[:16], 8)
        launches_r = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
        snap_r = http_get_json(s.port, "/stats")
        want_r = tuple(snap_r["batches"] * c for c in SERVE_LAUNCHES["ring"])
        ok_r = all(r[0] == 200 for r in res) and launches_r == want_r
        log(18, f"(b) {SERVE} bf16 ring, json_only: 16 JPEGs from 8 clients in {wall:.2f} s, "
                f"status {sorted(set(r[0] for r in res))}, batches {snap_r['batches']}, "
                f"launches K1/K2/K5 {launches_r} (want {want_r}) {'ok' if ok_r else 'FAIL'}")
    if not (ok and ok_r):
        raise AssertionError("(b) the served batches disagree")
    return payloads, {"launches": launches, "batches": nb, "ring": (launches_r,
                                                                     snap_r["batches"])}


def check_serving_shapes(attention, norm):
    """(c) K1, K2 and K5 against their plain versions at the 672_B batch-8
    shapes, under phases 3, 4 and 12's limits. Returns the max abs errors."""
    errs = {}
    q, k, v = qkv_views(2312, torch.bfloat16, heads=12, kv_len=2305, batch=8)
    out, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=2305)
    ref_out, ref_lse = attention.mha_reference_t(q, k, v, kv_len=2305)
    ok, errs["K1"], text = fwd_check(out[..., :2305], ref_out[..., :2305], lse[..., :2305],
                                     ref_lse[..., :2305])
    log(18, f"(c) K1 [8,12,64,2312] bf16 kv_len=2305: {text} {'ok' if ok else 'FAIL'}")
    del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((8, 768, 2312), device="cuda", generator=g) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(768, device="cuda", generator=g)
    bias = 0.1 * torch.randn(768, device="cuda", generator=g)
    for pair, ok_p, err, text in k2_cases(norm, x, scale, bias):
        log(18, f"(c) K2 [8,768,2312] {pair}: {text} {'ok' if ok_p else 'FAIL'}")
        ok = ok and ok_p
        if pair == "bfloat16->bfloat16":
            errs["K2"] = err
    del x
    q, k, v = std_qkv_views(2305, torch.bfloat16, heads=12, seed=2305, batch=8)
    ref = [attention.flash_fwd_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1]) for b in range(8)]
    ref_out, ref_lse = (torch.cat(parts) for parts in zip(*ref))
    del ref
    out, lse = attention._flash_fwd_std(q, k, v, out=K5_LAYOUTS["[B,N,H,64]"](8, 12, 2305,
                                                                                torch.bfloat16))
    ok_5, errs["K5"], text = fwd_check(out, ref_out, lse, ref_lse)
    log(18, f"(c) K5 [8,12,2305,64] bf16 into [B,N,H,64]: {text} {'ok' if ok_5 else 'FAIL'}")
    del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    if not (ok and ok_5):
        raise AssertionError("(c) a kernel disagrees with its plain version at a serving shape")
    return errs


def serve_render(model, payload, card):
    """(d) ?render=1 on one request: a PNG of the original size, its person
    count, and the compiled rasterizer against its plain version."""
    import io

    from PIL import Image

    from multihmr_tpu_torch.io.preprocessing import preprocess_array, rescale_K_to_original
    from multihmr_tpu_torch.render import render_meshes

    img = decode(payload)
    h, w = img.shape[:2]
    S = model.cfg.img_size
    with Serving(model, max_batch=8, max_delay_ms=5.0) as s:
        st_j, _, body_j = http_post(s.port, payload)
        t0 = time.perf_counter()
        st, headers, body = http_post(s.port, payload, "?render=1")
        t_req = time.perf_counter() - t0
        pre = preprocess_array(img, S)
        persons = s.batcher.submit(pre.resized, pre.K)
    count = json.loads(body_j)["count"] if st_j == 200 else None
    png = np.asarray(Image.open(io.BytesIO(body))) if st == 200 else None
    faces = model.body_model.faces.cpu().numpy()
    K_full = rescale_K_to_original(pre.K[None], w, h, S)[0]
    meshes = [p["v3d"] for p in persons]
    t0 = time.perf_counter()
    full = render_meshes(img, meshes, [faces] * len(meshes), K_full)
    t_all = time.perf_counter() - t0
    sub = meshes[:1]  # the numpy version takes seconds per mesh of this body model
    t0 = time.perf_counter()
    compiled = render_meshes(img, sub, [faces] * len(sub), K_full)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = render_meshes(img, sub, [faces] * len(sub), K_full, plain=True)
    t_p = time.perf_counter() - t0
    # 16 smooth meshes of SMPL-X's size (UV ellipsoids of 10,585 vertices and
    # 20,880 faces, small triangles as a body mesh has) at 2.5-8 m
    ell_v, ell_f = ellipsoid_mesh(72, 145)
    rng = np.random.default_rng(18)
    smooth = [(ell_v * rng.uniform(0.7, 1.3) + np.array(
        [rng.uniform(-1.5, 1.5), rng.uniform(-0.6, 0.6), rng.uniform(2.5, 8)])).astype(np.float32)
        for _ in range(16)]
    K_s = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    t0 = time.perf_counter()
    smooth_c = render_meshes(img, smooth, [ell_f] * 16, K_s)
    t_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    smooth_p = render_meshes(img, smooth[:2], [ell_f] * 2, K_s, plain=True)
    t_sp = time.perf_counter() - t0
    same_s = np.array_equal(render_meshes(img, smooth[:2], [ell_f] * 2, K_s), smooth_p)
    ok = (st == 200 and headers.get("Content-Type") == "image/png" and png is not None
          and png.shape == img.shape and int(headers.get("X-Person-Count", -1)) == count
          and count == len(persons) and np.array_equal(png, full) and len(sub) > 0
          and np.array_equal(compiled, plain) and same_s and (smooth_c != img).any())
    cpu = host_cpu()
    log(18, f"(d) POST /infer?render=1 {w}x{h}: status {st}, {headers.get('Content-Type')}, "
            f"PNG {None if png is None else png.shape}, X-Person-Count "
            f"{headers.get('X-Person-Count')} (JSON count {count}), {t_req * 1e3:.1f} ms; the "
            f"PNG equals the compiled render of the request's {len(persons)} meshes: "
            f"{png is not None and np.array_equal(png, full)}; compiled against plain on "
            f"{len(sub)} meshes: {'bitwise equal' if np.array_equal(compiled, plain) else 'DIFFER'}"
            f" {'ok' if ok else 'FAIL'}")
    log(18, f"(d) rasterizer at {w}x{h}, {faces.shape[0]} faces per mesh: compiled "
            f"{t_all * 1e3:.1f} ms for {len(meshes)} meshes, {t_c * 1e3:.1f} ms for "
            f"{len(sub)}; numpy _rasterize {t_p * 1e3:.1f} ms for {len(sub)} [host: {cpu}]")
    log(18, f"(d) rasterizer at {w}x{h}, 16 smooth meshes of {ell_v.shape[0]} vertices and "
            f"{ell_f.shape[0]} faces: compiled {t_s * 1e3:.1f} ms; numpy _rasterize "
            f"{t_sp * 1e3:.1f} ms for 2, {'bitwise equal' if same_s else 'DIFFER'} [host: {cpu}]"
            f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(d) ?render=1 or the rasterizer failed")
    return {"raster_ms": (t_all * 1e3, len(meshes), t_c * 1e3, t_p * 1e3, len(sub)),
            "smooth_ms": (t_s * 1e3, t_sp * 1e3), "cpu": cpu}


def serve_overload(model, payloads, card):
    """(e) a burst of 32 past max_queue 4 sheds with 429 + Retry-After; a
    1 ms deadline under load fails with 503; never a 500."""
    burst = [payloads[0]] * 32
    with Serving(model, max_batch=8, max_delay_ms=5.0, max_queue=4) as s:
        res, _ = run_clients(s.port, burst, 32)
        shed = s.batcher.stats.snapshot()["shed"]
    st = [r[0] for r in res]
    retry = [r[1].get("Retry-After") for r in res if r[0] == 429]
    ok_q = st.count(429) >= 1 and 500 not in st and all(retry) and set(st) <= {200, 429}
    log(18, f"(e) max_queue 4, a burst of 32: {st.count(200)} x 200, {st.count(429)} x 429 "
            f"(Retry-After {sorted(set(retry))}), {st.count(500)} x 500; /stats shed {shed} "
            f"{'ok' if ok_q else 'FAIL'}")
    with Serving(model, max_batch=8, max_delay_ms=5.0, deadline_s=0.001, json_only=True) as s:
        res, _ = run_clients(s.port, [payloads[0]] * 32, 16)
        shed = s.batcher.stats.snapshot()["shed"]
    st = [r[0] for r in res]
    ok_d = st.count(503) >= 1 and 500 not in st and set(st) <= {200, 503}
    log(18, f"(e) deadline_s 0.001, 32 requests from 16 clients: {st.count(200)} x 200, "
            f"{st.count(503)} x 503, {st.count(500)} x 500; /stats shed {shed} "
            f"{'ok' if ok_d else 'FAIL'}")
    if not (ok_q and ok_d):
        raise AssertionError("(e) overload did not shed with 429 and 503 alone")


def forward_alone(fn):
    """(host ms to enqueue ``fn()``, wall ms to its end on the card, device
    busy ms) of one forward, no other threads; medians after warm-up,
    busy over a profile of 3 calls."""
    from multihmr_tpu_torch.utils.profiling import busy_ms

    with torch.inference_mode():
        enqueue = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        fwd = wall_ms(fn)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
    return float(np.median(enqueue[2:])), fwd, busy_ms(prof.events()) / 3


def serve_saturation(model, payloads, card):
    """(f) 256 requests from 16 clients, per server: images/s, latency,
    batching, the worker's phases, and the card's busy share."""
    work = [payloads[i % len(payloads)] for i in range(256)]
    # one batch-8 forward alone, no HTTP threads: its host wall (enqueue
    # only, and to the end on the card) and the card's busy time
    S = model.cfg.img_size
    g = torch.Generator("cuda").manual_seed(18)
    x = torch.randn((8, S, S, 3), device="cuda", generator=g)
    K = torch.tensor([[[600.0, 0, S / 2], [0, 600.0, S / 2], [0, 0, 1]]] * 8, device="cuda")
    alone = forward_alone(lambda: model.forward(x, K))
    log(18, f"(f) {SERVE} bf16 heads forward at batch 8 alone: enqueue {alone[0]:.2f} ms "
            f"(host), wall {alone[1]:.2f} ms to the end on the card, device busy {alone[2]:.2f} "
            f"ms per forward [{card}]")
    figures = {"alone": alone}
    for label, kw, sync, profile in (("full", {}, False, False),
                                     ("json_only", {"json_only": True}, False, False),
                                     ("full, profiled", {}, False, True),
                                     ("full, readback synced in batch_fn", {}, True, False)):
        with Serving(model, max_batch=8, max_delay_ms=5.0, **kw) as s:
            if sync:
                batch_fn = s.batcher.batch_fn

                def synced(x, K, batch_fn=batch_fn):
                    pending = batch_fn(x, K)
                    pending.wait()
                    return pending

                s.batcher.batch_fn = synced
            figures[label] = saturate(s, work, profile, 18, f"(f) {SERVE} bf16 heads, {label}",
                                      card)
    if not all(f["ok"] for k, f in figures.items() if k != "alone"):
        raise AssertionError("(f) a request failed at saturation")
    return figures


def saturate(s, work, profile, phase, label, card):
    """``work`` from 16 clients against the server of ``s``: images/s,
    client latency, batching, the worker's phases and (``profile``) the
    card's busy share of the window."""
    from multihmr_tpu_torch.utils.profiling import busy_ms

    busy = None
    if profile:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            res, wall = run_clients(s.port, work, 16)
            torch.cuda.synchronize()
        busy = busy_ms(prof.events()) / (wall * 1e3)
    else:
        res, wall = run_clients(s.port, work, 16)
    st = s.batcher.stats
    lat = np.array([r[3] for r in res]) * 1e3
    snap = st.snapshot()
    f = {"img_s": len(work) / wall, "p50": float(np.percentile(lat, 50)),
         "p95": float(np.percentile(lat, 95)), "mean_batch": snap["mean_batch_size"],
         "dispatch_p50": float(np.percentile(st.dispatch_ms, 50)),
         "extract_p50": float(np.percentile(st.extract_ms, 50)),
         "server_p50": float(np.percentile(st.latencies_ms, 50)),
         "server_p95": float(np.percentile(st.latencies_ms, 95)), "busy": busy,
         "ok": all(r[0] == 200 for r in res)}
    log(phase, f"{label}: {len(work)} requests from 16 clients in {wall:.3f} s = "
               f"{f['img_s']:.2f} images/s; client latency p50 {f['p50']:.1f} / p95 "
               f"{f['p95']:.1f} ms (server p50 {f['server_p50']:.1f} / p95 "
               f"{f['server_p95']:.1f} ms); mean batch size {f['mean_batch']}, histogram "
               f"{snap['batch_size_hist']}; dispatch_ms p50 {f['dispatch_p50']:.2f}, "
               f"extract_ms p50 {f['extract_p50']:.2f}"
               + ("" if busy is None else f"; card busy {100 * busy:.1f} % of the window")
               + f" [{card}] {'ok' if f['ok'] else 'FAIL'}")
    return f


def serve_app(card, tmp):
    """(g) cli/app.build_infer on 672_S: overlay and .glb, then the cache."""
    from multihmr_tpu_torch.cli import app

    cache = os.path.join(tmp, "app_cache")
    infer, _ = app.build_infer("multiHMR_672_S", None, cache_dir=cache)
    img = synthetic_image(7, 480, 640)
    t0 = time.perf_counter()
    overlay, glb, count = infer(img)
    t1 = time.perf_counter()
    overlay2, glb2, count2 = infer(img)
    t2 = time.perf_counter()
    ok = (overlay.shape == img.shape and glb[:4] == b"glTF" and glb2 == glb and count2 == count
          and np.array_equal(overlay2, overlay) and len(os.listdir(cache)) == 2)
    log(18, f"(g) cli/app build_infer multiHMR_672_S, 640x480: {count} persons, overlay "
            f"{overlay.shape}, .glb {len(glb)} bytes, {1e3 * (t1 - t0):.1f} ms; the same image "
            f"again from the cache in {1e3 * (t2 - t1):.1f} ms [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(g) the app's overlay, .glb or cache failed")


def serve_demo(demo, cuda_lib, names, card, tmp):
    """(h) cli/demo.py with the overlays on 2 images at 896_L: every file the
    JAX demo writes, and 24 K1 + 48 K2 per image."""
    import contextlib
    import io

    from PIL import Image

    src, out = os.path.join(tmp, "overlay_in"), os.path.join(tmp, "overlay_out")
    os.makedirs(src)
    for i, (h, w) in enumerate([(480, 640), (640, 480)]):
        Image.fromarray(synthetic_image(60 + i, h, w)).save(os.path.join(src, f"im{i}.jpg"))
    buf = io.StringIO()
    cuda_lib.reset_launches()  # the demo's run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        demo.main(["--img_folder", src, "--out_folder", out, "--model_name", "multiHMR_896_L",
                   "--extra_views", "1", "--distance", "1", "--save_mesh", "1"])
    secs = time.perf_counter() - t0
    launches = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(18, "  " + line)
    ok, missing = launches == (48, 96, 0), []
    for i, (h, w) in enumerate([(480, 640), (640, 480)]):
        save_fn = os.path.join(out, f"im{i}.jpg_multiHMR_896_L.png")
        n = len(json.load(open(save_fn[:-4] + ".json"))["persons"])
        want = [save_fn, save_fn + ".npy", save_fn + ".glb"] + [
            save_fn + f".person{j}.obj" for j in range(n)]
        missing += [p for p in want if not os.path.isfile(p)]
        shape = np.asarray(Image.open(save_fn)).shape if os.path.isfile(save_fn) else None
        ok = ok and n > 0 and shape == (h, 3 * w, 3)
    ok = ok and not missing
    log(18, f"(h) cli/demo multiHMR_896_L --extra_views 1 --distance 1 --save_mesh 1, 2 "
            f"images: {secs:.1f} s with the build; launches K1/K2/K5 {launches} (want (48, 96, "
            f"0)); missing files {missing} [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(h) the demo's overlays failed")


def run_serving(build_model, demo, cast_backbone_bf16, cuda_lib, attention, norm, card, tmp):
    """Phase 18: serving multiHMR_672_B at batch 8, the renderer, the app and
    the demo's overlays. Every part runs; the phase fails at its end if any
    did."""
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    failed, figures = [], {}

    def part(tag, fn, *args):
        try:
            return fn(*args)
        except Exception:
            failed.append(tag)
            log(18, f"({tag}) FAIL\n" + traceback.format_exc())
            return None

    t0 = time.perf_counter()
    part("a", serve_cli, card)
    model = build_model(SERVE, device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    ring = build_model(SERVE, device="cuda", seed=0, tp_mode="ring")
    cast_backbone_bf16(ring.net)
    counted = part("b", serve_counted, model, ring, cuda_lib, names, card)
    del ring
    payloads = counted[0] if counted else [jpeg_bytes(synthetic_image(100 + i, *SERVE_SIZES[i % 3]))
                                           for i in range(48)]
    figures["counted"] = counted[1] if counted else None
    figures["errs"] = part("c", check_serving_shapes, attention, norm)
    figures["render"] = part("d", serve_render, model, payloads[0], card)
    part("e", serve_overload, model, payloads, card)
    figures["sat"] = part("f", serve_saturation, model, payloads, card)
    del model
    torch.cuda.empty_cache()
    part("g", serve_app, card, tmp)
    torch.cuda.empty_cache()
    part("h", serve_demo, demo, cuda_lib, names, card, tmp)
    log(18, f"phase 18 took {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"phase 18 parts failed: {failed}")
    return figures


# ---- phase 19: export (a torch.export artifact) and serving from it

# an artifact against the live forward on the same weights and inputs:
# |got - want| <= 1e-5 (1 + |want|), tests/test_export.py's rtol = atol
EXPORT_TOL = 1e-5

# a fresh process loads an artifact with the port's model code blocked and
# runs it on inputs and reference outputs read from a .pt file
FRESH_LOAD = """
import json, sys, time
for name in ("multihmr_tpu_torch.models", "multihmr_tpu_torch.factory",
             "multihmr_tpu_torch.bodymodel"):
    sys.modules[name] = None  # importing any of them now raises
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from multihmr_tpu_torch.io.export import load_exported
from multihmr_tpu_torch.ops import cuda_lib
ref = torch.load(sys.argv[2])
t0 = time.perf_counter()
loaded = load_exported(sys.argv[1], device=sys.argv[3])
t_load = time.perf_counter() - t0
out = loaded(ref["x"], ref["K"])
want = {k: v.to(loaded.device) for k, v in ref["out"].items()}
assert sorted(out) == sorted(want), sorted(out)
err = max((out[k].double() - want[k].double()).abs().max().item() for k in out)
print(json.dumps({"max_abs_diff": err, "bitwise": all(torch.equal(out[k], want[k]) for k in out),
                  "load_s": t_load, "launches": dict(cuda_lib.LAUNCHES),
                  "model_code": sorted(m for m in sys.modules if m.startswith(
                      ("multihmr_tpu_torch.models", "multihmr_tpu_torch.bodymodel"))
                      and sys.modules[m] is not None)}))
"""


def output_err(got: dict, want: dict):
    """(same keys, max abs difference, every key within EXPORT_TOL, bitwise)."""
    same = sorted(got) == sorted(want)
    err, within, bitwise = 0.0, same, same
    for k in want:
        if k not in got:
            continue
        a, b = got[k], want[k]
        bitwise = bitwise and torch.equal(a, b)
        if a.is_floating_point():
            err = max(err, (a.double() - b.double()).abs().max().item())
            within = within and torch.allclose(a, b, rtol=EXPORT_TOL, atol=EXPORT_TOL,
                                               equal_nan=True)
        else:
            within = within and torch.equal(a, b)
    return same, err, within, bitwise


def plain_graph_ops(graph, n_tok, padded):
    """(aten LayerNorm nodes, nodes whose output ends in a token-by-token
    square, ``n_tok`` or ``padded`` tokens: a plain attention's score
    matrix) in an FX graph."""
    ln = scores = 0
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        ln += "layer_norm" in str(node.target)
        val = node.meta.get("val")
        scores += (isinstance(val, torch.Tensor) and val.dim() >= 2
                   and {*val.shape[-2:]} <= {n_tok, padded})
    return ln, scores


def export_timed(model, tmp, tag, batch, name):
    """Export, save and load ``model``: (loaded, meta, dir, seconds of each)."""
    from multihmr_tpu_torch.io.export import export_program, load_exported, save_exported

    t0 = time.perf_counter()
    program, meta = export_program(model, batch_size=batch, name=name)
    t_exp = time.perf_counter() - t0
    d = os.path.join(tmp, f"export_{tag}")
    t0 = time.perf_counter()
    save_exported(program, meta, d)
    t_save = time.perf_counter() - t0
    del program
    t0 = time.perf_counter()
    loaded = load_exported(d, device="cuda")
    t_load = time.perf_counter() - t0
    return loaded, meta, d, (t_exp, t_save, t_load)


def export_672b(build_model, cast_backbone_bf16, cuda_lib, attention, names, card, tmp):
    """(a) 672_B at batch 8, bf16 backbone, on both streams: export, save and
    load seconds, the file's size, the kernel operators and no plain
    attention or block LayerNorm in the graph, every output against the live
    forward, launches per batch through the artifact."""
    from multihmr_tpu_torch.io.export import make_serving_fn

    res, ok = {}, True
    for tp in ("heads", "ring"):
        model = build_model(SERVE, device="cuda", seed=0, tp_mode=tp)
        cast_backbone_bf16(model.net)
        cfg = model.cfg
        S, depth = cfg.img_size, cfg.vit.depth
        g = torch.Generator("cuda").manual_seed(19)
        x = torch.randn((8, S, S, 3), device="cuda", generator=g)
        K = torch.tensor([[[600.0, 0, S / 2], [0, 600.0, S / 2], [0, 0, 1]]] * 8, device="cuda")
        loaded, meta, d, secs = export_timed(model, tmp, tp, 8, SERVE)
        counts = tuple(meta["kernel_ops"].values())  # K1, K2, K5
        n_tok = 1 + cfg.grid_size ** 2
        ln, scores = plain_graph_ops(loaded.program.graph, n_tok, attention.padded_len(n_tok))
        with torch.inference_mode():
            want = make_serving_fn(model)(x, K)
        cuda_lib.reset_launches()  # the artifact's batch starts here
        got = loaded(x, K)
        torch.cuda.synchronize()
        launches = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
        same, err, within, bitwise = output_err(got, want)
        want_ops = (depth, 2 * depth, 0) if tp == "heads" else (0, 0, depth)
        ok_tp = (same and within and counts == want_ops and scores == 0
                 and launches == SERVE_LAUNCHES[tp])
        mib = os.path.getsize(os.path.join(d, "model.pt2")) / 2**20
        held = (device_mib([*loaded.program.state_dict.values(),
                            *loaded.program.constants.values()]),
                device_mib([*model.net.state_dict().values(), *vars(model.body_model).values()]))
        log(19, f"(a) {tp}: device tensors held, artifact {held[0]:.1f} MiB (weights and "
                f"constants), live model {held[1]:.1f} MiB (net and body model)")
        log(19, f"(a) {SERVE} bf16 {tp}, batch 8: export {secs[0]:.2f} s, save {secs[1]:.2f} s, "
                f"load {secs[2]:.2f} s, model.pt2 {mib:.1f} MiB; graph K1/K2/K5 operators "
                f"{counts} (want {want_ops}), aten LayerNorms {ln}, score matrices {scores}; "
                f"{len(got)} outputs against the live forward: max |diff| {err:.3e} (tol "
                f"{EXPORT_TOL:g}), {'bitwise' if bitwise else 'not bitwise'}; launches K1/K2/K5 "
                f"{launches} (want {SERVE_LAUNCHES[tp]}) [{card}] {'ok' if ok_tp else 'FAIL'}")
        res[tp] = {"secs": secs, "mib": mib, "err": err, "bitwise": bitwise, "ln": ln,
                   "launches": launches, "dir": d, "depth": depth, "held": held}
        ok = ok and ok_tp
        if tp == "heads":
            res["live"] = (model, loaded, x, K, want)
        del model, loaded, got
        torch.cuda.empty_cache()
    # the standard stream's block LayerNorms are plain by design (K5 only):
    # the channels-major graph has 2 x depth fewer, each one a K2
    depth = res["heads"]["depth"]
    ok_ln = res["ring"]["ln"] - res["heads"]["ln"] == 2 * depth
    log(19, f"(a) aten LayerNorms ring {res['ring']['ln']} - heads {res['heads']['ln']} = "
            f"{res['ring']['ln'] - res['heads']['ln']} (want {2 * depth}: the blocks' two "
            f"each, K2 on heads) {'ok' if ok_ln else 'FAIL'}")
    if not (ok and ok_ln):
        raise AssertionError("(a) an artifact disagrees with the live model or its graph")
    return res


def export_fresh_process(d, x, K, want, cuda_lib, names, card, tmp):
    """(b) a fresh python3 process loads the heads artifact with the port's
    models, factory and bodymodel blocked and runs it on the card."""
    ref = os.path.join(tmp, "export_ref.pt")
    torch.save({"x": x.cpu(), "K": K.cpu(), "out": {k: v.cpu() for k, v in want.items()}}, ref)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, d, ref, "cuda"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(b) the fresh process exited with {proc.returncode}:\n"
                             + proc.stderr[-4000:])
    r = json.loads(proc.stdout.splitlines()[-1])
    launches = tuple(r["launches"].get(k, 0) for k in names)
    ok = (r["max_abs_diff"] <= EXPORT_TOL and not r["model_code"]
          and launches == SERVE_LAUNCHES["heads"])
    log(19, f"(b) fresh python3 -c, models/factory/bodymodel blocked: load {r['load_s']:.2f} s, "
            f"max |diff| {r['max_abs_diff']:.3e} ({'bitwise' if r['bitwise'] else 'not bitwise'})"
            f", launches K1/K2/K5 {launches}, model code imported {r['model_code']}; "
            f"{secs:.1f} s with the interpreter's start [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(b) the fresh-process load failed")
    return r


def free_cached():
    """Free what no tensor holds: garbage, the allocator's cache and the
    cuBLAS workspaces (a server's worker thread takes a cuBLAS handle, and
    its workspace, from a pool that outlives the thread), so that a server's
    ``memory_allocated`` after start counts what it allocated itself."""
    import gc

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def device_mib(tensors) -> float:
    """MiB of the distinct device storages under ``tensors``."""
    st = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors
          if isinstance(t, torch.Tensor) and t.is_cuda}
    return sum(st.values()) / 2**20


def host_us(fn, rounds=10, calls=100):
    """Median host microseconds per call of ``fn()`` over ``rounds`` runs of
    ``calls`` back-to-back calls (enqueue only; synchronized between runs)."""
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def event_ms(fn, reps=10, warmup=2):
    """Median milliseconds of one ``fn()`` between CUDA events recorded just
    before and just after it (the host's enqueue gaps included)."""
    with torch.inference_mode():
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def export_timing(model, loaded, x, K, attention, norm, card):
    """(c) the batch-8 forward, artifact against live module (turns live,
    artifact, artifact, live): host enqueue, wall between CUDA events and
    device busy; and each operator's host cost per call against its direct
    wrapper at the 672_B shapes (turns op, direct, direct, op; 1,000 calls
    each)."""
    fns = {"live": lambda: model.forward(x, K), "artifact": lambda: loaded(x, K)}
    turns = {"live": [], "artifact": []}
    for side in ("live", "artifact", "artifact", "live"):
        enq, _, busy = forward_alone(fns[side])
        turns[side].append((enq, event_ms(fns[side]), busy))
    fwd = {side: tuple(float(np.mean(v)) for v in zip(*t)) for side, t in turns.items()}
    for side, (enq, wall, busy) in fwd.items():
        log(19, f"(c) {SERVE} bf16 heads forward at batch 8, {side}: enqueue {enq:.2f} ms "
                f"(host), wall {wall:.2f} ms (CUDA events), device busy {busy:.2f} ms "
                f"(mean of 2 turns) [{card}]")
    scale = 64 ** -0.5
    q, k, v = qkv_views(2312, torch.bfloat16, heads=12, kv_len=2305, batch=8)
    g = torch.Generator(device="cuda").manual_seed(19)
    xn = torch.randn((8, 768, 2312), device="cuda", generator=g).to(torch.bfloat16)
    sn, bn = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    qkv = torch.randn((8, 2305, 3, 12, 64), device="cuda", generator=g).to(torch.bfloat16)
    pairs = {
        "K1 flash_fwd_t [8,12,64,2312]": (
            lambda: attention.FLASH_FWD_T(q, k, v, scale, 2305),
            lambda: attention._flash_fwd_t_cuda(q, k, v, scale, 2305)),
        "K2 layernorm_cm [8,768,2312]": (
            lambda: norm.LAYERNORM_CM(xn, sn, bn, 1e-6, torch.bfloat16),
            lambda: norm._layernorm_cm_cuda(xn, sn, bn, 1e-6, torch.bfloat16)),
        "K5 attention_qkv [8,2305,3,12,64]": (
            lambda: attention.ATTENTION_QKV(qkv, scale),
            lambda: attention._attention_qkv_cuda(qkv, scale)),
    }
    cost = {}
    for label, (op, direct) in pairs.items():
        t = {"op": [], "direct": []}
        for side, fn in (("op", op), ("direct", direct), ("direct", direct), ("op", op)):
            t[side].append(host_us(fn))
        cost[label] = (float(np.mean(t["op"])), float(np.mean(t["direct"])))
        log(19, f"(c) host cost per call, {label}: torch.ops.mhmr {cost[label][0]:.1f} us, "
                f"direct wrapper {cost[label][1]:.1f} us (2 turns of 10 x 100 calls each) "
                f"[{card}]")
    return {"fwd": fwd, "host_us": cost}


def export_serving(d, cuda_lib, names, card, sat18):
    """(d) cli/serve.build_server --artifact (heads): phase 18's 48 requests,
    each bitwise equal to its image alone in slot 0 of a batch-8 forward;
    launches per batch; the saturation traffic of phase 18 (f); memory
    after start against the live server's."""
    from multihmr_tpu_torch.cli import serve
    from multihmr_tpu_torch.io.export import read_meta
    from multihmr_tpu_torch.serve import BatcherStats

    payloads = [jpeg_bytes(synthetic_image(100 + i, *SERVE_SIZES[i % 3])) for i in range(48)]
    work = [payloads[i % len(payloads)] for i in range(256)]
    free_cached()
    base = torch.cuda.memory_allocated()
    built = serve.build_server(serve.parse_args(["--artifact", d, "--port", "0"]))
    mem = {"artifact": (torch.cuda.memory_allocated() - base) / 2**20}
    with Serving(built=built) as s:
        del built
        cuda_lib.reset_launches()  # the artifact server's run starts here
        res, wall = run_clients(s.port, payloads, 12)
        launches = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
        snap = http_get_json(s.port, "/stats")
        answers = [json.loads(b) if st == 200 else None for st, _, b, _ in res]
        want = tuple(snap["batches"] * c for c in SERVE_LAUNCHES["heads"])
        worst, counts_equal, bitwise = 0.0, True, True
        for payload, a in zip(payloads, answers):
            if a is None:
                continue
            ref = slot0_reference(s.batcher, payload, read_meta(d)["img_size"])
            counts_equal = counts_equal and ref["count"] == a["count"]
            bitwise = bitwise and ref == a
            for pa, pr in zip(a["persons"], ref["persons"]):
                worst = max(worst, json_err(pr, pa))
        n_ok = sum(a is not None for a in answers)
        ok = n_ok == 48 and snap["requests"] == 48 and launches == want and bitwise
        log(19, f"(d) cli/serve --artifact (heads): 48 JPEGs from 12 clients, {n_ok} answered "
                f"200 in {wall:.2f} s; batches {snap['batches']}, mean batch size "
                f"{snap['mean_batch_size']}; launches K1/K2/K5 {launches} (want {want}); each "
                f"against its image alone in slot 0 of a batch-8 forward: counts "
                f"{'equal' if counts_equal else 'DIFFER'}, worst field error {worst:.3e}, "
                f"{'bitwise' if bitwise else 'NOT BITWISE'} (want bitwise) "
                f"{'ok' if ok else 'FAIL'}")
        sat = {}
        for label, profile in (("full", False), ("full, profiled", True)):
            s.batcher.stats = BatcherStats()
            sat[label] = saturate(s, work, profile, 19, f"(d) {SERVE} artifact server, {label}",
                                  card)
            f18 = (sat18 or {}).get(label)
            if f18:
                log(19, f"(d) phase 18's live server, {label}: {f18['img_s']:.2f} images/s, "
                        f"p50 {f18['p50']:.1f} / p95 {f18['p95']:.1f} ms, dispatch_ms p50 "
                        f"{f18['dispatch_p50']:.2f}, mean batch {f18['mean_batch']}"
                        + ("" if f18["busy"] is None else f", card busy {100 * f18['busy']:.1f} %"))
    free_cached()
    base = torch.cuda.memory_allocated()
    with Serving(built=serve.build_server(serve.parse_args(["--port", "0"]))):
        mem["live"] = (torch.cuda.memory_allocated() - base) / 2**20
    log(19, f"(d) torch.cuda.memory_allocated() after start: artifact server "
            f"{mem['artifact']:.1f} MiB, live server {mem['live']:.1f} MiB [{card}]")
    ok = ok and all(f["ok"] for f in sat.values()) and mem["artifact"] <= 1.05 * mem["live"]
    if not ok:
        raise AssertionError("(d) serving from the artifact failed")
    return {"sat": sat, "mem": mem, "launches": launches, "batches": snap["batches"],
            "worst": worst, "bitwise": bitwise}


def export_anny(build_model, cast_backbone_bf16, cuda_lib, names, card, tmp):
    """(e) multiHMR_672_L_anny at batch 1, heads, on the synthetic asset at
    ANNY_VERTICES vertices: the artifact against the live forward, and its
    launches."""
    from multihmr_tpu_torch.bodymodel.anny import AnnyModel, save_anny_npz, synthetic_anny_model
    from multihmr_tpu_torch.io.export import make_serving_fn
    from multihmr_tpu_torch.io.preprocessing import preprocess_array

    npz = os.path.join(tmp, "anny.npz")
    if not os.path.exists(npz):  # phase 17 wrote it
        save_anny_npz(npz, AnnyModel.from_arrays(
            synthetic_anny_model(num_vertices=ANNY_VERTICES), "cpu"))
    env = os.environ.get("ANNY_NPZ")
    os.environ["ANNY_NPZ"] = npz
    try:
        model = build_model(ANNY, device="cuda", seed=0)
    finally:
        if env is None:
            os.environ.pop("ANNY_NPZ", None)
        else:
            os.environ["ANNY_NPZ"] = env
    cast_backbone_bf16(model.net)
    loaded, meta, d, secs = export_timed(model, tmp, "anny", 1, ANNY)
    pre = preprocess_array(synthetic_image(0, 480, 640), model.cfg.img_size)
    x, K = (torch.from_numpy(a)[None].cuda() for a in (pre.x, pre.K))
    with torch.inference_mode():
        want = make_serving_fn(model)(x, K)
    cuda_lib.reset_launches()  # the Anny artifact's image starts here
    got = loaded(x, K)
    torch.cuda.synchronize()
    launches = tuple(cuda_lib.LAUNCHES[k] for k in names)  # read just after it
    same, err, within, bitwise = output_err(got, want)
    counts = tuple(meta["kernel_ops"].values())  # K1, K2, K5
    depth = model.cfg.vit.depth
    want_launches = (depth, 2 * depth, 0)  # K1 once and K2 twice per block (24 at 672_L)
    ok = same and within and launches == want_launches and counts == want_launches
    mib = os.path.getsize(os.path.join(d, "model.pt2")) / 2**20
    log(19, f"(e) {ANNY} bf16 heads, batch 1: export {secs[0]:.2f} s, save {secs[1]:.2f} s, load "
            f"{secs[2]:.2f} s, model.pt2 {mib:.1f} MiB; graph operators {counts}; {len(got)} "
            f"outputs against the live forward: max |diff| {err:.3e} (tol {EXPORT_TOL:g}), "
            f"{'bitwise' if bitwise else 'not bitwise'}; launches K1/K2/K5 {launches} (want "
            f"{want_launches}) [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(e) the Anny artifact disagrees with the live model")
    return {"secs": secs, "mib": mib, "err": err, "launches": launches}


def run_export(build_model, cast_backbone_bf16, cuda_lib, attention, norm, card, tmp, sat18):
    """Phase 19: the torch.export artifact of 672_B (both streams) and of the
    Anny family, loaded without model code, timed against the live module,
    and served through cli/serve --artifact. Every part runs; the phase
    fails at its end if any did."""
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    failed, figures = [], {}

    def part(tag, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            failed.append(tag)
            log(19, f"({tag}) FAIL\n" + traceback.format_exc())
            return None
        finally:
            log(19, f"({tag}) took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    res = part("a", export_672b, build_model, cast_backbone_bf16, cuda_lib, attention, names,
               card, tmp)
    if res is not None:
        model, loaded, x, K, want = res.pop("live")
        figures["a"] = res
        figures["b"] = part("b", export_fresh_process, res["heads"]["dir"], x, K, want,
                            cuda_lib, names, card, tmp)
        figures["c"] = part("c", export_timing, model, loaded, x, K, attention, norm, card)
        del model, loaded, x, K, want
        torch.cuda.empty_cache()
        figures["d"] = part("d", export_serving, res["heads"]["dir"], cuda_lib, names, card,
                            sat18)
    figures["e"] = part("e", export_anny, build_model, cast_backbone_bf16, cuda_lib, names,
                        card, tmp)
    torch.cuda.empty_cache()
    log(19, f"phase 19 took {time.perf_counter() - t0:.1f} s")
    if failed or res is None:
        raise AssertionError(f"phase 19 parts failed: {failed}")
    return figures


# ---- phase 20: the image library, the demo's loader, the JAX package's
# checkpoints and cli/data

# the phase's image sizes (h, w): landscape and portrait photos, EHF's
# 1600 x 1200, and the odd-pad and .5-tie cases of tests/test_native.py
IO_SIZES = [(720, 1280), (1200, 1600), (1280, 720), (1000, 1024), (250, 1000)]
IO_TARGETS = (896, 672, 674)
# native preprocessing against PIL contain + pad + normalize: one uint8
# level (1/255/0.225 = 0.0174) on a few values, tests/test_native.py:51, :78-79
IO_MAX, IO_MEAN = 0.018, 1e-3
# JPEG decoders round their IDCTs apart: mean |decode - PIL| in uint8 levels
DECODE_MEAN = 1.5
# visualize's GT vertices, card against CPU (fp32, TF32 off), metres
VIS_TOL = 1e-4
PROBE_CPP = ("#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
             "int main() { jpeg_decompress_struct c; (void)c;\n"
             "  return png_access_version_number() > 0 ? 0 : 1; }\n")


def error_line(text: str) -> str:
    """The compiler's first "error" line of ``text``, else its last line."""
    lines = [ln.strip() for ln in text.strip().splitlines()] or ["(no output)"]
    return next((ln for ln in lines if "error" in ln), lines[-1])


def codec_probe(tmp):
    """Compile, link and run a program that includes jpeglib.h and png.h and
    links -ljpeg -lpng: (ok, the compiler's last line)."""
    from multihmr_tpu_torch.io import native

    src, exe = os.path.join(tmp, "codec_probe.cpp"), os.path.join(tmp, "codec_probe")
    with open(src, "w") as f:
        f.write(PROBE_CPP)
    proc = subprocess.run([native._cxx(native.IMAGE_IO_SOURCE), "-std=c++17", src, "-o", exe,
                           *native.IMAGE_IO_LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        return False, error_line(proc.stderr)
    run = subprocess.run([exe], capture_output=True, text=True)
    return run.returncode == 0, f"compiled, linked and ran (rc {run.returncode})"


def write_io_images(d):
    """JPEG and PNG files of IO_SIZES: [(path, (h, w))]."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    out = []
    for i, (h, w) in enumerate(IO_SIZES):
        img = Image.fromarray(synthetic_image(400 + i, h, w))
        for ext in ("jpg", "png"):
            path = os.path.join(d, f"{h}x{w}.{ext}")
            img.save(path, quality=90) if ext == "jpg" else img.save(path)
            out.append((path, (h, w)))
    return out


def io_library(card, tmp):
    """(a) the codec probe, the build of csrc/image_io.cpp, its decode,
    preprocess and loader against PIL and the port's preprocess_array, and
    its host times. Returns (probe ok, figures or None)."""
    from PIL import Image, ImageOps

    from multihmr_tpu_torch.io import native
    from multihmr_tpu_torch.io.preprocessing import normalize_nhwc, preprocess_array

    cpu = host_cpu()
    ok, msg = codec_probe(tmp)
    log(20, f"(a) libjpeg/libpng probe: {'compiles' if ok else 'FAILS'}: {msg} [{card}; {cpu}]")
    try:
        so, secs = native.build_image_io()
        native._load_image_io()
    except (RuntimeError, OSError) as err:
        if ok:
            raise AssertionError("the codec probe compiles but csrc/image_io.cpp does not "
                                 "build or load") from err
        log(20, f"(a) csrc/image_io.cpp does not build or load here, as the probe says "
                f"({error_line(str(err))}): the image library's figures are not available "
                f"[{card}; {cpu}]")
        return False, None
    if not ok:
        raise AssertionError("csrc/image_io.cpp built and loaded where the codec probe fails")
    log(20, f"(a) csrc/image_io.cpp built in {secs:.2f} s ({so.name}) [{card}; {cpu}]")
    files = write_io_images(os.path.join(tmp, "io_images"))
    worst, good = {"decode": 0.0, "pil": (0.0, 0.0), "array": (0.0, 0.0)}, True
    for path, _ in files:
        pil = Image.open(path).convert("RGB")
        rgb = np.asarray(pil)
        d = float(np.mean(np.abs(native.decode_file(path).astype(int) - rgb.astype(int))))
        worst["decode"] = max(worst["decode"], d)
        good = good and d < DECODE_MEAN
        for S in IO_TARGETS:
            ours = native.preprocess_file(path, S)
            refs = {"pil": normalize_nhwc(np.asarray(
                        ImageOps.pad(ImageOps.contain(pil, (S, S)), size=(S, S)))),
                    "array": preprocess_array(rgb, S).x}
            for k, ref in refs.items():
                e = np.abs(ours - ref)
                worst[k] = (max(worst[k][0], float(e.max())), max(worst[k][1], float(e.mean())))
                good = good and e.max() < IO_MAX and e.mean() < IO_MEAN
    log(20, f"(a) {len(files)} files x S {IO_TARGETS}: decode mean |d| <= {worst['decode']:.3f} "
            f"levels (< {DECODE_MEAN}); preprocess_file vs PIL contain+pad+normalize max "
            f"{worst['pil'][0]:.4f} mean {worst['pil'][1]:.2e}, vs preprocess_array max "
            f"{worst['array'][0]:.4f} mean {worst['array'][1]:.2e} (limits {IO_MAX}, {IO_MEAN:g}) "
            f"[{card}] {'ok' if good else 'FAIL'}")
    paths = [p for p, _ in files]
    same = True
    for S in IO_TARGETS:
        with native.NativeImageLoader(paths, S, n_threads=4, max_queue=2) as loader:
            got = dict(loader)
        same = same and sorted(got) == list(range(len(paths))) and all(
            np.array_equal(got[i], native.preprocess_file(p, S)) for i, p in enumerate(paths))
    with native.NativeImageLoader([os.path.join(tmp, "no_such.jpg")], 64) as loader:
        bad = [i for i, _ in loader]
    log(20, f"(a) NativeImageLoader at S {IO_TARGETS}: every index, bitwise preprocess_file "
            f"{'ok' if same else 'FAIL'}; a bad path gives {bad} (want [-1]) [{card}]")
    good = good and same and bad == [-1]
    # host times at 896: one 1280 x 720 JPEG, one thread, median of 20
    jpg = files[0][0]
    ms_native = wall_ms(lambda: native.preprocess_file(jpg, 896), reps=20)
    ms_pil = wall_ms(lambda: preprocess_array(
        np.asarray(Image.open(jpg).convert("RGB")), 896), reps=20)
    rgb = np.asarray(Image.open(jpg).convert("RGB"))
    ms_array = wall_ms(lambda: preprocess_array(rgb, 896), reps=20)
    rates = {}
    many = [p for p in paths if p.endswith(".jpg")] * 13  # 65 JPEGs of the five sizes
    many = many[:64]
    for n_threads in (1, os.cpu_count()):
        t0 = time.perf_counter()
        with native.NativeImageLoader(many, 896, n_threads=n_threads) as loader:
            n = sum(1 for i, _ in loader if i >= 0)
        rates[n_threads] = n / (time.perf_counter() - t0)
    log(20, f"(a) host ms per 1280x720 JPEG at 896 (median of 20, one thread): preprocess_file "
            f"{ms_native:.2f}, PIL decode + preprocess_array {ms_pil:.2f} (preprocess_array "
            f"alone {ms_array:.2f}); NativeImageLoader over 64 JPEGs at 896: "
            + ", ".join(f"{k} thread(s) {v:.1f} images/s" for k, v in rates.items())
            + f" [{card}; {cpu}]")
    if not good:
        raise AssertionError("(a) the image library disagrees with PIL")
    return True, {"build_s": secs, "ms_native": ms_native, "ms_pil": ms_pil, "rates": rates}


def pil_demo_loop(demo, model, paths, out_dir, count):
    """The demo's loop before the native loader: PIL decode and
    preprocess_array on the main thread, one stage in flight through
    start_image / finish_image; returns its p50 ms per image."""
    from PIL import Image

    periods, pending, t_prev = [], None, time.perf_counter()
    for i in range(len(paths) + 1):
        nxt = None
        if i < len(paths):
            img = np.asarray(Image.open(paths[i]).convert("RGB"))
            nxt = (i, img, count(model, img)[1])
        if pending is not None:
            j, img_j, persons = pending
            persons.wait()
            demo.finish_image(model, persons, img_j, os.path.basename(paths[j]), out_dir, "pil")
            t = time.perf_counter()
            periods.append(t - t_prev)
            t_prev = t
        pending = nxt
    return 1000 * float(np.median(periods))


def demo_loaders(build_model, demo, cast_backbone_bf16, cuda_lib, names, card, tmp, native_ok):
    """(b) cli/demo.py multiHMR_896_L over 8 JPEGs (its overlay writer
    swapped out: phase 18 (h) draws them, and the synthetic body's random
    faces would set the pace), in turns with the PIL loop it replaced:
    the loader the summary names, each image's JSON against a forward of
    its preprocess_file tensor, 24 K1 + 48 K2 per image, p50 ms per image."""
    import contextlib
    import io

    from PIL import Image

    from multihmr_tpu_torch.io import native

    src = os.path.join(tmp, "loader_in")
    os.makedirs(src)
    sizes = [(720, 1280), (480, 640), (1200, 1600), (1280, 720), (640, 480), (1080, 1920),
             (896, 896), (600, 800)]
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(synthetic_image(500 + i, h, w)).save(os.path.join(src, f"im{i}.jpg"),
                                                             quality=90)
    paths = sorted(os.path.join(src, f) for f in os.listdir(src))
    per_image, start_image = [], demo.start_image

    def counted(model, *args, **kwargs):
        before = dict(cuda_lib.LAUNCHES)
        res = start_image(model, *args, **kwargs)
        per_image.append(tuple(cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in names))
        return res

    model = build_model("multiHMR_896_L", device="cuda", seed=0)  # the demo's weights
    cast_backbone_bf16(model.net)
    write_overlays = demo._write_overlays
    p50 = {"demo": [], "pil": []}
    loaders, ok = set(), True
    demo._write_overlays = lambda *a, **kw: None
    try:
        for turn, kind in enumerate(("demo", "pil", "pil", "demo")):
            out = os.path.join(tmp, f"loader_out{turn}")
            os.makedirs(out)
            per_image.clear()
            cuda_lib.reset_launches()  # this run starts here
            if kind == "demo":
                buf = io.StringIO()
                demo.start_image = counted
                try:
                    with contextlib.redirect_stdout(buf):
                        demo.main(["--img_folder", src, "--out_folder", out,
                                   "--model_name", "multiHMR_896_L"])
                finally:
                    demo.start_image = start_image
                summary = json.loads(buf.getvalue().splitlines()[-1])
                loaders.add(summary["loader"])
                p50["demo"].append(summary["p50_image_ms"])
            else:
                p50["pil"].append(pil_demo_loop(demo, model, paths, out, counted))
            good = len(per_image) == 8 and all(c == (24, 48, 0) for c in per_image)
            log(20, f"(b) turn {turn}, {'cli/demo' if kind == 'demo' else 'PIL loop'}: launches "
                    f"K1/K2/K5 per image {sorted(set(per_image))} (want (24, 48, 0)) x "
                    f"{len(per_image)} [{card}] {'ok' if good else 'FAIL'}")
            ok = ok and good
        # each image's JSON from the demo's last turn against a forward of
        # its preprocess_file tensor (the PIL path's preprocess_array when
        # the image library is unavailable) on the same weights
        ref = os.path.join(tmp, "loader_ref")
        os.makedirs(ref)
        equal = 0
        for path in paths:
            name = os.path.basename(path)
            if native_ok:
                x = native.preprocess_file(path, model.cfg.img_size)
                _, persons = start_image(model, None, x=x)
            else:
                _, persons = start_image(model, np.asarray(Image.open(path).convert("RGB")))
            demo.finish_image(model, persons, None, name, ref, "multiHMR_896_L")
            got = json.load(open(os.path.join(tmp, "loader_out3", f"{name}_multiHMR_896_L.json")))
            want = json.load(open(os.path.join(ref, f"{name}_multiHMR_896_L.json")))
            equal += got == want and len(got["persons"]) > 0
    finally:
        demo._write_overlays = write_overlays
        demo.start_image = start_image
    want_loader = "native" if native_ok else "pil"
    ok = ok and loaders == {want_loader} and equal == len(paths)
    log(20, f"(b) cli/demo multiHMR_896_L, 8 JPEGs: loader {sorted(loaders)} (want "
            f"{want_loader}: the codec probe {'compiles' if native_ok else 'fails'}); JSON "
            f"bitwise equal to a forward of {'preprocess_file' if native_ok else 'preprocess_array'}"
            f" on {equal} of {len(paths)} images; p50 ms per image, turns demo / PIL / PIL / demo: "
            f"cli/demo ({want_loader}) {' / '.join(f'{v:.1f}' for v in p50['demo'])}, PIL loop "
            f"{' / '.join(f'{v:.1f}' for v in p50['pil'])} [{card}; {host_cpu()}] "
            f"{'ok' if ok else 'FAIL'}")
    del model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("(b) the demo's loader check failed")
    return {k: float(np.mean(v)) for k, v in p50.items()}


def jax_checkpoints(named_config, cuda_lib, names, card, tmp, ref_paths):
    """(c) flax-layout ckpt_000000.msgpack files of the JAX tree that
    convert_reference_checkpoint builds from phase 15's seeded reference
    files (896_L and 672_S, full width): load_jax_checkpoint bitwise equal
    to the .pt route; then cli/train --eval_only --pretrained of the 672_S
    msgpack against the .pt, metrics bitwise equal."""
    import contextlib
    import io
    from pathlib import Path

    from multihmr_tpu_torch.cli import train as train_cli
    from multihmr_tpu_torch.io import flax_msgpack
    from multihmr_tpu_torch.io.checkpoint import (
        convert_reference_checkpoint,
        jax_tree_from_reference,
        load_jax_checkpoint,
    )

    msgpacks, ok = {}, True
    for name in ("multiHMR_896_L", "multiHMR_672_S"):
        cfg = named_config(name)
        pt = ref_paths.get(name) if ref_paths else None
        if pt is None:  # phase 15 did not leave it
            pt = os.path.join(tmp, f"{name}.pt")
            write_reference_ckpt(pt, name)
        ckpt = torch.load(pt, map_location="cpu", weights_only=False)
        want = convert_reference_checkpoint(ckpt, cfg)  # the .pt route
        t0 = time.perf_counter()
        path = flax_msgpack.write_flax_checkpoint(os.path.join(tmp, f"jax_{name}"),
                                                  jax_tree_from_reference(ckpt, cfg), 0, cfg)
        t_write = time.perf_counter() - t0
        del ckpt
        t0 = time.perf_counter()
        flax_msgpack.load(path)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, meta = load_jax_checkpoint(path, cfg)
        t_load = time.perf_counter() - t0
        same = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
        log(20, f"(c) {name} ckpt_000000.msgpack: {os.path.getsize(path) / 2**20:.1f} MiB written "
                f"in {t_write:.2f} s; decode {t_decode:.2f} s, load_jax_checkpoint (decode + "
                f"params_from_jax) {t_load:.2f} s; {len(got)} tensors bitwise equal to the .pt "
                f"route: {same}; meta epoch {meta['epoch']} [{card}; {host_cpu()}] "
                f"{'ok' if same else 'FAIL'}")
        ok = ok and same and meta["epoch"] == 0
        msgpacks[name] = (path, pt)
        del got, want
    # the training CLI on the card, --eval_only on the seeded EHF tree with
    # the 672_S weights' own first person as its GT (recall 100, PA-PVE ~0)
    cwd = os.getcwd()
    run = os.path.join(tmp, "jax_cli")
    os.makedirs(run)
    metrics = {}
    try:
        os.chdir(run)
        write_datasets(Path(run))
        from multihmr_tpu_torch.factory import build_model

        model = build_model("multiHMR_672_S", device="cuda",  # the CLI's config at --amp 1
                            checkpoint=msgpacks["multiHMR_672_S"][1])
        ehf_gt_from(model)
        del model
        for tag, path in zip(("msgpack", "pt"), msgpacks["multiHMR_672_S"]):
            argv = ["--backbone", "dinov2_vits14", "--img_size", "672", "--n_devices", "1",
                    "--eval_only", "1", "--valset", "ehf", "--pretrained", path, "--name", tag]
            buf = io.StringIO()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train_cli.main(argv)
            secs = time.perf_counter() - t0
            recs = [json.loads(ln) for ln in open(os.path.join("logs", tag, "metrics.jsonl"))]
            metrics[tag] = {r["tag"]: r["value"] for r in recs}
            log(20, f"(c) cli.train --pretrained {os.path.basename(path)} --eval_only 1 (672_S, "
                    f"EHF, 2 images) in {secs:.1f} s: " + ", ".join(
                        f"{k.split('/')[1]} {v:.6g}" for k, v in metrics[tag].items())
                    + f"; K1/K2/K5 launches {tuple(cuda_lib.LAUNCHES[k] for k in names)} [{card}]")
    finally:
        os.chdir(cwd)
    pt = metrics["pt"]
    same = (metrics["msgpack"] == pt and all(np.isfinite(v) for v in pt.values())
            and pt["ehf-test-1/recall"] == 100.0 and pt["ehf-test-1/pa_pve"] < 1.0)
    log(20, f"(c) --pretrained .msgpack metrics bitwise equal to the .pt route's, recall 100 "
            f"and PA-PVE < 1 mm on GT made from those weights: {same} [{card}] "
            f"{'ok' if same else 'FAIL'}")
    if not (ok and same):
        raise AssertionError("(c) the JAX checkpoint check failed")


def cli_data(card, tmp):
    """(d) cli/data on the seeded BEDLAM and EHF trees: create_jpeg,
    create_annots, dataloader, and visualize on the card against the CPU."""
    import contextlib
    import io
    from pathlib import Path

    from PIL import Image

    import multihmr_tpu_torch.render as render
    from multihmr_tpu_torch.cli import data as data_cli

    def run(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            data_cli.main(argv)
        lines = buf.getvalue().splitlines()
        log(20, f"(d) cli.data {' '.join(argv)} ({time.perf_counter() - t0:.2f} s): "
                + (lines[-1] if lines else "") + f" [{card}; {host_cpu()}]")
        return lines

    cwd, root = os.getcwd(), os.path.join(tmp, "data_cli")
    os.makedirs(root)
    seen, real = [], render.render_meshes
    ok = True
    try:
        os.chdir(root)
        write_datasets(Path(root))
        run(["create_jpeg", "--root_dir", "data", "--target_size", "512"])
        jpgs = sorted(str(p) for p in Path("data").rglob("*_512.jpg"))
        sizes = sorted({Image.open(p).size for p in jpgs})
        good = len(jpgs) == 8 and sizes == [(512, 288), (512, 384)]
        log(20, f"(d) create_jpeg: {len(jpgs)} JPEGs, sizes {sizes} (want 8, [(512, 288), "
                f"(512, 384)]) [{card}] {'ok' if good else 'FAIL'}")
        ok = ok and good
        for ds in ("bedlam", "ehf"):
            lines = run(["create_annots", "--dataset", ds])
            ok = ok and any("built annotations" in ln for ln in lines)
        lines = run(["dataloader", "--dataset", "bedlam", "--n", "4"])
        ok = ok and "2 samples in" in lines[-1]

        def spy(img, l_mesh, *a, **kw):
            seen.append([np.asarray(m, np.float64) for m in l_mesh])
            return real(img, l_mesh, *a, **kw)

        render.render_meshes = spy
        for ds, humans in (("ehf", 1), ("bedlam", 3)):
            verts = {}
            for dev in ("cuda", "cpu"):
                seen.clear()
                lines = run(["visualize", "--dataset", ds, "--device", dev])
                shape = np.asarray(Image.open(f"{ds}_vis_0.png")).shape
                verts[dev] = seen[0]
                good = (f"({humans} humans)" in lines[-1] and shape == (512, 1024, 3)
                        and len(seen[0]) == humans)
                ok = ok and good
            err = max(float(np.abs(a - b).max()) for a, b in zip(verts["cuda"], verts["cpu"]))
            good = err <= VIS_TOL
            log(20, f"(d) visualize {ds}: PNG {shape}, {humans} humans; GT vertices --device cuda "
                    f"vs cpu max |d| {err:.2e} m (tol {VIS_TOL:g}) [{card}] "
                    f"{'ok' if good else 'FAIL'}")
            ok = ok and good
    finally:
        render.render_meshes = real
        os.chdir(cwd)
    if not ok:
        raise AssertionError("(d) cli/data failed")


def run_io(build_model, named_config, demo, cast_backbone_bf16, cuda_lib, attention, norm, card,
           tmp, ref_paths):
    """Phase 20: (a) the image library, (b) the demo with each loader, (c)
    the JAX package's checkpoints, (d) cli/data. Every part runs; the phase
    fails at its end if any did."""
    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    failed, figures = [], {}

    def part(tag, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            failed.append(tag)
            log(20, f"({tag}) FAIL\n" + traceback.format_exc())
            return None
        finally:
            log(20, f"({tag}) took {time.perf_counter() - t0:.1f} s [{card}]")

    t0 = time.perf_counter()
    lib = part("a", io_library, card, tmp)
    native_ok, figures["a"] = lib if lib else (codec_probe(tmp)[0], None)
    figures["b"] = part("b", demo_loaders, build_model, demo, cast_backbone_bf16, cuda_lib,
                        names, card, tmp, native_ok)
    torch.cuda.empty_cache()
    part("c", jax_checkpoints, named_config, cuda_lib, names, card, tmp, ref_paths)
    torch.cuda.empty_cache()
    part("d", cli_data, card, tmp)
    log(20, f"phase 20 took {time.perf_counter() - t0:.1f} s [{card}]")
    if failed:
        raise AssertionError(f"phase 20 parts failed: {failed}")
    return figures


# ---- phase 21: multi-device execution (M11) on one card, two ranks

# whole-model bf16 comparisons, mesh against one rank on the same weights:
# relative L2 error of the final-norm patch tokens, and of v3d under the
# one-rank forward's detections (a ulp of noise in the scores of random
# weights would otherwise reorder the K slots, whose meshes lie metres
# apart). The tensor-parallel proj and fc2 sum two bf16 partial products
# where one rank rounds one fp32 sum, over 24 blocks: phase 13's bf16
# stream limit
PAR_TOL = STREAM_TOL
# an updated parameter, mesh against one rank, beyond two fp32 ulps of its
# value, in units of Adam's first step (lr), where the gradient is at least
# 1e-2 of its parameter's largest
STEP_TOL = 1e-3
PAR_LAUNCHES = {"heads_fwd": (24, 48, 0), "ring_fwd": (0, 0, 0),  # K1/K2/K5 per rank
                "train4": (4, 4, 8), "train24": (24, 24, 48)}  # K1/K3/K2 per rank
# DP in one process: 672_B batch 8 as two chunks of 4 on [cuda:0, cuda:0]
DP_LAUNCHES = (24, 48, 0)  # K1/K2/K5 per batch of 8: (12, 24, 0) per chunk


class _Done:
    """A collective request that has already finished (it ran staged)."""

    def wait(self, *args, **kwargs):
        return True

    def is_completed(self):
        return True


def stage_collectives(calls, nbytes):
    """In this process only, route through host memory the ``torch.distributed``
    calls that gloo does not take on CUDA tensors on the card (probed there
    with torch 2.11: ``batch_isend_irecv`` fails with "Bad address", and an
    FSDP2 step kills a rank with SIGSEGV, so its all-gather and
    reduce-scatter go too): a CUDA operand is copied to the host, the call
    runs there on gloo, synchronously, and the result is copied back.
    ``calls`` and ``nbytes`` count each staged call and the bytes it moved
    each way. The package never stages: this is how two ranks share one
    card here, and a time taken through it is no scaling figure."""
    import inspect

    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    def install(name, staged):
        if hasattr(dist, name):
            setattr(dist, name, staged)
        if hasattr(c10d, name):
            setattr(c10d, name, staged)

    def two_tensors(name):
        orig = getattr(dist, name, None)
        if orig is None:  # not in this torch
            return
        sig = inspect.signature(orig)
        out_name, in_name = list(sig.parameters)[:2]

        def staged(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            out, inp = bound.arguments[out_name], bound.arguments[in_name]
            if out.device.type != "cuda":
                return orig(*args, **kwargs)
            async_op = bound.arguments.get("async_op", False)
            bound.arguments["async_op"] = False
            host_out = torch.empty(out.shape, dtype=out.dtype)
            bound.arguments[out_name], bound.arguments[in_name] = host_out, inp.detach().cpu()
            orig(*bound.args, **bound.kwargs)
            out.copy_(host_out)
            calls[name] += 1
            nbytes[name] += inp.numel() * inp.element_size() + out.numel() * out.element_size()
            return _Done() if async_op else None

        install(name, staged)

    for name in ("all_gather_into_tensor", "all_gather_single", "reduce_scatter_tensor",
                 "reduce_scatter_single"):
        two_tensors(name)
    orig_p2p = dist.batch_isend_irecv

    def staged_p2p(ops):
        if not any(op.tensor.device.type == "cuda" for op in ops):
            return orig_p2p(ops)
        host_ops, back = [], []
        for op in ops:
            t = op.tensor.detach().cpu()
            host_ops.append(dist.P2POp(op.op, t, op.peer, op.group, op.tag))
            if op.op is dist.irecv:
                back.append((op.tensor, t))
            nbytes["batch_isend_irecv"] += t.numel() * t.element_size()
        for work in orig_p2p(host_ops):
            work.wait()
        for dst, src in back:
            dst.copy_(src)
        calls["batch_isend_irecv"] += 1
        return [_Done() for _ in ops]

    install("batch_isend_irecv", staged_p2p)


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _beyond_flash(a, b) -> tuple:
    """(max |a - b| beyond one bf16 ulp of |b|, the 2^-5 rms(b) floor): the
    bf16 flash limit's terms, elementwise, for the record."""
    a, b = a.float(), b.float()
    return ((a - b).abs() - BF16_ULP * b.abs()).max().item(), \
        BF16_FLOOR_RMS * b.square().mean().sqrt().item()


def _launch_tuple(cuda_lib, names):
    return tuple(cuda_lib.LAUNCHES.get(k, 0) for k in names)


def _par_cfg(named_config, name, layerscale=LAYERSCALE, depth=None, dtype=None):
    base = named_config(name)
    vit = dataclasses.replace(base.vit, layerscale_init=layerscale,
                              **({} if depth is None else {"depth": depth}))
    return dataclasses.replace(base, vit_override=vit,
                               **({} if dtype is None else {"compute_dtype": dtype}))


def _par_compare(one, sharded, x, K, control):
    """Patch tokens and v3d (under ``one``'s detections) of a mesh model
    against one rank, and the tokens of each against ``control`` (the fp32
    stream's)."""
    with torch.inference_mode():
        ref = one.forward(x, K)
        tok = [m.net.backbone(x)["patch_tokens"] for m in (one, sharded)]
        v3d = [m.forward(x, K, is_training=True, gt_det=ref["det"])["v3d"] for m in (one, sharded)]
    return {"tokens": _rel_l2(tok[1], tok[0]), "tokens_flash": _beyond_flash(tok[1], tok[0]),
            "one_vs_fp32": _rel_l2(tok[0], control), "mesh_vs_fp32": _rel_l2(tok[1], control),
            "v3d": _rel_l2(v3d[1], v3d[0]), "v3d_max": (v3d[1] - v3d[0]).abs().max().item(),
            "finite": bool(torch.isfinite(v3d[1]).all())}


def _par_ok(c):
    return (c["tokens"] <= PAR_TOL and c["v3d"] <= PAR_TOL and c["finite"]
            and c["mesh_vs_fp32"] <= STREAM_RATIO * c["one_vs_fp32"])


def _par_text(c):
    return (f"patch tokens rel L2 {c['tokens']:.3e}, v3d rel L2 {c['v3d']:.3e} (max abs "
            f"{c['v3d_max']:.3e} m) (tol {PAR_TOL:g}); tokens against the fp32 stream: mesh "
            f"{c['mesh_vs_fp32']:.3e}, one rank {c['one_vs_fp32']:.3e} (mesh <= "
            f"{STREAM_RATIO:g} x one rank); tokens beyond one bf16 ulp {c['tokens_flash'][0]:.3e} "
            f"against the flash floor 2^-5 rms {c['tokens_flash'][1]:.3e} (recorded)")


def _train_compare(model, mesh, batch, build_ref, cuda_lib, names, lr=1e-5):
    """One Adam step on ``model`` (a mesh model) and, on rank 0, the same
    step on one rank (``build_ref()``): whole-batch loss terms; gradients
    relative to each one's largest magnitude; the updated parameters in units
    of the step size ``lr`` where the one-rank gradient is at least 1e-2 of
    its parameter's largest (Adam's first step moves a parameter by about
    lr * sign(g), so a gradient at its noise floor decides a whole step, as
    tests/test_torch_train.py has it); the step's launches; and the per-rank
    Adam-moment bytes against one rank's."""
    from torch.distributed.tensor import DTensor

    from multihmr_tpu_torch.parallel import sharding
    from multihmr_tpu_torch.train.trainer import BATCH_KEYS, Trainer, make_train_step, to_device

    trainer = Trainer(model, torch.optim.Adam(model.net.parameters(), lr=lr, eps=1e-8),
                      mesh=mesh, fsdp=True)
    local = sharding.shard_batch({k: batch[k] for k in BATCH_KEYS}, mesh)
    cuda_lib.reset_launches()  # the mesh step's run starts here
    terms = trainer.train_step(to_device(local, "cuda"), 0)
    launches = _launch_tuple(cuda_lib, names)  # read just after it
    grads = {n: sharding.gather_tensor(n, p.grad, mesh, model.tp_mode)
             for n, p in model.net.named_parameters()}
    params = trainer.full_state()
    mine = sum((v.to_local() if isinstance(v, DTensor) else v).numel() * v.element_size()
               for s in trainer.optimizer.state.values() for k, v in s.items()
               if k.startswith("exp_avg"))
    res = {"terms": {k: float(v) for k, v in terms.items()}, "moment_bytes": mine,
           "launches": launches,
           "valid_here": float(local["gt_valid"].sum()),
           "fsdp_leaves": len(trainer.fsdp_names)}
    if torch.distributed.get_rank() == 0:
        ref = build_ref()
        opt = torch.optim.Adam(ref.net.parameters(), lr=lr, eps=1e-8)
        rterms = make_train_step(ref, opt)(to_device({k: batch[k] for k in BATCH_KEYS},
                                                     "cuda"), 0)
        res["ref_terms"] = {k: float(v) for k, v in rterms.items()}
        rel = lambda a, b: _grad_rel(a, b) if float(b.abs().max()) > 0 else 0.0  # noqa: E731
        rgrads = dict(ref.net.named_parameters())
        res["grad_err"] = max((rel(grads[n], p.grad), n) for n, p in rgrads.items()
                              if p.grad is not None)
        rstate = ref.net.state_dict()

        def step_err(n, p):
            # |mesh - one rank| beyond two fp32 ulps of the value, over lr,
            # where |g| >= 1e-2 max |g|
            g = p.grad.abs()
            big = (g >= 1e-2 * g.max()).cpu()
            want = rstate[n].cpu().float()
            ulp = (torch.nextafter(want, want + 1) - want).abs()
            d = ((params[n].float() - want).abs() - 2 * ulp)[big]
            return max(d.max().item(), 0.0) / lr if d.numel() else 0.0

        res["param_err"] = max((step_err(n, p), n) for n, p in rgrads.items()
                               if p.grad is not None and float(p.grad.abs().max()) > 0)
        res["ref_moment_bytes"] = sum(v.numel() * v.element_size() for s in opt.state.values()
                                      for k, v in s.items() if k.startswith("exp_avg"))
    return res


def parallel_rank(rank, n, partial):
    """Phase 21's ranks: two processes on cuda:0, joined by gloo. Each part's
    results also go to ``partial`` + rank as soon as they exist, for the
    log of a run that a later part fails."""
    import collections

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calls, nbytes = collections.Counter(), collections.Counter()
    stage_collectives(calls, nbytes)

    from multihmr_tpu_torch.config import VITS, named_config
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.ops import attention, cuda_lib, norm
    from multihmr_tpu_torch.parallel.sharding import make_mesh, shard_state_dict
    from multihmr_tpu_torch.tools.train_smoke import synthetic_batch, train_config
    from multihmr_tpu_torch.train.trainer import BATCH_KEYS, Trainer, to_device
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    fwd_names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    bwd_names = (attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL)
    mesh = make_mesh(n, n, device_type="cuda")  # data 1 x model 2
    out, t0 = {}, time.perf_counter()
    pre = preprocess_array(synthetic_image(0, 480, 640), 896)
    x, K = (torch.from_numpy(a)[None].cuda() for a in (pre.x, pre.K))

    # (a) 896_L, heads TP at model 2, bf16, full width and depth
    cfg = _par_cfg(named_config, "multiHMR_896_L")
    one = build_model(device="cuda", seed=0, cfg=cfg)
    full = {k: v.clone() for k, v in one.net.state_dict().items()}  # fp32, for (c)
    cast_backbone_bf16(one.net)
    bm = one.body_model

    def on_mesh(c, tp_mode, m=None, bf16=True):  # ``full``'s weights, cut for ``m``
        with torch.device("meta"):
            net = MultiHMRNet(c, tp_mode=tp_mode, mesh=m)
        net.load_state_dict(full if m is None else shard_state_dict(full, m, tp_mode),
                            assign=True)
        return MultiHMR(c, bm, net=cast_backbone_bf16(net.eval()) if bf16 else net.eval(),
                        mesh=m)

    with torch.inference_mode():  # the fp32 stream: the control of (a) and (c)
        control = on_mesh(dataclasses.replace(cfg, compute_dtype="float32"), "heads",
                          bf16=False).net.backbone(x)["patch_tokens"].float()
    tp = build_model(device="cuda", seed=0, cfg=cfg, mesh=mesh)  # the same seeded weights, cut
    cast_backbone_bf16(tp.net)
    cuda_lib.reset_launches()  # the heads-TP forward's run starts here
    with torch.inference_mode():
        tp.forward(x, K)
    out["a_launches"] = _launch_tuple(cuda_lib, fwd_names)  # read just after it
    out["a_heads"] = tp.net.backbone.blocks[0].attn.num_heads
    out["a"] = _par_compare(one, tp, x, K, control)
    with torch.inference_mode():  # walls: one rank alone, then both ranks' TP forward
        out["a_ms"] = (wall_ms(lambda: one.forward(x, K), reps=3, warmup=1),
                       wall_ms(lambda: tp.forward(x, K), reps=3, warmup=1))
    del one, tp
    torch.cuda.empty_cache()
    torch.save(out, f"{partial}{rank}.pt")

    # (b) heads TP train steps: 672_S fp32 at 4 blocks (LayerScale 0.5)
    # against one rank, then one 896_L bf16 step at full depth
    cfg4 = dataclasses.replace(train_config("multiHMR_672_S", max_people=4),
                               compute_dtype="float32",
                               vit_override=dataclasses.replace(VITS, depth=4,
                                                                layerscale_init=LAYERSCALE))
    batch = synthetic_batch(2, cfg4.max_people, cfg4.img_size, seed=1)
    out["b4"] = _train_compare(build_model("multiHMR_672_S", device="cuda", seed=0, cfg=cfg4,
                                           mesh=mesh), mesh, batch,
                               lambda: build_model("multiHMR_672_S", device="cuda", seed=0,
                                                   cfg=cfg4), cuda_lib, bwd_names)
    out["b4_launches"] = out["b4"]["launches"]
    out["b4_heads"] = 6 // n
    cfg24 = train_config("multiHMR_896_L", max_people=8)
    big = build_model(device="cuda", seed=0, cfg=cfg24, mesh=mesh)
    trainer = Trainer(big, torch.optim.Adam(big.net.parameters(), lr=5e-6, eps=1e-8), mesh=mesh)
    b1 = synthetic_batch(1, 8, 896, seed=2)
    cuda_lib.reset_launches()  # the full-depth bf16 step's run starts here
    terms = trainer.train_step(to_device({k: b1[k] for k in BATCH_KEYS}, "cuda"), 0)
    torch.cuda.synchronize()
    out["b24_launches"] = _launch_tuple(cuda_lib, bwd_names)
    out["b24"] = {k: float(v) for k, v in terms.items()}
    del big, trainer
    torch.cuda.empty_cache()
    torch.save(out, f"{partial}{rank}.pt")

    # (c) 896_L ring at model 2 against the one-rank standard stream, on
    # (a)'s weights (replicated: the ring shards the sequence)
    one, ring = on_mesh(cfg, "ring"), on_mesh(cfg, "ring", mesh)
    cuda_lib.reset_launches()  # the ring forward's run starts here
    with torch.inference_mode():
        ring.forward(x, K)
    out["c_launches"] = _launch_tuple(cuda_lib, fwd_names)
    out["c"] = _par_compare(one, ring, x, K, control)
    with torch.inference_mode():
        out["c_ms"] = (wall_ms(lambda: one.forward(x, K), reps=3, warmup=1),
                       wall_ms(lambda: ring.forward(x, K), reps=3, warmup=1))
    del one, ring, full, control
    torch.cuda.empty_cache()
    torch.save(out, f"{partial}{rank}.pt")

    # (d) FSDP at data 2 (fsdp_min_size 2^16), fp32 4-block 672_S, one
    # image per rank with unequal valid counts (4 and 1)
    dmesh = make_mesh(n, 1, device_type="cuda")
    bd = synthetic_batch(2, cfg4.max_people, cfg4.img_size, seed=3)
    bd["gt_valid"] = np.array([[1, 1, 1, 1], [0, 1, 0, 0]], np.float32)
    out["d"] = _train_compare(build_model("multiHMR_672_S", device="cuda", seed=0, cfg=cfg4,
                                          mesh=dmesh), dmesh, bd,
                              lambda: build_model("multiHMR_672_S", device="cuda", seed=0,
                                                  cfg=cfg4), cuda_lib, bwd_names)
    out["staged"] = {k: (calls[k], nbytes[k]) for k in calls}
    out["seconds"] = time.perf_counter() - t0
    return out


def check_heads_kernels(attention):
    """K1 and K3 at the head counts tensor parallelism gives 896_L (8 at
    model 2, 4 at model 4) against their plain versions, under phases 3
    and 8's limits."""
    errs = {}
    for heads in (8, 4):
        for n, dt, kv_len in ((4104, torch.bfloat16, 4097), (4097, torch.float32, None)):
            q, k, v = qkv_views(n, dt, heads=heads, seed=heads, kv_len=kv_len)
            out, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=kv_len)
            ref_out, ref_lse = attention.mha_reference_t(q, k, v, kv_len=kv_len)
            ok, e_out, text = fwd_check(out, ref_out, lse, ref_lse)
            do = torch.randn(q.shape, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(5)).to(dt)
            grads = attention._flash_bwd_impl_t(q, k, v, out, lse, do, kv_len=kv_len, fused=True)
            ref = attention.flash_bwd_reference_t(q, k, v, out, lse, do, kv_len=kv_len)
            lim = n if kv_len is None else kv_len
            e3 = [_grad_rel(a[..., :lim], r[..., :lim]) for a, r in zip(grads, ref)]
            ok = ok and all(e <= BWD_TOL[dt] for e in e3)
            name = case_name(n, dt, kv_len, 1).replace(",16,", f",{heads},")
            log(21, f"K1 {name}: {text}; K3 rel err dq/dk/dv "
                    f"{'/'.join(f'{e:.2e}' for e in e3)} (tol {BWD_TOL[dt]:g}) "
                    f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1/K3 at {heads} heads disagree with their plain versions")
            errs[(heads, str(dt)[6:])] = e_out
    return errs


def dp_in_process(build_model, cast_backbone_bf16, cuda_lib, names, card):
    """(e) folder_inference and a data-parallel server over [cuda:0, cuda:0]
    at 672_B batch 8: each person against the same image in its slot of a
    single-device batch-8 forward (SERVE_TOL), and bitwise against the
    single-device forward of the same batch-4 chunk."""
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.parallel.infer import folder_inference

    model = build_model(SERVE, device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    S = model.cfg.img_size
    pres = [preprocess_array(synthetic_image(200 + i, *SERVE_SIZES[i % 3]), S) for i in range(8)]
    images = [p.x for p in pres]
    Ks = np.stack([p.K for p in pres])
    devices = ["cuda:0", "cuda:0"]
    cuda_lib.reset_launches()  # the DP folder run starts here
    got = folder_inference(model, images, Ks, det_thresh=0.3, batch_size=8, mesh=devices)
    launches = _launch_tuple(cuda_lib, names)  # read just after it
    x = torch.from_numpy(np.stack(images)).cuda()
    K = torch.from_numpy(Ks).cuda()
    with torch.inference_mode():
        full = model.extract_persons(model.forward(x, K))
        chunks = sum((model.extract_persons(model.forward(x[i:i + 4], K[i:i + 4]))
                      for i in (0, 4)), [])
    worst, bitwise, counts = 0.0, True, True
    for g, f, c in zip(got, full, chunks):
        counts = counts and len(g) == len(f) == len(c)
        for pg, pf, pc in zip(g, f, c):
            for k in pg:
                a, b = np.asarray(pg[k], np.float64), np.asarray(pf[k], np.float64)
                worst = max(worst, np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
                bitwise = bitwise and np.array_equal(np.asarray(pg[k]), np.asarray(pc[k]))
    n_persons = sum(len(g) for g in got)
    ok = bitwise and launches == DP_LAUNCHES and n_persons > 0
    log(21, f"(e) folder_inference over {devices}, {SERVE} bf16 batch 8: {n_persons} persons, "
            f"each chunk's persons against the same 4 images' single-device forward "
            f"{'bitwise equal' if bitwise else 'NOT bitwise equal'}; launches K1/K2/K5 "
            f"{launches} (want {DP_LAUNCHES}) {'ok' if ok else 'FAIL'}; against the "
            f"single-device batch-8 forward (other GEMM shapes, so other bf16 roundings; "
            f"recorded, not held): person counts {'equal' if counts else 'DIFFER'}, worst "
            f"field error {worst:.3e}")
    from multihmr_tpu_torch.serve.server import build_batched_infer

    single = build_batched_infer(model, max_batch=8)[0]
    chunked = build_batched_infer(model, max_batch=4)[0]
    payloads = [jpeg_bytes(synthetic_image(300 + i, *SERVE_SIZES[i % 3])) for i in range(16)]
    try:
        with Serving(model, max_batch=8, max_delay_ms=5.0, mesh=devices, warmup=False) as s:
            cuda_lib.reset_launches()  # the DP server's run starts here
            res, wall = run_clients(s.port, payloads, 8)
            slaunch = _launch_tuple(cuda_lib, names)  # read just after it
            snap = http_get_json(s.port, "/stats")
            answers = [json.loads(b) if st == 200 else None for st, _, b, _ in res]
            want = tuple(snap["batches"] * c for c in DP_LAUNCHES)
            errs = {"chunk": (0.0, True), "batch8": (0.0, True)}
            for payload, a in zip(payloads, answers):
                if a is None:
                    continue
                for key, b in (("chunk", chunked), ("batch8", single)):
                    ref = slot0_reference(b, payload, S)
                    e, same = errs[key]
                    same = same and ref["count"] == a["count"]
                    for pa, pr in zip(a["persons"], ref["persons"]):
                        e = max(e, json_err(pr, pa))
                    errs[key] = (e, same)
        sok = (all(a is not None for a in answers) and errs["chunk"][1]
               and errs["chunk"][0] <= SERVE_TOL and slaunch == want)
        log(21, f"(e) --dp server over {devices}, max_batch 8: 16 JPEGs from 8 clients in "
                f"{wall:.2f} s, batches {snap['batches']}; each answer against its image in "
                f"slot 0 of a single-device batch-4 forward (the chunk's shape): counts "
                f"{'equal' if errs['chunk'][1] else 'DIFFER'}, worst field error "
                f"{errs['chunk'][0]:.3e} (tol {SERVE_TOL:g}); launches K1/K2/K5 {slaunch} "
                f"(want {want}) {'ok' if sok else 'FAIL'}; against slot 0 of a batch-8 forward "
                f"(recorded): counts {'equal' if errs['batch8'][1] else 'DIFFER'}, worst "
                f"{errs['batch8'][0]:.3e}")
    finally:
        single.close()
        chunked.close()
    if not (ok and sok):
        raise AssertionError("(e) data parallelism in one process disagrees")
    return {"folder": launches, "server": slaunch}


def cli_torchrun(card, tmp):
    """(f) the training CLI's launch path: torchrun (``python -m
    torch.distributed.run --standalone``) with one rank, ``--n_devices 1``,
    on NCCL: the mesh line and two finite steps."""
    import pathlib

    root = pathlib.Path(tmp) / "par_cli"
    write_datasets(root)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "multihmr_tpu_torch.cli.train", "--backbone", "dinov2_vits14",
           "--img_size", "448", "--batch_size", "2", "--max_people", "4",
           "--iter_per_epoch", "2", "--n_epoch", "1", "--valset", "ehf", "--val_n", "1",
           "--n_devices", "1", "--device", "cuda", "--name", "torchrun"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=str(root), env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    text = p.stdout + p.stderr
    loss = text.split("epoch 0: mean loss")[1].split()[0] if "epoch 0: mean loss" in text else "nan"
    mesh_line = "mesh: data=1 x model=1 (heads), fsdp=False" in text
    ok = p.returncode == 0 and mesh_line and np.isfinite(float(loss)) and \
        os.path.exists(os.path.join(root, "ckpts", "torchrun", "ckpt_000000.pt"))
    log(21, f"(f) torchrun --nproc_per_node 1 -m multihmr_tpu_torch.cli.train --n_devices 1 "
            f"(vits14 at 448 px, 2 steps, NCCL): exit {p.returncode}, mesh line "
            f"{'printed' if mesh_line else 'MISSING'}, epoch loss {loss}, {wall:.1f} s [{card}] "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        log(21, "(f) output tail:\n" + text[-3000:])
        raise AssertionError("(f) the torchrun launch failed")


def run_parallel(build_model, cast_backbone_bf16, cuda_lib, attention, norm, card, tmp):
    """Phase 21: multi-device execution on one card. (a)-(d) run in two
    spawned ranks on cuda:0 over gloo (staging what gloo does not take on
    CUDA tensors, ``stage_collectives``); (e) and (f) in this process and a
    torchrun child. Every part runs; the phase fails at its end if any did.
    Returns the phase's launches per kernel (all ranks)."""
    from multihmr_tpu_torch.parallel.launch import run_ranks

    names = (attention.KERNEL, norm.KERNEL, attention.KERNEL_STD)
    failed, launches = [], {}
    t0 = time.perf_counter()

    def part(tag, fn, *args):
        try:
            return fn(*args)
        except Exception:
            failed.append(tag)
            log(21, f"({tag}) FAIL\n" + traceback.format_exc())
            return None

    part("kernels", check_heads_kernels, attention)
    t_ranks = time.perf_counter()
    partial = os.path.join(tmp, "parallel_rank")
    res = part("a-d", run_ranks, parallel_rank, 2, (partial,), "gloo", 4, 300.0)
    t_ranks = time.perf_counter() - t_ranks
    if res is None:  # what the ranks finished before the failure
        for r in range(2):
            if os.path.exists(f"{partial}{r}.pt"):
                o = torch.load(f"{partial}{r}.pt", weights_only=False)
                log(21, f"rank {r} finished before the failure: " + json.dumps(
                    {k: v for k, v in o.items()}, default=str))
    if res is not None:
        ok_all = True
        for r, o in enumerate(res):
            a, c = o["a"], o["c"]
            ok_a = (_par_ok(a) and o["a_launches"] == PAR_LAUNCHES["heads_fwd"]
                    and o["a_heads"] == 8)
            log(21, f"(a) rank {r}: 896_L bf16 heads TP at model 2 ({o['a_heads']} heads per "
                    f"rank, LayerScale {LAYERSCALE:g}), against one rank: {_par_text(a)}; "
                    f"launches K1/K2/K5 {o['a_launches']} (want {PAR_LAUNCHES['heads_fwd']}) "
                    f"{'ok' if ok_a else 'FAIL'}; forward wall one rank {o['a_ms'][0]:.1f} ms, "
                    f"TP {o['a_ms'][1]:.1f} ms (both ranks on one card, 48 all-reduces through "
                    f"gloo: no scaling figure) [{card}]")
            ok_b = o["b4_launches"] == PAR_LAUNCHES["train4"]
            if r == 0:
                b = o["b4"]
                e_terms = max(abs(b["terms"][k] - b["ref_terms"][k]) / max(abs(b["ref_terms"][k]),
                                                                           1e-30)
                              for k in b["ref_terms"] if b["ref_terms"][k] != 0)
                ok_b = (ok_b and e_terms <= TRAIN_TOL and b["grad_err"][0] <= TRAIN_TOL
                        and b["param_err"][0] <= STEP_TOL)
                log(21, f"(b) 672_S fp32 heads TP train step at model 2 ({o['b4_heads']} heads per "
                        f"rank; 4 blocks, LayerScale {LAYERSCALE:g}) against one rank: loss "
                        f"{b['terms']['total']:.4f} vs {b['ref_terms']['total']:.4f} (worst term "
                        f"rel err {e_terms:.2e}), worst gradient rel err {b['grad_err'][0]:.2e} "
                        f"({b['grad_err'][1]}) (tol {TRAIN_TOL:g}); updated parameters where "
                        f"|g| >= 1e-2 max |g|: worst {b['param_err'][0]:.2e} of the step "
                        f"({b['param_err'][1]}) (tol {STEP_TOL:g})")
            ok_b24 = (o["b24_launches"] == PAR_LAUNCHES["train24"]
                      and o["b24"]["finite"] == 1.0 and np.isfinite(o["b24"]["total"]))
            log(21, f"(b) rank {r}: launches K1/K3/K2 4-block fp32 step {o['b4_launches']} (want "
                    f"{PAR_LAUNCHES['train4']}); 896_L bf16 full-depth step loss "
                    f"{o['b24']['total']:.4f}, finite {o['b24']['finite'] == 1.0}, launches "
                    f"{o['b24_launches']} (want {PAR_LAUNCHES['train24']}) "
                    f"{'ok' if ok_b and ok_b24 else 'FAIL'}")
            ok_c = _par_ok(c) and o["c_launches"] == PAR_LAUNCHES["ring_fwd"]
            log(21, f"(c) rank {r}: 896_L bf16 ring at model 2 against the one-rank standard "
                    f"stream: {_par_text(c)}; launches K1/K2/K5 {o['c_launches']} (the ring's "
                    f"per-shard attention is the plain einsum, as the JAX package's) "
                    f"{'ok' if ok_c else 'FAIL'}; forward wall one rank {o['c_ms'][0]:.1f} ms, "
                    f"ring {o['c_ms'][1]:.1f} ms (staged shifts: no scaling figure) [{card}]")
            d = o["d"]
            ok_d = d["fsdp_leaves"] > 0
            if r == 0:
                ratio = d["moment_bytes"] / d["ref_moment_bytes"]
                e_terms = max(abs(d["terms"][k] - d["ref_terms"][k]) / max(abs(d["ref_terms"][k]),
                                                                           1e-30)
                              for k in d["ref_terms"] if d["ref_terms"][k] != 0)
                ok_d = (ok_d and e_terms <= TRAIN_TOL and d["grad_err"][0] <= TRAIN_TOL
                        and d["param_err"][0] <= STEP_TOL and 0.45 <= ratio <= 0.6)
                log(21, f"(d) FSDP at data 2 ({d['fsdp_leaves']} leaves of 2^16 elements and up "
                        f"sharded), 672_S fp32 4 blocks, valid slots per rank "
                        f"{[x['d']['valid_here'] for x in res]}, against one rank: loss "
                        f"{d['terms']['total']:.4f} vs {d['ref_terms']['total']:.4f} (worst term "
                        f"rel err {e_terms:.2e}), worst gradient rel err {d['grad_err'][0]:.2e} "
                        f"({d['grad_err'][1]}) (tol {TRAIN_TOL:g}), updated parameters "
                        f"{d['param_err'][0]:.2e} of the step (tol {STEP_TOL:g}); Adam moments "
                        f"on rank 0 {d['moment_bytes'] / 2**20:.1f} MiB against one rank's "
                        f"{d['ref_moment_bytes'] / 2**20:.1f} MiB ({ratio:.3f}) "
                        f"{'ok' if ok_d else 'FAIL'}")
            staged = ", ".join(f"{k} {c_} calls, {b_ / 2**20:.1f} MiB"
                               for k, (c_, b_) in sorted(o["staged"].items())) or "none"
            log(21, f"rank {r}: staged through host memory: {staged}; the rank's work took "
                    f"{o['seconds']:.1f} s (two ranks sharing one card, staged collectives: "
                    f"no scaling figure) [{card}]")
            ok_all = ok_all and ok_a and ok_b and ok_b24 and ok_c and ok_d
            for k, c_ in zip(names, o["a_launches"]):
                launches[k] = launches.get(k, 0) + c_
            for k, c_ in zip((attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL),
                             tuple(map(sum, zip(o["b4_launches"], o["b24_launches"])))):
                launches[k] = launches.get(k, 0) + c_
        if not ok_all:
            failed.append("a-d")
    log(21, f"ranks spawned, ran and joined in {t_ranks:.1f} s")
    dp = part("e", dp_in_process, build_model, cast_backbone_bf16, cuda_lib, names, card)
    if dp is not None:
        for counts in dp.values():
            for k, c_ in zip(names, counts):
                launches[k] = launches.get(k, 0) + c_
    part("f", cli_torchrun, card, tmp)
    log(21, f"phase 21 took {time.perf_counter() - t0:.1f} s [{card}]")
    if failed:
        raise AssertionError(f"phase 21 parts failed: {failed}")
    return launches


# ---- phase 22: the measurement tools (M12) on the card

SMPLX_SIX = ("multiHMR_672_S", "multiHMR_672_B", "multiHMR_672_L", "multiHMR_896_L",
             "multiHMR_1288_L_bedlam", "multiHMR_1288_L_agora")
# the JAX package's bf16-backbone sensitivity (BASELINE.md "bf16-backbone
# sensitivity", TPU v5e, random init, 12 samples each): (raw p50, raw p99,
# pelvis-centred p50, pelvis-centred p99) in mm
JAX_BF16_MM = {"multiHMR_672_S": (29.3, 80.1, 27.1, 102.2),
               "multiHMR_672_L": (24.0, 44.6, 21.5, 74.3),
               "multiHMR_896_L": (28.8, 95.7, 18.1, 123.0),
               "multiHMR_1288_L_bedlam": (20.2, 43.1, 18.0, 30.5)}
# phase 22's cuts of the tools' defaults, to fit the script's time: chains of
# 4 and 8 forwards and 3 repeats in latency_stats (8, 16 and 5); bf16
# sensitivity at 1 seed and 1 image (2 and 2)
TOOL_ITERS, TOOL_REPEATS = 4, 3


def _depth(name):
    from multihmr_tpu_torch.config import named_config

    return named_config(name).vit.depth


def tools_profile(cuda_lib, attention, norm, card):
    """(a) profile_model over the six SMPL-X configurations at batch 1, bf16,
    heads; 1288_L_bedlam also with --stages and --ops 10, and on ring."""
    from multihmr_tpu_torch.tools import profile_model

    out, ok = {}, True
    runs = [(n, "heads", n == "multiHMR_1288_L_bedlam") for n in SMPLX_SIX]
    runs.append(("multiHMR_1288_L_bedlam", "ring", False))
    for name, tp_mode, deep in runs:
        t0 = time.perf_counter()
        r = profile_model.run(name, 1, TOOL_ITERS, stages=deep, ops=10 if deep else 0,
                              tp_mode=tp_mode, repeats=TOOL_REPEATS, log=lambda m: log(22, m))
        d = _depth(name)
        got = tuple(r["launches"].get(k, 0) for k in (attention.KERNEL, norm.KERNEL,
                                                      attention.KERNEL_STD))
        want = (d, 2 * d, 0) if tp_mode == "heads" else (0, 0, d)
        good = r["finite"] and got == want
        ok = ok and good
        out[(name, tp_mode)] = r
        log(22, f"(a) {name} ({tp_mode}) bf16 batch 1: {r['ms']:.2f} ms/img, outputs "
                f"{'finite' if r['finite'] else 'NOT FINITE'}, launches per forward K1/K2/K5 "
                f"{got} (want {want}), peak memory {r['peak_gib']:.2f} GiB"
                + (f"; vit {r['vit_ms']:.2f} ms, device busy {r['busy_ms']:.2f} ms per forward"
                   if deep else "") + f"; {time.perf_counter() - t0:.1f} s "
                f"{'ok' if good else 'FAIL'} [{card}]")
        del r
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("(a) a configuration's forward is not finite or missed its kernels")
    return out


def tools_capacity(card):
    """(b) sweep_capacity at 672_B and 896_L over 16, 32 and 64 slots."""
    from multihmr_tpu_torch.tools import sweep_capacity

    out = {}
    for name in ("multiHMR_672_B", "multiHMR_896_L"):
        out[name] = [sweep_capacity.run_point(name, cap, iters=TOOL_ITERS, repeats=TOOL_REPEATS)
                     for cap in (16, 32, 64)]
        torch.cuda.empty_cache()
        log(22, f"(b) {name} capacity sweep: " + ", ".join(
            f"K={p['capacity']} {p['ms_per_img']:.2f} ms/img (first call {p['first_call_s']} s)"
            for p in out[name]) + f" [{card}]")
    return out


def tools_bf16(card):
    """(c) bf16_sensitivity at 1 seed, 1 image, 3 persons, beside the JAX
    package's figures."""
    from multihmr_tpu_torch.tools import bf16_sensitivity

    out = {}
    for name, jax_mm in JAX_BF16_MM.items():
        t0 = time.perf_counter()
        r = bf16_sensitivity.run_config(name, 1, 1, 3)
        torch.cuda.empty_cache()
        raw, cen = r["v3d_raw_mm"], r["v3d_pelvis_centered_mm"]
        if r["samples"] != 3 or not all(np.isfinite(v) for v in (*raw.values(), *cen.values())):
            raise AssertionError(f"(c) {name}: {r}")
        out[name] = r
        log(22, f"(c) {name} bf16 against fp32 backbone, {r['samples']} persons: raw v3d "
                f"p50/p99/max {raw['p50']}/{raw['p99']}/{raw['max']} mm, pelvis-centred "
                f"{cen['p50']}/{cen['p99']}/{cen['max']} mm; the JAX package's (TPU v5e, 12 "
                f"samples, BASELINE.md): raw p50/p99 {jax_mm[0]}/{jax_mm[1]}, centred "
                f"{jax_mm[2]}/{jax_mm[3]} mm; {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def tools_eval(card):
    """(d) bench_eval at 672_S over 100 fixture images: the u8 wire, then the
    same pixels normalized on the host (the f32 wire), each pipelined and
    serial; the two wires' F1 equal."""
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.preprocessing import normalize_nhwc
    from multihmr_tpu_torch.tools import bench_eval
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    model = build_model("multiHMR_672_S", device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    u8 = bench_eval.build_fixture_dataset(model, 100, wire="u8")
    thr = bench_eval.calibrate_det_thresh(model, u8[0])
    f32 = [(normalize_nhwc(x), a) for x, a in u8]
    out = {}
    for wire, ds in (("u8", u8), ("f32", f32)):
        e = bench_eval.run(model, ds, thr)
        out[wire] = e
        log(22, f"(d) 672_S eval sweep, {wire} wire, 100 images, det_thresh {thr:.4f}: "
                f"{e['images_per_s']} images/s pipelined ({e['wall_s']} s), serial "
                f"{e['serial_wall_s']} s (speedup {e['pipeline_speedup']}), attributed "
                f"{e['attributed_frac']} of the wall: " + json.dumps(e["phases_s"])
                + f"; {e['persons_detected']} persons, F1 {e['f1']} [{card}]")
    if out["u8"]["f1"] != out["f32"]["f1"] or out["u8"]["persons_detected"] == 0:
        raise AssertionError("(d) the u8 and f32 wires of the same pixels disagree")
    return out


def tools_parity(build_model, named_config, tmp):
    """(e) parity_harness on the card against dumps of the port's CPU plain
    path: 672_S fp32, LayerScale 0.5, a reference-layout checkpoint, three
    seeded JPEGs; det_thresh in the middle of the widest gap of the CPU
    scores, so that a ReLU flip (S1) cannot change a count."""
    from multihmr_tpu_torch.io.preprocessing import get_camera_parameters, open_image
    from multihmr_tpu_torch.tools import parity_harness

    d = os.path.join(tmp, "parity")
    imgs, dumps = os.path.join(d, "imgs"), os.path.join(d, "dumps")
    os.makedirs(imgs)
    os.makedirs(dumps)
    ckpt = os.path.join(d, "multiHMR_672_S.pt")
    write_reference_ckpt(ckpt, "multiHMR_672_S", seed=22)
    for i, (h, w) in enumerate([(480, 640), (720, 540), (600, 600)]):
        with open(os.path.join(imgs, f"p{i}.jpg"), "wb") as f:
            f.write(jpeg_bytes(synthetic_image(220 + i, h, w)))
    cfg = dataclasses.replace(named_config("multiHMR_672_S"), compute_dtype="float32")
    cpu = build_model("multiHMR_672_S", device="cpu", cfg=cfg, checkpoint=ckpt)
    K = torch.from_numpy(get_camera_parameters(672))
    xs = {n: torch.from_numpy(open_image(os.path.join(imgs, n), 672)[0])
          for n in sorted(os.listdir(imgs))}
    with torch.inference_mode():
        scores = [cpu.forward(x, K, det_thresh=0.0)["scores_det"][0].numpy()
                  for x in xs.values()]
    s = np.sort(np.concatenate(scores))[::-1]
    top = min(float(x.max()) for x in scores)
    gap, thr = max((s[i] - s[i + 1], (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1)
                   if s[i] <= top)
    for n, x in xs.items():
        out, stages = parity_harness.capture_stages(cpu, x, K, float(thr), 3)
        dump = {f"stage_{k}": v for k, v in stages.items()}
        for i, p in enumerate(cpu.extract_persons(out)[0]):
            dump.update({f"v3d_{i}": p["v3d"], f"transl_pelvis_{i}": p["transl_pelvis"],
                         f"scores_{i}": p["scores"]})
        np.savez(os.path.join(dumps, n.replace(".jpg", ".npz")), **dump)
    del cpu
    report = os.path.join(d, "report.json")
    rc = parity_harness.main(["--ckpt", ckpt, "--img_folder", imgs, "--reference_dumps", dumps,
                              "--model_name", "multiHMR_672_S", "--det_thresh", repr(float(thr)),
                              "--compute_dtype", "float32", "--json_out", report])
    rep = json.load(open(report))
    worst = {k: max(e["stages"][k]["max_abs"] for e in rep["images"].values())
             for k in next(iter(rep["images"].values()))["stages"]}
    log(22, f"(e) parity_harness 672_S fp32 (LayerScale {LAYERSCALE:g}) card against the CPU "
            f"plain path, 3 JPEGs, det_thresh {thr:.4f} (gap {gap:.4f}): exit {rc}, persons "
            f"{[e['persons_ours'] for e in rep['images'].values()]}, max PVE delta "
            f"{rep['max_pve_mm']:.4f} mm, stage max|d| " + ", ".join(
                f"{k} {v:.2e}" for k, v in worst.items()))
    if rc != 0:
        raise AssertionError(f"(e) parity_harness exited {rc}")
    return rep


def tools_train(cuda_lib, attention, norm, card):
    """(f) multiHMR_1288_L_bedlam training at batch 1 through train_smoke:
    3 steps on heads, remat none (remat auto's choice if that does not fit)."""
    from multihmr_tpu_torch.tools import train_smoke

    policy = "none"
    before = dict(cuda_lib.LAUNCHES)
    try:
        r = train_smoke.run("multiHMR_1288_L_bedlam", batch=1, steps=3, remat_policy=policy,
                            log=lambda m: log(22, m))
    except torch.cuda.OutOfMemoryError:
        from multihmr_tpu_torch.train.memory import choose_remat

        torch.cuda.empty_cache()
        remat, policy, report = choose_remat(train_smoke.train_config("multiHMR_1288_L_bedlam"), 1)
        policy = policy if remat else "none"
        log(22, f"(f) remat none does not fit; remat auto chose {policy}: {report}")
        before = dict(cuda_lib.LAUNCHES)
        r = train_smoke.run("multiHMR_1288_L_bedlam", batch=1, steps=3, remat_policy=policy,
                            log=lambda m: log(22, m))
    per_step = tuple((cuda_lib.LAUNCHES[k] - before.get(k, 0)) / 3 for k in (
        attention.KERNEL, attention.KERNEL_BWD, norm.KERNEL))
    d = _depth("multiHMR_1288_L_bedlam")
    want = (2 * d if policy == "block" else d, d, 4 * d if policy == "block" else 2 * d)
    ok = r["finite"] and all(np.isfinite(r["losses"])) and per_step == want
    log(22, f"(f) 1288_L_bedlam bf16 train step, batch 1, heads, remat {policy}: losses "
            f"{[round(x, 4) for x in r['losses']]}, {r['median_ms']:.1f} ms per step, peak "
            f"memory {r['peak_gib']:.2f} GiB, launches per step K1/K3/K2 {per_step} (want "
            f"{want}) {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("(f) the 1288_L train step is not finite or missed its kernels")
    return r, policy


def run_tools(build_model, named_config, cuda_lib, attention, norm, card, tmp):
    """Phase 22: the measurement tools on the card, (a)-(f). Every part runs;
    the phase fails at its end if any did. Returns (figures, the phase's
    launches per kernel)."""
    failed, figures = [], {}
    t0 = time.perf_counter()

    def part(tag, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            failed.append(tag)
            log(22, f"({tag}) FAIL\n" + traceback.format_exc())
            return None
        finally:
            torch.cuda.empty_cache()
            log(22, f"({tag}) took {time.perf_counter() - t:.1f} s")

    cuda_lib.reset_launches()  # the tools' run starts here
    figures["a"] = part("a", tools_profile, cuda_lib, attention, norm, card)
    figures["b"] = part("b", tools_capacity, card)
    figures["c"] = part("c", tools_bf16, card)
    figures["d"] = part("d", tools_eval, card)
    figures["e"] = part("e", tools_parity, build_model, named_config, tmp)
    figures["f"] = part("f", tools_train, cuda_lib, attention, norm, card)
    launches = dict(cuda_lib.LAUNCHES)
    log(22, f"phase 22 took {time.perf_counter() - t0:.1f} s; launches " + json.dumps(launches)
            + f" [{card}]")
    if failed:
        raise AssertionError(f"phase 22 parts failed: {failed}")
    return figures, launches


# phase 23: DINOv2 ViT-g/14 on the folder path, 8 images of the folder
# cells' four sizes (h, w), and its launches a batch of 8: K1 one a block,
# K2 two a block, all on its wide path (D = 1,536)
VITG = "multiHMR_896_G"
VITG_SIZES = [(480, 640), (720, 1280), (1080, 1920), (600, 900)] * 2
VITG_LAUNCHES = (40, 80, 80)


def run_vitg(build_model, cast_backbone_bf16, cuda_lib, attention, norm, card):
    """Phase 23: ``multiHMR_896_G`` in bf16 through ``folder_inference`` at
    batch 8, after one warm-up call; K1, K2 and K2-wide launches counted from
    0 just before the counted call, then the outputs of one forward of the
    same batch checked finite. Returns (wide launches, K2 wide times)."""
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.parallel.infer import folder_inference

    t = time.perf_counter()
    model = build_model(VITG, device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    built = time.perf_counter() - t
    S = model.cfg.img_size
    pres = [preprocess_array(synthetic_image(300 + i, *hw), S) for i, hw in enumerate(VITG_SIZES)]
    images = [p.x for p in pres]
    Ks = np.stack([p.K for p in pres])
    folder_inference(model, images, Ks, det_thresh=0.3, batch_size=8)  # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()  # the counted folder run starts here
    t = time.perf_counter()
    got = folder_inference(model, images, Ks, det_thresh=0.3, batch_size=8)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    launches = tuple(cuda_lib.LAUNCHES[k] for k in (attention.KERNEL, norm.KERNEL,
                                                    norm.KERNEL_WIDE))  # read just after it
    with torch.inference_mode():
        out = model.forward(torch.from_numpy(np.stack(images)).cuda(), torch.from_numpy(Ks).cuda())
    finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                 if torch.is_tensor(v) and v.is_floating_point())
    ok = launches == VITG_LAUNCHES and finite
    log(23, f"{VITG} bf16 through folder_inference, batch 8 (built in {built:.1f} s): "
            f"{sum(len(g) for g in got)} persons, {wall:.1f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches K1/K2/K2 wide "
            f"{launches} (want {VITG_LAUNCHES}); outputs finite={finite} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError(f"{VITG} main path check failed")
    del model, out, got
    torch.cuda.empty_cache()
    return launches[2], time_k2(norm, card, D=1536, phase=23)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    card = device_line("cuda")
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
    mutants = phase(12, check_mutants, attention, norm, cuda_lib)
    k5_times = phase(12, time_k5, attention, cuda_lib, card)
    phase(13, check_e2e, build_model, named_config, demo, cuda_lib, attention, norm, 13, "ring")
    phase(13, check_train_e2e, cuda_lib, attention, norm, 13, "ring")
    fwd_streams = phase(13, check_streams_896, build_model, named_config, demo,
                        cast_backbone_bf16, cuda_lib, attention, norm, card)
    torch.cuda.empty_cache()
    cli_launches = phase(14, run_cli, cuda_lib, attention, norm)
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    try:
        ref = phase(15, run_reference_ckpt, build_model, named_config, demo, cast_backbone_bf16,
                    cuda_lib, attention, norm, card, tmp)
        torch.cuda.empty_cache()
        if ref is not None:
            phase(16, run_3dpw_cli, build_model, cuda_lib, attention, norm, card, ref[0])
        anny = phase(17, run_anny, build_model, demo, cast_backbone_bf16, cuda_lib, attention,
                     norm, card, tmp)
        torch.cuda.empty_cache()
        serving = phase(18, run_serving, build_model, demo, cast_backbone_bf16, cuda_lib,
                        attention, norm, card, tmp)
        torch.cuda.empty_cache()
        exported = phase(19, run_export, build_model, cast_backbone_bf16, cuda_lib, attention,
                         norm, card, tmp, serving and serving["sat"])
        torch.cuda.empty_cache()
        io_figures = phase(20, run_io, build_model, named_config, demo, cast_backbone_bf16,
                           cuda_lib, attention, norm, card, tmp, ref and ref[0])
        torch.cuda.empty_cache()
        par = phase(21, run_parallel, build_model, cast_backbone_bf16, cuda_lib, attention, norm,
                    card, tmp)
        torch.cuda.empty_cache()
        tools = phase(22, run_tools, build_model, named_config, cuda_lib, attention, norm, card,
                      tmp)
        torch.cuda.empty_cache()
        vitg = phase(23, run_vitg, build_model, cast_backbone_bf16, cuda_lib, attention, norm,
                     card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed or None in (fwd, bwd_check, train, bwd, k5_err, mutants, k5_times, fwd_streams,
                          cli_launches, ref, anny, serving, exported, io_figures, par, tools,
                          vitg):
        log("end", f"failed phases: {failed}")
        return 1
    launches, steps = train
    bwd_err, two_pass = bwd_check
    launches.update(two_pass)  # K4a/K4b: the two-pass path of phase 8
    launches[attention.KERNEL_STD] = cli_launches[attention.KERNEL_STD]  # K5: phase 14's ring run
    for name, count in par.items():  # phase 21's multi-rank and data-parallel runs
        launches[name] = launches.get(name, 0) + count
    tool_figures, tool_launches = tools
    for name, count in tool_launches.items():  # phase 22's tools
        launches[name] = launches.get(name, 0) + count
    launches[norm.KERNEL_WIDE], k2_wide_times = vitg  # phase 23's folder run
    for label, (ms, peak) in steps.items():
        log("end", f"896_L bf16 train step, batch 2, {label}: {ms:.1f} ms, peak memory "
                   f"{peak:.2f} GiB [{card}]")
    log("end", f"896_L bf16 forward, batch 1: heads {fwd['fwd_ms']:.3f} ms (phase 7); "
               f"heads {fwd_streams['heads']:.3f} ms, ring {fwd_streams['ring']:.3f} ms "
               f"(phase 13) [{card}]")

    nbytes, t_load, t_conv = anny["file"]
    log("end", f"{ANNY}: file {nbytes / 2**20:.1f} MiB, load {t_load:.2f} s, convert "
               f"{t_conv:.2f} s; demo p50 heads {anny['p50']['heads']:.1f} ms, ring "
               f"{anny['p50']['ring']:.1f} ms per image; forward wall / device busy / body "
               f"model: " + ", ".join(f"{tp} {anny[tp][0]:.2f} / {anny[tp][1]:.2f} / "
                                      f"{anny[tp][2]:.2f} ms" for tp in ("heads", "ring"))
               + f"; FK {anny['fk'][0]} launches per call [{card}]")

    for label, f in serving["sat"].items():
        if label == "alone":
            continue
        log("end", f"{SERVE} bf16 serving, batch 8, {label}: {f['img_s']:.2f} images/s, client "
                   f"latency p50 {f['p50']:.1f} / p95 {f['p95']:.1f} ms, mean batch "
                   f"{f['mean_batch']}" + ("" if f["busy"] is None else
                                           f", card busy {100 * f['busy']:.1f} %")
                   + f" [{card}]")

    ex = exported["a"]
    log("end", f"{SERVE} bf16 batch 8 artifacts: heads export {ex['heads']['secs'][0]:.2f} s, "
               f"load {ex['heads']['secs'][2]:.2f} s, {ex['heads']['mib']:.1f} MiB; ring "
               f"export {ex['ring']['secs'][0]:.2f} s; forward wall live "
               f"{exported['c']['fwd']['live'][1]:.2f} / artifact "
               f"{exported['c']['fwd']['artifact'][1]:.2f} ms; artifact server "
               f"{exported['d']['sat']['full']['img_s']:.2f} images/s [{card}]")
    lib = io_figures["a"]
    log("end", "image library: " + ("not available (the libjpeg/libpng probe fails)" if lib is None
                                    else f"preprocess_file {lib['ms_native']:.2f} ms against PIL "
                                    f"decode + preprocess_array {lib['ms_pil']:.2f} ms per 1280x720 "
                                    f"JPEG at 896; loader " + ", ".join(
                                        f"{k} thread(s) {v:.1f} images/s"
                                        for k, v in lib["rates"].items()))
               + f"; demo p50 {io_figures['b']['demo']:.1f} ms per image against the PIL loop's "
               f"{io_figures['b']['pil']:.1f} [{card}; {host_cpu()}]")
    prof22 = tool_figures["a"]
    log("end", "profile_model bf16 batch 1, ms/img (latency_stats slope, "
               f"{TOOL_ITERS}/{2 * TOOL_ITERS}-forward chains): " + ", ".join(
                   f"{n} {tp} {r['ms']:.2f}" for (n, tp), r in prof22.items())
               + f"; 1288_L_bedlam device busy {prof22[(SMPLX_SIX[4], 'heads')]['busy_ms']:.2f} ms "
               f"per forward [{card}]")
    step22, policy22 = tool_figures["f"]
    log("end", f"1288_L_bedlam bf16 train step, batch 1, heads, remat {policy22}: "
               f"{step22['median_ms']:.1f} ms, peak memory {step22['peak_gib']:.2f} GiB [{card}]")
    # launches per batch through the 672_B artifacts (phase 19 (a)): K1 and
    # K2 on heads, K5 on ring; the backward kernels are not in an export
    artifact_launches = {attention.KERNEL: ex["heads"]["launches"][0],
                         norm.KERNEL: ex["heads"]["launches"][1],
                         attention.KERNEL_STD: ex["ring"]["launches"][2]}

    def entry(name, source, replaces, err, times):
        ms, plain_ms, library_ms, b_ms, b_by = times
        return {"name": name, "route": "cuda", "source": f"multihmr_tpu_torch/csrc/{source}",
                "replaces": f"multihmr_tpu/ops/{replaces}",
                "launches": launches.get(name, 0), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, "artifact_launches": artifact_launches.get(name, 0)}

    kernels = [
        entry(attention.KERNEL, "flash_fwd.cu", "attention.py:399", k1_err, fwd["k1"]),
        entry(norm.KERNEL, "layernorm_cm.cu", "norm.py:26", k2_err[norm.KERNEL], fwd["k2"]),
        entry(norm.KERNEL_WIDE, "layernorm_cm.cu", "norm.py:26", k2_err[norm.KERNEL_WIDE],
              k2_wide_times),
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
