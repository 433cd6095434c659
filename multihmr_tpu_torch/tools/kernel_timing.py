"""Card times of the flash kernels and of the 896_L forward, for A/Bs, ablations and profiles.

    python -m multihmr_tpu_torch.tools.kernel_timing ab TREE [TREE ...]
    python -m multihmr_tpu_torch.tools.kernel_timing variants
    python -m multihmr_tpu_torch.tools.kernel_timing forward [--tp_mode heads|ring] [--ops 20]

``ab``: one turn per TREE, in the order given (old new new old for an A/B):
a fresh process, run from that tree's root, builds that tree's kernels and
runs its own ``chip_smoke.py`` phases 7 and 11 (the 896_L bf16 forward at
batch 1 and the forward kernels' times; the backward kernels' times). A
TREE is a checkout holding ``chip_smoke.py`` and the port, e.g. the parent
commit unpacked with ``git archive``.

``variants``: K1 and K3 at the 896_L shape ([1, 16, 64, 4104], kv_len
4097, bf16) against textual variants of their sources, each with one part
of the work removed or done another way (``VARIANTS``), built beside the
sound library with ``cuda_lib.build_variants``; turns sound, variant,
variant, sound for each, CUDA events. What a variant saves is what that part
costs on the kernel's critical path.

``forward``: the 896_L bf16 forward at batch 1 on one stream (seeded random
weights, a seeded random image): CUDA events around back-to-back forwards,
then ``torch.profiler`` over three: the wall and the device's busy time per
forward and the ``--ops`` kernels with the most device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

# (source, C entry) -> {variant: [(old, new), ...]}
_K1_EXP = "fast_exp2(s[nt][2 * r]"
_K1_EXP1 = "fast_exp2(s[nt][2 * r + 1]"
_K3_EXP = "fast_exp2(fmaf(s[nt][i], scale_log2, -tLse[c] * kLog2e))"
VARIANTS = {
    ("flash_fwd.cu", "mhmr_flash_fwd_t"): {
        "exp2f (accurate) for ex2.approx": [
            (_K1_EXP, "exp2f(s[nt][2 * r]"), (_K1_EXP1, "exp2f(s[nt][2 * r + 1]"),
            ("fast_exp2(row_max[r] - mx)", "exp2f(row_max[r] - mx)")],
        "no exp2": [(_K1_EXP + " - mx)", "(s[nt][2 * r] - mx)"),
                    (_K1_EXP1 + " - mx)", "(s[nt][2 * r + 1] - mx)")],
        "no S = q k^T product": [("      wgmma_m64n64k16_ss<1, 1>(s, ",
                                  "      if (0) wgmma_m64n64k16_ss<1, 1>(s, ")],
        "no P.V product": [("      wgmma_m64n64k16<0>(o, pf[kk]",
                            "      if (0) wgmma_m64n64k16<0>(o, pf[kk]")],
        "no k/v copies after the first kStages - 1 tiles": [
            ("      if (jn < n_tiles) {", "      if (0 && jn < n_tiles) {")],
    },
    ("flash_bwd.cu", "mhmr_flash_bwd_t"): {
        "exp2f (accurate) for ex2.approx": [(_K3_EXP, _K3_EXP.replace("fast_exp2", "exp2f"))],
        "no exp2": [(_K3_EXP, _K3_EXP.replace("fast_exp2", ""))],
        "no S^T/dP^T products": [
            ("      wgmma_m64n64k16_ss<1, 1>(s, ", "      if (0) wgmma_m64n64k16_ss<1, 1>(s, "),
            ("      wgmma_m64n64k16_ss<1, 1>(ds, ", "      if (0) wgmma_m64n64k16_ss<1, 1>(ds, ")],
        "no dV/dK products": [
            ("      wgmma_m64n64k16<0>(dv_acc, ap[kk]", "      if (0) wgmma_m64n64k16<0>(dv_acc, ap[kk]"),
            ("      wgmma_m64n64k16<0>(dk_acc, as[kk]", "      if (0) wgmma_m64n64k16<0>(dk_acc, as[kk]")],
        "no dq product": [("      wgmma_m64n32k16_ss<1, 0>(", "      if (0) wgmma_m64n32k16_ss<1, 0>(")],
        "no dq bulk reduce": [("      bulk_reduce_add_f32(dqb", "      if (0) bulk_reduce_add_f32(dqb")],
        "no q/dO copies after the first tile": [
            ("    if (t + 1 < n_tiles)\n", "    if (0 && t + 1 < n_tiles)\n")],
    },
}


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters, reps=5, warmup=3):
    """ms per fn(): CUDA events around `iters` back-to-back calls, median of `reps`."""
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
    return sorted(times)[reps // 2]


def ab(trees) -> int:
    for tree in trees:
        print(f"== turn: {os.path.abspath(tree)}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "_turn"],
                            cwd=tree).returncode
        if rc:
            return rc
    return 0


def _turn() -> int:
    sys.path.insert(0, os.getcwd())  # this tree's chip_smoke.py and port
    import chip_smoke as cs
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.ops import attention, cuda_lib, norm
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    card = cs.nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, secs = cuda_lib.build()
    print(f"kernels built in {secs:.1f} s", flush=True)
    model = build_model("multiHMR_896_L", device="cuda", seed=0)
    cast_backbone_bf16(model.net)
    cs.time_forward(model, attention, norm, card)
    del model
    torch.cuda.empty_cache()
    cs.time_bwd(attention, card)
    return 0


def variants() -> int:
    from multihmr_tpu_torch.ops import attention, cuda_lib

    card = _card()
    cuda_lib.build()
    n = 4097
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((1, 3 * 16 * 64, n + 7), device="cuda", generator=g).to(
        torch.bfloat16).reshape(1, 3, 16, 64, n + 7).unbind(1)
    o, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=n)
    do = torch.randn(q.shape, device="cuda", generator=g).to(torch.bfloat16)
    dd = (do.float() * o.float()).sum(2)
    outs = [torch.empty_like(o) for _ in range(3)]
    calls = {
        "mhmr_flash_fwd_t": lambda: attention._flash_fwd_impl_t(q, k, v, kv_len=n),
        "mhmr_flash_bwd_t": lambda: attention._flash_bwd_t_cuda(
            attention.KERNEL_BWD, q, k, v, do, lse, dd, 64 ** -0.5, n, *outs),
    }
    with tempfile.TemporaryDirectory() as tmp:
        builds = {key: cuda_lib.build_variants(key[0], table, tmp)
                  for key, table in VARIANTS.items()}
        for (source, entry), table in builds.items():
            fn = calls[entry]
            for name, build in table.items():
                turns = []
                for use in (False, True, True, False):
                    if use:
                        with cuda_lib.use_variant(name, build, entry):
                            turns.append(_cuda_ms(fn, iters=20))
                    else:
                        turns.append(_cuda_ms(fn, iters=20))
                sound, var = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                print(f"{source} [1,16,64,4104] kv_len 4097 bf16, {name}: {var:.4f} ms against "
                      f"{sound:.4f} sound (turns {'/'.join(f'{t:.4f}' for t in turns)}) "
                      f"[{card}]", flush=True)
    return 0


def forward(tp_mode: str, top: int) -> int:
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.tools.train_smoke import profile_steps
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model("multiHMR_896_L", device="cuda", seed=0, tp_mode=tp_mode)
    cast_backbone_bf16(model.net)
    x = torch.randn((1, 896, 896, 3), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    K = torch.tensor([[[776.0, 0, 448], [0, 776.0, 448], [0, 0, 1]]], device="cuda")
    with torch.inference_mode():
        ms = _cuda_ms(lambda: model.forward(x, K), iters=5)
        print(f"896_L bf16 forward ({tp_mode}), batch 1: {ms:.3f} ms (CUDA events) [{card}]")
        profile_steps(lambda batch, epoch: model.forward(x, K), None, top, steps=3)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ab", help="phases 7 and 11 of each tree in turn")
    p.add_argument("trees", nargs="+")
    sub.add_parser("variants", help="K1 and K3 against textual variants")
    p = sub.add_parser("forward", help="time and profile the 896_L forward")
    p.add_argument("--tp_mode", default="heads", choices=("heads", "ring"))
    p.add_argument("--ops", type=int, default=20)
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
    return forward(args.tp_mode, args.ops)


if __name__ == "__main__":
    raise SystemExit(main())
