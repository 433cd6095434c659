"""Training steps: ``train/trainer.py::make_train_step`` with Adam.

Set-up builds one training step (the model with seeded fp32 weights, bf16
ViT compute, ``torch.optim.Adam`` as ``cli/train.py`` makes it) and drives
it through its first ``checked_steps`` steps on distinct batches, through
the same call and upload (``trainer.py::to_device``) as the window, keeping
each step's loss, every leaf's first gradient as Adam's state holds it
after one step, and every element's change after the last of them (on the
host, for the comparison after the window). The window
then runs the same object over a pool of collated batches made from the
seed, as a BEDLAM loader gives them.

Traffic parameters: ``batch``, ``batches`` (the pool), ``frame_sizes``,
``max_humans``, ``lr``, ``checked_steps``, ``trace_at_s``, ``trace_s``.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import harness, inputs, judge
from portbench.loops import common
from portbench.reference import train as ref_train
from portbench.trace import SubWindow, span


class State:
    pass


def setup(cell) -> State:
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.train import trainer

    from portbench import weights

    t, s = cell.traffic, State()
    common.tf32_off()
    cfg = cell.model_config()
    net, _, _ = weights.load(MultiHMRNet, cfg, cell.config, cell.seed, cell.device)
    body = BodyModel.from_arrays(inputs.body_model(cell.config["body_model"], cell.seed),
                                 cell.device)
    s.model = MultiHMR(cfg, body, net=net)
    s.opt = torch.optim.Adam(s.model.net.parameters(), lr=t["lr"], eps=1e-8)
    s.step = trainer.make_train_step(s.model, s.opt)
    s.to_device = trainer.to_device
    s.pool = inputs.train_batches(t, cfg.img_size, cfg.max_people, cell.seed, cell.device)
    named = list(s.model.net.named_parameters())
    start = {k: v.detach().clone() for k, v in named}
    s.losses, s.terms, s.finite = [], [], []
    for i in range(t["checked_steps"]):
        terms = s.step(s.to_device(s.pool[i], cell.device), 0)
        s.losses.append(float(terms["total"]))
        s.terms.append({k: float(terms[k]) for k in ref_train.WEIGHTS})
        s.finite.append(float(terms["finite"]))  # 0: a term was not finite and counts as 0
        if i == 0:
            beta1 = s.opt.param_groups[0]["betas"][0]
            s.grad1 = {k: float(s.opt.state[v]["exp_avg"].norm()) / (1 - beta1)
                       if v in s.opt.state else 0.0 for k, v in named}
    s.delta = {k: (v.detach() - start[k]).cpu() for k, v in named}  # judged after the window
    del start
    common.sync(cell.device)
    return s


def window(cell, s: State) -> dict:
    from multihmr_tpu_torch.ops import cuda_lib

    t = cell.traffic
    sub = SubWindow(cell.trace, t["trace_at_s"], t["trace_s"])
    cuda_lib.reset_launches()
    steps, spans = 0, []
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        sub.at(now - t0)
        if now - t0 >= cell.seconds:
            break
        batch = s.pool[t["checked_steps"] + steps % (len(s.pool) - t["checked_steps"])]
        with span("train.step"):
            a = time.perf_counter()
            s.step(s.to_device(batch, cell.device), 0)
            spans.append((a, time.perf_counter()))
        steps += 1
    common.sync(cell.device)
    t_end = time.perf_counter()
    sub.close()
    s.traced_units = sum(1 for a, b in spans if sub.active(a, b))
    per = lambda k: cuda_lib.LAUNCHES.get(k, 0) / max(steps, 1)  # noqa: E731
    return {"attempted": steps, "failed": 0, "trace": sub.result(),
            "metrics": {"train_step_ms": 1e3 * (t_end - t0) / steps},
            "notes": {"K1/K3/K2 per step": (per("flash_fwd_t"), per("flash_bwd_fused_t"),
                                            per("layernorm_cm")),
                      "checked losses": s.losses, "checked steps' finite flags": s.finite}}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared. ``loss1_gap``: the first step's loss against
    the reference's (relative); ``loss_gap``: the worst of the checked
    steps'; ``term_gap``: the worst of the checked steps' weighted loss
    terms, over the reference's total loss; ``grad_gap``: the worst leaf's
    first-gradient norm against the larger of its reference norm and the
    median leaf's (``grad_gap_p50``: the median leaf's, ``grad_gap_p90``:
    the ninth decile's); ``change_gap``, ``change_gap_p50`` and
    ``change_gap_p90`` the same of each leaf's change after the checked
    steps, over the elements that the reference's first gradient moves
    (``steps``' ``still`` are left out)."""
    out = {"loss1_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
           "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
           "term_gap": max(ref_train.WEIGHTS[k] * abs(p[k] - r[k]) / abs(total)
                           for p, r, total in zip(prog["terms"], ref["terms"], ref["losses"])
                           for k in r)}
    change = {}
    for who, d in (("prog", prog), ("ref", ref)):
        change[who] = {k: float(d["delta"][k].to(ref["still"][k].device)[~ref["still"][k]].norm())
                       for k in ref["still"] if not bool(ref["still"][k].all())}
    for name, a, b in (("grad_gap", prog["grad1"], ref["grad1"]),
                       ("change_gap", change["prog"], change["ref"])):
        med = statistics.median(b.values())
        gap = {k: abs(a[k] - b[k]) / max(b[k], med) for k in b}
        out[name] = max(gap.values())
        out[name + "_p50"] = statistics.median(gap.values())
        out[name + "_p90"] = statistics.quantiles(gap.values(), n=10)[-1]
        harness.log(f"{name}, widest leaves (gap, program, reference): " + "; ".join(
            f"{k} {gap[k]:.4g} {a[k]:.6g} {b[k]:.6g}"
            for k in sorted(gap, key=gap.get, reverse=True)[:4]))
    harness.log("checked losses (program, reference): " + "; ".join(
        f"{a:.6g} {b:.6g}" for a, b in zip(prog["losses"], ref["losses"])))
    harness.log("checked terms by step (program, reference): " + " | ".join(
        ", ".join(f"{k} {p[k]:.6g} {r[k]:.6g}" for k in r)
        for p, r in zip(prog["terms"], ref["terms"])))
    return out


def _free(cell, s: State):
    for k in ("model", "opt", "step"):
        s.__dict__.pop(k, None)
    torch.cuda.empty_cache() if cell.device.type == "cuda" else None


def _reference(cell, s: State, control: bool) -> dict:
    ref = judge.reference(cell, control=control, remat=True)
    n = cell.traffic["checked_steps"]
    return ref_train.steps(ref, s.pool[:n], cell.traffic["lr"], n)


def check(cell, s: State) -> dict:
    _free(cell, s)
    return compare({"losses": s.losses, "terms": s.terms, "grad1": s.grad1, "delta": s.delta},
                   _reference(cell, s, control=False))


def control(cell, s: State) -> dict:
    """The control (the reference one precision step down) in the program's
    place, against the reference."""
    _free(cell, s)
    ctrl = _reference(cell, s, control=True)
    ctrl["delta"] = {k: v.cpu() for k, v in ctrl["delta"].items()}
    return compare(ctrl, _reference(cell, s, control=False))
