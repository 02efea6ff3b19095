"""Distillation traffic: a closed loop of training steps.

Set-up builds one training step (teacher, student, optimizer), drives it
through its first ``checked_steps`` steps on fresh seeded pose batches
(through the same feed and call as the window, so they warm up every
shape), records what the check needs, and hands the same objects to the
window.  Each step: a pose batch from the distillation pose distribution
for (seed, step), drawn on the host and moved to the card, as the trainer
feeds it, then one call of the recipe's group at the phase's lr and loss
weights.  The window ends in a synchronize.

After the window the program is freed and the plain float32 reference
follows the checked steps from the same inputs: the first gradient (from
Adam's first moment after one step) and the parameters' change after the
checked steps, each by its worst leaf.  Each of the teacher's five
networks is held alone on the inputs that the program gave it in those
steps: the reference network on them, against the program's outputs (the
labels end to end and each step's loss are reported beside them).  The
control puts the reference in float8 operands in the program's place and
measures no window.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark.reference import teacher07


def _snapshot(student) -> dict:
    return {name: p.detach().clone() for name, p in student.named_parameters()}


def run(ctx) -> dict:
    traffic, cfg, config = ctx.traffic, ctx.cfg, ctx.config
    device = torch.device(ctx.device)
    data = config.inputs(cfg, ctx.seed, device)
    checked, rows = traffic["checked_steps"], traffic["reference_rows"]
    if ctx.program == "control":
        # The reference in float8 operands in the program's place: its
        # checked steps are what is judged, and no window is measured.
        record = {"setup_s": 0.0, "window_s": 0.0, "units": 0, "examples": 0, "attempted": 0, "spans": {},
                  "memory_peak_bytes": 0}
        prog_state = config.reference_steps(cfg, data, ctx.seed, checked, rows, device, operand=config.teacher07.fp8)
    else:
        record, prog_state = _window(ctx, data, checked, device)
    ref = config.reference_steps(cfg, data, ctx.seed, checked, rows, device)
    gaps = compare(prog_state, ref)
    del ref
    by_output = config.teacher_gaps(cfg, data, ctx.seed, rows, device, prog_state["teacher"])
    gaps.update({stage: max(g) for stage, g in by_output.items()})
    record.update({
        "failed": 0,
        "per_unit": config.per_unit(cfg),
        "dtype": cfg["training"]["dtype"],
        "compared": {"steps": checked, "leaves_in_change": gaps["leaves_in_change"], "loss": gaps["loss"],
                     "labels": gaps["by_label"], "teacher": by_output},
        "checks": [(name, gaps[name], ctx.limits[name]) for name in ctx.limits],
    })
    return record


def _window(ctx, data, checked: int, device):
    """The program's set-up, checked steps and window: (record, state)."""
    cfg, config, rec = ctx.cfg, ctx.config, ctx.recorder
    batch = cfg["training"]["batch_size"]
    prog = config.program(cfg, data, device)
    beta1 = prog.optimizer.defaults["betas"][0]

    def step(k: int):
        lr, weights = config.phase_at(cfg, k * batch)
        poses = config.pose_batch(cfg, ctx.seed, k, batch).to(device)
        with rec.span("group"):
            return prog.group(prog.student, prog.optimizer, [poses], [lr], [weights])

    p0 = _snapshot(prog.student)
    losses, grad1, teacher = [], None, []
    with config.teacher_tap(teacher):  # the teacher's outputs of the checked steps, as the group makes them
        for k in range(checked):
            losses.append(step(k)["loss"].detach().clone())
            if k == 0:
                grad1 = {name: (prog.optimizer.state[p]["exp_avg"] / (1.0 - beta1)) if p in prog.optimizer.state
                         else torch.zeros_like(p) for name, p in prog.student.named_parameters()}
    p_checked = _snapshot(prog.student)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec.spans.clear()

    k = checked
    rec.start_window()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    t_end = t_start + ctx.seconds
    while time.perf_counter() < t_end:
        step(k)
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_start
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.end_window()
    steps = k - checked
    state = {"losses": [float(x) for x in losses], "grad1": grad1, "p0": p0, "p_checked": p_checked, "teacher": teacher}
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record = {"setup_s": setup_s, "window_s": window_s, "units": steps, "examples": steps * batch, "attempted": steps,
              "spans": dict(rec.spans), "memory_peak_bytes": memory_peak}
    return record, state


def compare(prog: dict, ref: dict) -> dict:
    """Each checked step's loss, relative to the reference's; the first
    gradient's and the parameters' change's norms, each leaf's gap relative
    to the larger of that leaf's reference norm and the median leaf's, the
    worst leaf; the teacher's four labels of each checked step, the distance
    to the reference's relative to its norm, the worst step's.  Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out of the change: Adam moves them by rounding alone."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = {n: float(g.double().norm()) for n, g in ref["grad1"].items()}
    g_med = statistics.median(g_ref.values())
    grad = max(abs(float(prog["grad1"][n].double().norm()) - g) / max(g, g_med) for n, g in g_ref.items())
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    d_ref = {n: float((ref["p_checked"][n].double() - ref["p0"][n].double()).norm()) for n in moved}
    d_med = statistics.median(d_ref.values())
    change = max(
        abs(float((prog["p_checked"][n].double() - prog["p0"][n].double()).norm()) - d) / max(d, d_med) for n, d in d_ref.items()
    )
    pairs = [(teacher07.labels_of(step), step_ref) for step, step_ref in zip(prog["teacher"], ref["labels"])]
    by_label = [max(_rel(got[i], want[i]) for got, want in pairs) for i in range(len(ref["labels"][0]))]
    return {"loss": loss, "grad": grad, "change": change, "leaves_in_change": len(moved), "by_label": by_label}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(b.device).double() - b.double()).norm() / b.double().norm())
