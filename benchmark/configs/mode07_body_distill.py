"""mode07_body_distill: the body student's distillation step, both sides.

``inputs`` makes the teacher's and the student's weights and the character
from the seed on the device; ``program`` builds the port's step as
``DistillationJobs.make_body_trainer`` builds it (the teacher frozen in
bf16, ``recipes.make_body_distill_group`` with the selective-f32 student,
Adam); ``reference_steps`` follows the first steps in plain float32
PyTorch, and in float8 operands as the control; ``teacher_gaps`` holds
each teacher network alone on the inputs that the program gave it;
``per_unit`` counts a step's FLOPs and K6's bound.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
from types import SimpleNamespace
from typing import Dict

import torch

from benchmark import counts, inputs as bench_inputs
from benchmark.reference import student14, teacher07

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
NETWORKS = ("eyebrow_decomposer", "eyebrow_morphing_combiner", "face_morpher", "body_morpher", "upscaler")
ENCODER_DECODERS = NETWORKS[:3]
GRID_CONVS = ("morphed_eyebrow_layer_grid_change.weight", "iris_mouth_grid_change.weight")


@functools.lru_cache(maxsize=4)
def _table(teacher_json: str):
    """The teacher's (net, key) -> shape table and K6 sites of one call at
    B = 1, from the reference's forward on meta tensors."""
    W = teacher07.Weights(None)
    with torch.device("meta"):
        teacher07.labels(W, json.loads(teacher_json), torch.empty(1, 4, 512, 512), torch.empty(1, 45))
    return dict(W.table), tuple(W.k6_sites)


def table(cfg: dict):
    return _table(json.dumps(cfg["teacher"], sort_keys=True))


def _teacher_init(name: str, shape, table_: dict, a: dict):
    """(kind, scale) of one teacher tensor: 'u' draws U(-scale, scale), 'n'
    N(0, scale), 'c' the constant scale.  The networks' own inits, with the
    zero-init layers brought to life by charmodel/synthetic.random_teacher_07's
    rule: residual convs at ``residual_scale`` of torch's default, the U-Nets'
    last convs N(0, head_std) with grid rows N(0, flow_std) and a zero grid
    bias, the grid-change convs N(0, flow_std)."""
    net, key = name.split(".", 1)
    if key.endswith(".bias"):
        w_shape = table_.get(name[:-5] + ".weight")
    else:
        w_shape = shape
    norm = w_shape is not None and len(w_shape) == 1
    if norm:
        return ("c", 0.0) if key.endswith(".bias") else ("c", 1.0)
    fan_in = math.prod(w_shape[1:])
    default = 1.0 / math.sqrt(fan_in)
    if net in ENCODER_DECODERS:
        if key in GRID_CONVS:
            return "n", a["flow_std"]
        return ("u", default) if key.endswith(".bias") else ("n", math.sqrt(2.0 / fan_in))
    residual = (".conv1." in key or (".attention_blocks." in key and ".conv." in key) or ".module.conv." in key
                or key.startswith("coarse_image_conv."))
    if residual:
        return "u", a["residual_scale"] * default
    if key.startswith("body.last.2."):
        return "n", a["head_std"]
    return "u", default


def inputs(cfg: dict, seed: int, device) -> dict:
    """{teacher: {net: {key: f32}}, student: {name: f32}, image: (S, S, 4)},
    from the seed: the teacher from one uniform and one normal draw."""
    shapes, _ = table(cfg)
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    u = bench_inputs.uniform(seed, total, device, stream=10)
    g = bench_inputs.normal(seed, total, device, stream=11)
    teacher: Dict[str, Dict[str, torch.Tensor]] = {net: {} for net in NETWORKS}
    offset = 0
    for name in names:
        shape = shapes[name]
        size = math.prod(shape)
        kind, scale = _teacher_init(name, shape, shapes, cfg["assumed"])
        if kind == "c":
            t = torch.full(shape, scale, device=device)
        else:
            t = (u if kind == "u" else g)[offset : offset + size].view(shape) * scale
        net, key = name.split(".", 1)
        if net in ("body_morpher", "upscaler") and key.startswith("body.last.2."):
            c = cfg["teacher"][net]["in_channels"]
            t = t.clone()
            if key.endswith("weight"):
                t[c : c + 2] *= cfg["assumed"]["flow_std"] / cfg["assumed"]["head_std"]
            else:
                t[c : c + 2] = 0.0
        teacher[net][key] = t.contiguous()
        offset += size
    student_table = student14.body_weight_names(cfg["student"])
    student = bench_inputs.siren_weights(student_table, seed, device, cfg["omega"], stream=12)
    return {"teacher": teacher, "student": student,
            "image": bench_inputs.synthetic_character(cfg["student"]["image_size"], seed, device)}


def teacher_config(t: dict):
    """The port's ``mode_07.TeacherConfig`` for the configuration's teacher."""
    from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, unet, upscaler
    from tha4_tpu_torch.poser.modes import mode_07

    def unet_config(u):
        return unet.UnetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"], model_channels=u["model_channels"],
            level_channel_multipliers=tuple(u["level_channel_multipliers"]), level_use_attention=tuple(u["level_use_attention"]),
            num_res_blocks_per_level=u["num_res_blocks_per_level"], num_middle_res_blocks=u["num_middle_res_blocks"],
            time_embedding_channels=None, cond_input_channels=u["cond_input_channels"],
            cond_internal_channels=u["cond_internal_channels"],
            attention=unet.AttentionConfig(num_heads=u["attention_heads"], use_new_attention_order=True), dropout_prob=0.0)

    def plain(d, *drop):
        return {k: v for k, v in d.items() if k not in drop}

    return mode_07.TeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**t["eyebrow_decomposer"]),
        eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**t["eyebrow_morphing_combiner"]),
        face_morpher=face_morpher.FaceMorpherConfig(**t["face_morpher"]),
        body_morpher=body_morpher.BodyMorpherConfig(image_size=t["body_morpher"]["image_size"], unet=unet_config(t["body_morpher"])),
        upscaler=upscaler.UpscalerConfig(image_size=t["upscaler"]["image_size"], unet=unet_config(t["upscaler"])),
    )


def student_config(b: dict):
    from tha4_tpu_torch.models import siren

    return siren.SirenMorpherConfig(
        image_size=b["image_size"], image_channels=b["image_channels"], pose_size=b["pose_size"],
        levels=tuple(siren.SirenMorpherLevelConfig(lv["image_size"], lv["intermediate_channels"], lv["num_sine_layers"])
                     for lv in b["levels"]))


def phase_at(cfg: dict, examples_seen: int):
    """(lr, loss weights) of the six body phases at ``examples_seen``."""
    phases = cfg["training"]["phases"]
    for bound, lr, weights in phases[:-1]:
        if examples_seen < bound:
            return lr, weights
    return phases[-1][1], phases[-1][2]


def program(cfg: dict, data: dict, device) -> SimpleNamespace:
    """The port's body step as ``DistillationJobs.make_body_trainer`` builds
    it: ``mode_07.Teacher`` from the seeded weights, frozen in the teacher's
    dtype, the character on the card, ``recipes.make_body_distill_group``
    with the selective-f32 student, ``recipes.make_adam``."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.poser.modes import mode_07

    tr = cfg["training"]
    dtype, teacher_dtype = DTYPES[tr["dtype"]], DTYPES[tr["teacher_dtype"]]
    with torch.device(device):
        teacher = mode_07.Teacher.from_params(data["teacher"], teacher_config(cfg["teacher"]))
    teacher.freeze(teacher_dtype, device)
    student = siren.SirenMorpher(student_config(cfg["student"]))  # as the trainer's init_module: built, then moved
    student.load_state_dict({k[len("body."):]: v[:, :, None, None] if v.dim() == 2 else v for k, v in data["student"].items()})
    student.to(device)
    group = recipes.make_body_distill_group(teacher, data["image"][None], dtype, tr["student_mixed"], None, teacher_dtype)
    return SimpleNamespace(group=group, student=student, optimizer=recipes.make_adam(student), teacher=teacher)


# Where each network's outputs lie among mode_07's 33 (upscaler 5,
# face_morphed_full, body 5, face 8, combiner 8, decomposer 6), in
# ``teacher07.STAGES``' order; the face's list ends in face_morphed_full.
STAGE_OUTPUTS = {"decomposer": range(27, 33), "combiner": range(19, 27), "face": (*range(11, 19), 5),
                 "body": range(6, 11), "upscaler": range(0, 5)}


@contextlib.contextmanager
def teacher_tap(into: list):
    """While the block runs, keep a host copy of what
    ``mode_07.compute_outputs`` returns to the recipe (the same tensors,
    unchanged) by network, NCHW: ``{stage: [outputs]}`` a call."""
    from tha4_tpu_torch.poser.modes import mode_07

    compute = mode_07.compute_outputs

    def tapped(*args, **kwargs):
        out = compute(*args, **kwargs)
        into.append({stage: [out[i].detach().permute(0, 3, 1, 2).to("cpu") for i in idx]
                     for stage, idx in STAGE_OUTPUTS.items()})
        return out

    mode_07.compute_outputs = tapped
    try:
        yield
    finally:
        mode_07.compute_outputs = compute


# -- the pose feed: a copy of the distiller's procedural pose distribution --

POSE_RANGES = [(0.0, 1.0)] * 37 + [(-1.0, 1.0)] * 7 + [(0.0, 1.0)]
# (start, stop, group size) of the morph groups of which one is kept a pose:
# the six eyebrow pairs, the six eye pairs, the six mouth shapes.
SPARSE_GROUPS = ((0, 12, 2), (12, 24, 2), (26, 32, 1))


def pose_batch(cfg: dict, seed: int, step: int, n: int) -> torch.Tensor:
    """(n, 45) f32 poses on the host for one step, a function of (seed, step)."""
    gen = torch.Generator().manual_seed((int(seed) * 7_919 + step + 1) % (2**63))
    lows = torch.tensor([lo for lo, _ in POSE_RANGES])
    highs = torch.tensor([hi for _, hi in POSE_RANGES])
    pose = torch.rand((n, len(POSE_RANGES)), generator=gen) * (highs - lows) + lows
    for start, stop, size in SPARSE_GROUPS:
        choice = torch.randint(0, (stop - start) // size, (n,), generator=gen)
        keep = (torch.arange(stop - start) // size)[None, :] == choice[:, None]
        pose[:, start:stop] *= keep
    return pose


# -- the float32 reference of the checked steps ------------------------------


@contextlib.contextmanager
def _full_f32():
    """Float32 products without TF32, for the block."""
    matmul, cudnn_tf32 = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def reference_steps(cfg: dict, data: dict, seed: int, steps: int, rows: int, device, operand=None) -> dict:
    """The first ``steps`` steps in plain float32 PyTorch (no TF32), from
    the benchmark's inputs: the reference teacher's four labels (in blocks
    of ``rows``), the reference student's forward and autograd backward, the
    four weighted L1 terms, and Adam written out.  Returns the losses, the
    first gradient, and the parameters before and after, keyed as the
    port's ``SirenMorpher.named_parameters``, each step's labels, and each
    step's teacher outputs by network on the host, as ``teacher_tap`` keeps
    the program's.  ``operand`` (``teacher07.fp8``: the control) rounds both
    operands of every product, teacher and student."""
    tr = cfg["training"]
    batch = tr["batch_size"]
    (beta1, beta2), eps = tr["adam"]["betas"], tr["adam"]["eps"]
    with _full_f32():
        W = teacher07.Weights(data["teacher"], operand)
        image = data["image"].permute(2, 0, 1)[None]
        params = {k: v.clone().requires_grad_(True) for k, v in data["student"].items()}
        names = {k: k[len("body."):] for k in params}
        p0 = {names[k]: v.detach().clone() for k, v in params.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, grad1, step_labels, teacher = [], None, [], []
        for k in range(steps):
            poses = pose_batch(cfg, seed, k, batch).to(device)
            lr, weights = phase_at(cfg, k * batch)
            with torch.no_grad():
                blocks = [teacher07.stages(W, cfg["teacher"], image.expand(len(p), -1, -1, -1), p) for p in poses.split(rows)]
            outs = {stage: [torch.cat(ts) for ts in zip(*(b[stage] for b in blocks))] for stage in teacher07.STAGES}
            del blocks
            posed, warped, grid, full = teacher07.labels_of(outs)
            step_labels.append([posed, warped, grid, full])
            teacher.append({stage: [t.to("cpu") for t in ts] for stage, ts in outs.items()})
            del outs
            out = student14.body(cfg["student"], params, full.permute(0, 2, 3, 1), poses, operand)
            loss = sum(weights[key] * (label.permute(0, 2, 3, 1) - out[name]).abs().mean() for key, name, label in (
                ("full_blended", "blended", posed), ("full_warped", "warped", warped),
                ("full_grid_change", "grid_change", grid), ("full_color_change", "color_change", posed)))
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if k == 0:
                grad1 = {names[n]: g.detach().clone() for n, g in grads.items()}
            with torch.no_grad():
                t = k + 1
                for n, p in params.items():
                    g = grads[n]
                    m[n].mul_(beta1).add_(g, alpha=1.0 - beta1)
                    v2[n].mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
                    denom = (v2[n] / (1.0 - beta2**t)).sqrt() + eps
                    p.sub_(lr * (m[n] / (1.0 - beta1**t)) / denom)
            del out, loss, grads
        return {"losses": losses, "grad1": grad1, "p0": p0, "labels": step_labels, "teacher": teacher,
                "p_checked": {names[k]: v.detach().clone() for k, v in params.items()}}


def teacher_gaps(cfg: dict, data: dict, seed: int, rows: int, device, got: list) -> Dict[str, list]:
    """Each teacher network alone, on the inputs that ``got`` (the checked
    steps' outputs by network, as ``teacher_tap`` keeps them) gave it: the
    float32 reference network on those inputs, in blocks of ``rows``, and
    for each of its outputs the distance to ``got``'s relative to the
    reference's norm, the worst step's.  {stage: [gap per output]}."""
    batch = cfg["training"]["batch_size"]
    W = teacher07.Weights(data["teacher"])
    image = data["image"].permute(2, 0, 1)[None]
    worst: Dict[str, list] = {}
    with _full_f32(), torch.no_grad():
        for k, step in enumerate(got):
            poses = pose_batch(cfg, seed, k, batch).to(device)
            sums = {}
            for r in range(0, batch, rows):
                given = {stage: [t[r : r + rows].to(device).float() for t in ts] for stage, ts in step.items()}
                ref = teacher07.stages(W, cfg["teacher"], image.expand(len(poses[r : r + rows]), -1, -1, -1), poses[r : r + rows], given)
                for stage in teacher07.STAGES:
                    for i, (a, b) in enumerate(zip(given[stage], ref[stage])):
                        d, n = sums.get((stage, i), (0.0, 0.0))
                        sums[stage, i] = (d + float((a.double() - b.double()).square().sum()), n + float(b.double().square().sum()))
                del given, ref
            for (stage, i), (d, n) in sums.items():
                gaps = worst.setdefault(stage, [0.0] * len(step[stage]))
                gaps[i] = max(gaps[i], math.sqrt(d / n) if n else (0.0 if d == 0 else math.inf))
    return worst


def per_unit(cfg: dict) -> dict:
    """One step's model FLOPs (the teacher's forward at the batch, counted
    by ``FlopCounterMode`` over the reference on meta tensors; the
    student's products forward and twice over backward) and the bound of
    K6's sites, every GroupNorm [-> FiLM] -> SiLU -> 3x3 conv [+ skip] of
    the U-Nets: bytes in the teacher's dtype read and written once, the
    products at that dtype's peak."""
    from torch.utils.flop_counter import FlopCounterMode

    batch = cfg["training"]["batch_size"]
    dtype = cfg["training"]["teacher_dtype"]
    width = counts.BYTES[dtype]
    counter = FlopCounterMode(display=False)
    with torch.device("meta"), counter:
        teacher07.labels(teacher07.Weights(None), cfg["teacher"], torch.empty(batch, 4, 512, 512), torch.empty(batch, 45))
    levels = cfg["student"]["levels"]
    student_macs = sum(counts.chain_macs(layers, levels[i]["image_size"] ** 2)
                       for i, layers in enumerate(student14.body_layers({"body": cfg["student"]})))
    bound = 0.0
    for n, cin, cout, h, w, cs, proj in table(cfg)[1]:
        n *= batch
        nbytes = ((cin + cs + cout) * h * w * n + (9 * cin + (cs if proj else 0)) * cout) * width + (2 * n * cin + cout) * 4
        flops = 2 * n * h * w * cout * (9 * cin + (cs if proj else 0))
        bound += counts.bound_s(nbytes, flops, dtype)
    return {"flops": counter.get_total_flops() + 3 * 2 * student_macs * batch, "bounds_s": {"K6": bound}}
