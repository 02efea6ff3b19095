"""tha4-torch-verify — one-command verification against the real data bundle,
on the card (counterpart of ``tha4_tpu/apps/verify.py``, ``tha4-verify``).

The "when the real files appear, verify everything" path (reference wiring
being checked: src/tha4/poser/modes/mode_07.py:272-315):

  1. teacher weight conversion — the five .pt state dicts load in torch and
     build the port's mode_07 networks
  2. mode_07 golden render — the port's teacher poser vs the original
     PyTorch implementation built from the SAME .pt files, PSNR floor on
     every user-facing output
  2b. int8 teacher fidelity — calibrate the opt-in int8 teacher on these
     weights, PSNR the exact distillation label tensors vs the f32 teacher,
     and recommend --teacher-int8 on/off (--int8-floor, --int8-grid-l1-ceiling)
  3. pose dataset — data/pose_dataset.pt loads (else the procedural
     fallback is reported)
  4. distill smoke — a ~1k-example face distillation from the real teacher,
     asserting the fixed-batch eval loss DECREASES
  5. fidelity eval — tha4-torch-eval (PSNR / windowed SSIM / perceptual
     proxy) of the bundled student character model vs the torch reference

Steps 2 and 5 need the reference source (--reference-src) and report
``skip`` without it.  Exit code 0 = every runnable check passed; 1 = a
check failed; 2 = required files are missing (each is reported).  The
checks' names, statuses and JSON summary are the JAX command's.

Example:
  tha4-torch-verify --data-dir data/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict


def _teacher_files(data_dir: str) -> Dict[str, str]:
    from tha4_tpu_torch.poser.modes import mode_07

    return {
        key: os.path.join(data_dir, os.path.relpath(default, "data"))
        for key, default in mode_07.DEFAULT_TEACHER_FILES.items()
    }


def check_torch_files(data_dir: str) -> Dict[str, Dict]:
    """Step 1a: each teacher .pt exists and torch-loads (a placeholder or
    truncated file fails here, loudly, per file)."""
    from tha4_tpu_torch.convert.torch_weights import load_torch_state_dict

    report = {}
    for key, path in _teacher_files(data_dir).items():
        entry = {"path": path}
        if not os.path.isfile(path):
            entry["status"] = "missing"
        else:
            try:
                sd = load_torch_state_dict(path)
                entry["status"] = "ok"
                entry["tensors"] = len(sd)
            except Exception as e:  # noqa: BLE001 - reported, not raised
                entry["status"] = f"unloadable: {type(e).__name__}: {e}"
        report[key] = entry
    return report


def _construct_reference_modules(cfg, reference_src: str = "/root/reference/src") -> Dict:
    """The five reference torch modules with args derived from ``cfg``
    (reference src/tha4/poser/modes/mode_07.py:221-271's instantiations),
    freshly initialized — the caller loads state dicts into them."""
    if reference_src not in sys.path:
        sys.path.insert(0, reference_src)

    from tha4.nn.common.unet import AttentionBlockArgs, UnetArgs
    from tha4.nn.eyebrow_decomposer.eyebrow_decomposer_00 import EyebrowDecomposer00, EyebrowDecomposer00Args
    from tha4.nn.eyebrow_morphing_combiner.eyebrow_morphing_combiner_00 import (
        EyebrowMorphingCombiner00, EyebrowMorphingCombiner00Args,
    )
    from tha4.nn.face_morpher.face_morpher_08 import FaceMorpher08, FaceMorpher08Args
    from tha4.nn.morpher.morpher_00 import Morpher00, Morpher00Args
    from tha4.nn.nonlinearity_factory import ReLUFactory
    from tha4.nn.normalization import InstanceNorm2dFactory
    from tha4.nn.upscaler.upscaler_02 import Upscaler02, Upscaler02Args
    from tha4.nn.util import BlockArgs

    def block_args():
        return BlockArgs(initialization_method="he", use_spectral_norm=False,
                         normalization_layer_factory=InstanceNorm2dFactory(),
                         nonlinearity_factory=ReLUFactory(inplace=True))

    def unet_args(u):
        return UnetArgs(
            in_channels=u.in_channels, out_channels=u.out_channels, model_channels=u.model_channels,
            level_channel_multipliers=list(u.level_channel_multipliers),
            level_use_attention=list(u.level_use_attention),
            num_res_blocks_per_level=u.num_res_blocks_per_level, num_middle_res_blocks=u.num_middle_res_blocks,
            time_embedding_channels=u.time_embedding_channels, cond_input_channels=u.cond_input_channels,
            cond_internal_channels=u.cond_internal_channels,
            attention_block_args=AttentionBlockArgs(num_heads=u.attention.num_heads,
                                                    use_new_attention_order=u.attention.use_new_attention_order),
            dropout_prob=u.dropout_prob,
        )

    d = cfg.eyebrow_decomposer
    dec = EyebrowDecomposer00(EyebrowDecomposer00Args(
        image_size=d.image_size, image_channels=d.image_channels, start_channels=d.start_channels,
        bottleneck_image_size=d.bottleneck_image_size, num_bottleneck_blocks=d.num_bottleneck_blocks,
        max_channels=d.max_channels, block_args=block_args()))
    c = cfg.eyebrow_combiner
    comb = EyebrowMorphingCombiner00(EyebrowMorphingCombiner00Args(
        image_size=c.image_size, image_channels=c.image_channels, num_pose_params=c.num_pose_params,
        start_channels=c.start_channels, bottleneck_image_size=c.bottleneck_image_size,
        num_bottleneck_blocks=c.num_bottleneck_blocks, max_channels=c.max_channels, block_args=block_args()))
    f = cfg.face_morpher
    face = FaceMorpher08(FaceMorpher08Args(
        image_size=f.image_size, image_channels=f.image_channels, num_expression_params=f.num_expression_params,
        start_channels=f.start_channels, bottleneck_image_size=f.bottleneck_image_size,
        num_bottleneck_blocks=f.num_bottleneck_blocks, max_channels=f.max_channels, block_args=block_args(),
        output_iris_mouth_grid_change=f.output_iris_mouth_grid_change))
    b = cfg.body_morpher
    body = Morpher00(Morpher00Args(image_size=b.image_size, image_channels=b.image_channels,
                                   num_pose_parameters=b.num_pose_parameters, unet_args=unet_args(b.unet)))
    u = cfg.upscaler
    ups = Upscaler02(Upscaler02Args(image_size=u.image_size, image_channels=u.image_channels,
                                    num_pose_parameters=u.num_pose_parameters, unet_args=unet_args(u.unet)))
    return {"eyebrow_decomposer": dec, "eyebrow_morphing_combiner": comb, "face_morpher": face, "body_morpher": body,
            "upscaler": ups}


def build_reference_poser(files: Dict[str, str], cfg, reference_src: str):
    """The original PyTorch mode_07 poser built from the SAME .pt files, with
    module args derived from ``cfg`` so reduced-size stand-ins verify the
    identical code path (reference src/tha4/poser/modes/mode_07.py:272-315)."""
    import torch

    modules = _construct_reference_modules(cfg, reference_src)
    from tha4.poser.general_poser_02 import GeneralPoser02
    from tha4.poser.modes.mode_07 import FiveStepPoserComputationProtocol
    from tha4.poser.modes.pose_parameters import get_pose_parameters as ref_get_pp

    for name, module in modules.items():
        module.load_state_dict(torch.load(files[name], map_location="cpu", weights_only=True))
        module.eval()
    return GeneralPoser02(
        image_size=512,
        module_loaders={name: (lambda m=m: m) for name, m in modules.items()},
        pose_parameters=ref_get_pp().get_pose_parameter_groups(),
        output_list_func=FiveStepPoserComputationProtocol(cfg.eyebrow_morphed_image_index).compute_func(),
        subrect=None,
        device=torch.device("cpu"),
        output_length=33,
    )


def main(argv=None, teacher_cfg=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data-dir", default="data",
                        help="reference-layout data bundle (data/tha4/*.pt, data/pose_dataset.pt, data/images/, "
                        "data/character_models/)")
    parser.add_argument("--character-image", default=None,
                        help="character PNG for the golden render/distill (default: "
                        "<data-dir>/character_models/lambda_00/character.png)")
    parser.add_argument("--face-mask", default=None,
                        help="face mask PNG for the distill smoke (default: <data-dir>/images/lambda_00_face_mask.png)")
    parser.add_argument("--student-model", default=None,
                        help="character_model.yaml for the fidelity eval (default: "
                        "<data-dir>/character_models/lambda_00/character_model.yaml)")
    parser.add_argument("--poses", type=int, default=4, help="golden-render pose count")
    parser.add_argument("--examples", type=int, default=1024, help="distill smoke examples")
    parser.add_argument("--psnr-floor", type=float, default=40.0,
                        help="minimum PSNR (dB) on the five user-facing mode_07 outputs")
    parser.add_argument("--reference-src", default="/root/reference/src")
    parser.add_argument("--work-dir", default=None, help="distill smoke working directory (default: a temp dir)")
    parser.add_argument("--skip-distill", action="store_true")
    parser.add_argument("--skip-int8", action="store_true", help="skip the int8 teacher-label fidelity check")
    parser.add_argument("--int8-floor", type=float, default=40.0,
                        help="PSNR (dB) above which --teacher-int8 is recommended for distillation")
    parser.add_argument("--int8-grid-l1-ceiling", type=float, default=1e-3,
                        help="max mean-|grid_change| error (normalized units; 1e-3 = ~0.26 px at 512) allowed before "
                        "--teacher-int8 is recommended — the warp-field label is a weighted loss term, so image PSNR "
                        "alone must not gate it")
    parser.add_argument("--int8-cal-poses", type=int, default=8,
                        help="calibration poses for the int8 check (one batched forward)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    summary = {"data_dir": args.data_dir, "checks": {}}
    failed = False
    missing = False
    device = torch.device(args.device)

    def report(name, status, **extra):
        nonlocal failed, missing
        summary["checks"][name] = {"status": status, **extra}
        print(f"[{status.upper():7s}] {name}" + (f"  {extra}" if extra else ""), flush=True)
        failed = failed or status == "fail"
        missing = missing or status == "missing"

    def host(t) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    # ---- 1. teacher .pt files load + build --------------------------------
    files = _teacher_files(args.data_dir)
    file_report = check_torch_files(args.data_dir)
    bad = {k: v for k, v in file_report.items() if v["status"] != "ok"}
    if bad:
        for k, v in bad.items():
            report(f"teacher file {k}", "missing", path=v["path"], detail=v["status"])
        print(json.dumps(summary))
        print("\nReal teacher weights not present — place the reference bundle's data/tha4/*.pt files and rerun.",
              file=sys.stderr)
        return 2
    report("teacher files load", "ok", tensors={k: v["tensors"] for k, v in file_report.items()})

    from tha4_tpu_torch.poser.modes import mode_07

    cfg = teacher_cfg or mode_07.TeacherConfig()
    try:
        params = mode_07.load_params_from_torch(files)
        leaves = len(mode_07.Teacher.from_params(params, cfg).state_dict())
        report("teacher weight conversion", "ok", leaves=leaves)
    except Exception as e:  # noqa: BLE001
        report("teacher weight conversion", "fail", error=f"{type(e).__name__}: {e}")
        print(json.dumps(summary))
        return 1

    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.utils import fidelity

    # ---- 2. mode_07 golden render vs the torch reference ------------------
    char_image = args.character_image or os.path.join(args.data_dir, "character_models/lambda_00/character.png")
    if not os.path.isfile(char_image):
        report("golden render", "missing", path=char_image)
    elif not os.path.isdir(args.reference_src):
        report("golden render", "skip", reason=f"reference src not mounted at {args.reference_src}")
    else:
        our_poser = mode_07.create_poser(params=params, cfg=cfg, device=device)
        ref_poser = build_reference_poser(files, cfg, args.reference_src)
        image = imagecodec.load_image_hwc(char_image)[None]
        ref_image = torch.from_numpy(np.ascontiguousarray(np.transpose(image[0], (2, 0, 1))))
        worst = float("inf")
        proxies = []
        for pose in fidelity.random_pose_suite(args.poses, seed=0):
            ours = our_poser.get_posing_outputs(image, pose[None])
            with torch.no_grad():
                theirs = ref_poser.get_posing_outputs(ref_image, torch.from_numpy(pose))
            # The five user-facing outputs (full frame + intermediate frames).
            for i in range(5):
                worst = min(worst, fidelity.psnr(host(ours[i]), theirs[i].permute(0, 2, 3, 1).numpy()))
            proxies.append(fidelity.lpips_proxy(host(ours[0])[0], theirs[0].permute(0, 2, 3, 1).numpy()[0]))
        status = "ok" if worst > args.psnr_floor else "fail"
        report("golden render (mode_07 vs torch reference)", status, psnr_min=round(worst, 2), floor=args.psnr_floor,
               lpips_proxy_mean=round(float(np.mean(proxies)), 6), poses=args.poses)

    # ---- 2b. int8 teacher label fidelity -----------------------------------
    # The opt-in ``tha4-torch-distill --teacher-int8`` path trades
    # teacher-label precision for step time; this measures its fidelity on
    # THE weights being verified and recommends on/off.
    if args.skip_int8:
        report("int8 teacher fidelity", "skip", reason="--skip-int8")
    elif not os.path.isfile(char_image):
        report("int8 teacher fidelity", "missing", path=char_image)
    else:
        from tha4_tpu_torch.ops import quant
        from tha4_tpu_torch.utils import precision

        # f32 labels: full-f32 products, as the JAX f32 teacher's.
        precision.set_full_f32()
        teacher = mode_07.Teacher.from_params(params, cfg).freeze(torch.float32, device)
        image = torch.from_numpy(imagecodec.load_image_hwc(char_image))[None].to(device)
        ncal = args.int8_cal_poses
        cal_poses = torch.from_numpy(fidelity.random_pose_suite(ncal, seed=0xCA11B)).to(device)
        scales = quant.run_calibration(mode_07.compute_outputs, teacher, image.expand(ncal, -1, -1, -1), cal_poses)

        @torch.no_grad()
        def labels(pose, int8_scales):
            # The exact tensors distillation consumes: body labels (posed 0,
            # warped 2, grid_change 3, student input 5 = face_morphed_full;
            # recipes.body_teacher_targets); the face label is outputs[5]'s
            # face crop, covered by 5.
            with quant.apply_scales(int8_scales):
                t = mode_07.compute_outputs(teacher, image, pose)
            return t[0], t[2], t[3], t[5]

        worst = float("inf")
        grid_l1 = 0.0
        for pose in fidelity.random_pose_suite(args.poses, seed=0x1E8):
            p1 = torch.from_numpy(pose)[None].to(device)
            ref, q = labels(p1, None), labels(p1, scales)
            for i in (0, 1, 3):  # image-like labels -> PSNR
                worst = min(worst, fidelity.psnr(host(ref[i]), host(q[i])))
            grid_l1 = max(grid_l1, float((ref[2] - q[2]).abs().mean()))
        # Both gates must pass: image-label PSNR AND the warp-field label's L1.
        recommend = "on" if worst >= args.int8_floor and grid_l1 <= args.int8_grid_l1_ceiling else "off"
        report("int8 teacher fidelity", "ok", psnr_min=round(worst, 2), grid_change_l1_max=round(grid_l1, 6),
               floor=args.int8_floor, grid_l1_ceiling=args.int8_grid_l1_ceiling, convs_quantized=len(scales),
               recommend=recommend)

    # ---- 3. pose dataset --------------------------------------------------
    from tha4_tpu_torch.distiller.pose_dataset import load_pose_dataset

    pose_file = os.path.join(args.data_dir, "pose_dataset.pt")
    try:
        ds = load_pose_dataset(pose_file) if os.path.isfile(pose_file) else None
    except Exception as e:  # noqa: BLE001
        ds = None
        report("pose dataset", "fail", path=pose_file, error=f"{type(e).__name__}: {e}")
    else:
        if ds is not None:
            report("pose dataset", "ok", rows=int(ds.shape[0]), dims=int(ds.shape[1]))
        else:
            report("pose dataset", "skip", reason="not present; procedural fallback in use", path=pose_file)

    # ---- 4. distill smoke (face morpher, real teacher) --------------------
    face_mask = args.face_mask or os.path.join(args.data_dir, "images/lambda_00_face_mask.png")
    if args.skip_distill:
        report("distill smoke", "skip", reason="--skip-distill")
    elif not (os.path.isfile(char_image) and os.path.isfile(face_mask)):
        report("distill smoke", "missing", character_image=char_image, face_mask=face_mask)
    else:
        from tha4_tpu_torch.distiller import recipes
        from tha4_tpu_torch.distiller.config import DistillerConfig
        from tha4_tpu_torch.distiller.pipeline import DistillationJobs
        from tha4_tpu_torch.poser.modes import mode_12

        cfg12 = mode_12.FaceTeacherConfig(eyebrow_decomposer=cfg.eyebrow_decomposer,
                                          eyebrow_combiner=cfg.eyebrow_combiner, face_morpher=cfg.face_morpher)
        params12 = {k: params[k] for k in mode_12.NETWORK_KEYS}
        with tempfile.TemporaryDirectory() as tmp:
            prefix = args.work_dir or os.path.join(tmp, "verify_distill")
            os.makedirs(prefix, exist_ok=True)
            batch = 4
            total = max(batch * 2, (args.examples // batch) * batch)
            config = DistillerConfig(
                prefix=prefix, character_image_file_name=char_image, face_mask_image_file_name=face_mask,
                face_morpher_num_training_examples_per_sample_output=None,
                body_morpher_num_training_examples_per_sample_output=None, face_morpher_batch_size=batch,
            )
            jobs = DistillationJobs(config, teacher_params_12=params12, teacher_cfg_12=cfg12,
                                    compute_dtype=torch.float32, device=device, face_total_examples=total,
                                    examples_per_checkpoint=total, examples_per_snapshot=total)
            trainer = jobs.make_face_trainer()
            image = jobs.character_image()
            mask = torch.from_numpy(recipes.load_face_mask_crop(face_mask)).to(device)
            eval_poses = jobs.pose_source.batch(torch.Generator().manual_seed(99), 8).to(device)
            target = recipes.face_teacher_targets(jobs.face_teacher(), image, eval_poses, torch.float32)

            def eval_loss(student) -> float:
                with torch.no_grad():
                    total_loss, _ = recipes.face_loss(student, target, mask, eval_poses, torch.float32)
                return float(total_loss)

            loss_before = eval_loss(trainer.init_module(torch.Generator().manual_seed(0)))
            result = trainer.train(total)
            loss_after = eval_loss(result["module"])
            status = "ok" if loss_after < loss_before else "fail"
            report("distill smoke (loss decrease)", status, examples=total, loss_before=round(loss_before, 6),
                   loss_after=round(loss_after, 6))

    # ---- 5. fidelity eval of the bundled student --------------------------
    student_yaml = args.student_model or os.path.join(args.data_dir,
                                                      "character_models/lambda_00/character_model.yaml")
    if not os.path.isfile(student_yaml):
        report("student fidelity eval", "missing", path=student_yaml)
    elif not os.path.isdir(args.reference_src):
        report("student fidelity eval", "skip", reason="reference src not mounted")
    else:
        stats = fidelity.compare_with_reference(student_yaml, num_poses=args.poses, reference_src=args.reference_src,
                                                seed=0, device=device)
        status = "ok" if stats is not None and stats["psnr_min"] > args.psnr_floor else "fail"
        report("student fidelity eval (tha4-eval)", status, **(stats or {}))

    print(json.dumps(summary))
    return 1 if failed else (2 if missing else 0)


if __name__ == "__main__":
    sys.exit(main())
