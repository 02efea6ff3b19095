"""The full-width mode_07 teacher and the teacher poser on the card.

The seeded random mode_07 (``tests/torch_card.py``'s ``teacher_params``)
at B = 1, 4 (the body sample grid's render) and 8 (training), bf16 and f32:
its launches and outputs, K6 against its plain version at every size those
calls give it, and the f32 card run at B = 1 against its plain run on the
CPU and its f64 run (the exact answer, which says which f32 side is off).
Then the teacher poser from the five state dicts as ``.pt`` files: the
``tha4-torch-pose`` CLI and both ``create_poser``s.  How to run:
``tests/torch_card.py``.  Speed is ``profile_step --time``'s (the teacher
at B = 1 and 8).
"""

import collections
import math
import os
import subprocess
import sys

import pytest
import torch

from torch_card import (
    BATCH, K6_PER_TEACHER_CALL, ROOT, SEED, graph_calls, psnr, reset, teacher_calls, teacher_files, teacher_params, workdir,
)

pytestmark = pytest.mark.cuda

# mode_07 f32 on the card against its plain run on the CPU, and each of
# them against the same teacher's f64 run on the CPU, the exact answer for
# these f32 weights and inputs.  Readings on an H100 (card f32 | CPU f32 |
# card bf16, each against f64): the random full-width mode_12 networks carry
# both f32 runs equally far, face_morphed_full 6.2e-4 | 6.6e-4 | 1.5; the
# upscaler warps that across the hard edge of the pasted face square, posed
# 1.1e-3 | 1.9e-3 | 0.91; grid change 9.2e-6 | 1.4e-5 | 3.0e-2.  The card
# vs CPU bars: the grid change's is the body morpher's and upscaler's bar
# (tests/test_teacher_nets.py:293,335, 1e-4) doubled for the cascade; the
# others are the 2e-3 / 3e-3 of tests/test_torch_body_teacher.py, since the
# CPU's own f32 error reaches 6.6e-4 / 1.9e-3.  Against f64, twice the
# card's reading rounded up, where bf16 fails by 10^3.  Every one of the 33
# outputs must clear 70 dB PSNR card against CPU (that test's floor) and be
# no further from f64 than the CPU's f32 run, within TEACHER_EXACT_RATIO
# (read: 1.34x at most); tests/test_torch_body_teacher.py holds the port
# so against the JAX package at 1.5x.
TEACHER_F32_ATOL = {"posed": 3e-3, "grid_change": 2e-4, "face_morphed_full": 2e-3}
TEACHER_F32_MIN_PSNR = 70.0
TEACHER_EXACT_ATOL = {"posed": 3e-3, "grid_change": 2e-5, "face_morphed_full": 2e-3}
TEACHER_EXACT_RATIO = 2.0
CHECKED = {"posed": 0, "grid_change": 3, "face_morphed_full": 5}  # output index; 5 is mode_07.INDEX_FACE_MORPHED_FULL
# Each U-Net alone on the CPU f32 run's inputs.  Card vs CPU, at those bars
# doubled: all of the body morpher's outputs, and the upscaler's alpha and
# grid change.  Against f64, all ten outputs, the upscaler's RGBA images
# too: the card reads 1.7e-6 (direct) to 2.7e-5 (warped), the CPU's f32
# 5.2e-4 / 2.9e-3 (it is the side that is off), bf16 2.4e-2 / 0.12; no
# bf16 output passes the bar.
UNET_F32_ATOL = 2e-4
UNET_EXACT_ATOL = 1e-4
UNET_OUTPUT_NAMES = ("merged", "alpha", "warped", "grid_change", "direct")
# K6 against its plain version, max-abs error over max |plain|.  f32: FMA
# sums in another order than cuDNN's over 9 * Cin terms (~1e-6 read);
# bf16: the same bf16 operands with f32 sums in another order, and one
# rounding of the output (2^-9).
K6_F32_REL = 1e-4
K6_BF16_REL = 1e-2
# mode_07.create_poser's f32 outputs against compute_outputs of the same
# frozen teacher: the same kernels on the same inputs, with cuDNN in its
# deterministic mode (read: bit-equal; 3.1e-4 apart in its default mode).
POSER_F32_ATOL = 1e-6
POSES = 4
SIZES = [512] * 6 + [256] * 5 + [192] * 8 + [128] * 14  # the 33 outputs' sides
CALLS = [(tag, n) for tag in ("bf16", "f32") for n in (1, 4, BATCH)]  # 4: the body sample grid's batch


@pytest.fixture(scope="module")
def image(workdir):
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.distiller.config import DistillerConfig

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=BATCH))
    return torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()


@pytest.fixture(scope="module")
def calls(teacher_params, image):
    """One ``mode_07.compute_outputs`` call at each of ``CALLS``: its
    outputs' shapes and dtypes, whether they are finite, its K2, K6 and fold
    launches, the size of each K6 call (N, H, W, Cin, Cout, Cs, skip mode),
    and the teachers and their B = 1 outputs on the CPU."""
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_07

    k6 = cuda_conv.fused_affine_conv3_nchw
    k6_sizes = {}

    def k6_recorded(x, scale, shift, w9, bias, skip=None, skip_w=None, layout=None):
        n, c, h, w = x.shape
        mode = 0 if skip is None else (1 if skip_w is None else 2)
        size = (n, h, w, c, w9.shape[0], 0 if skip is None else skip.shape[1], mode)
        k6_sizes[size] = k6_sizes.get(size, 0) + 1
        return k6(x, scale, shift, w9, bias, skip, skip_w, layout)

    counters = (cuda_warp.grid_sample_fast, cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film)
    out = {"runs": {}, "teachers": {}, "b1": {}, "k6_sizes": k6_sizes}
    for tag, dtype in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        teacher = out["teachers"][tag] = mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")
        for n in (1, 4, BATCH):
            poses = sample_poses(torch.Generator().manual_seed(SEED + 20 + n), n).cuda()
            images = image.to(dtype).expand(n, *image.shape[1:])
            reset(counters)
            with torch.no_grad():
                outs = mode_07.compute_outputs(teacher, images, poses.to(dtype))
            torch.cuda.synchronize()
            run = {"launches": tuple(c.launches for c in counters), "shapes": [(tuple(o.shape[:3]), o.dtype) for o in outs],
                   "finite": all(bool(torch.isfinite(o.float()).all()) for o in outs)}
            # The signature's second call captures its graph: the body runs
            # once more, through the K6 wrapper that records the sizes.
            before = [c.launches for c in counters]
            k6_recorded.launches = 0  # the wrapper counts on the function its module name holds
            cuda_conv.fused_affine_conv3_nchw = k6_recorded
            try:
                with torch.no_grad():
                    mode_07.compute_outputs(teacher, images, poses.to(dtype))
            finally:
                cuda_conv.fused_affine_conv3_nchw = k6
            run["capture_launches"] = (counters[0].launches - before[0], k6_recorded.launches, counters[2].launches - before[2])
            before = [c.launches for c in counters]
            with torch.no_grad():
                mode_07.compute_outputs(teacher, images, poses.to(dtype))  # the third replays it
            torch.cuda.synchronize()
            run["replay_launches"] = tuple(c.launches - b for c, b in zip(counters, before))
            run["calls"] = teacher_calls()
            out["runs"][(tag, n)] = run
            if n == 1:
                out["b1"][tag] = (poses, [o.cpu() for o in outs])
    return out


@pytest.mark.parametrize("tag,n", CALLS)
def test_mode_07_call_launches_5_k2_102_k6_and_102_folds(calls, tag, n):
    """Each eager or captured call; the replay launches through none of the
    wrappers.  Calls: one eager, one capture, one replay."""
    run = calls["runs"][(tag, n)]
    per_call = (5, K6_PER_TEACHER_CALL, K6_PER_TEACHER_CALL)
    assert (run["launches"], run["capture_launches"], run["replay_launches"]) == (per_call, per_call, (0, 0, 0))
    assert run["calls"] == graph_calls(3)


@pytest.mark.parametrize("tag,n", CALLS)
def test_mode_07_call_gives_33_finite_outputs(calls, tag, n):
    run = calls["runs"][(tag, n)]
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    assert run["shapes"] == [((n, s, s), dtype) for s in SIZES] and run["finite"]


def test_k6_matches_plain_at_every_size_of_the_teachers_calls(calls):
    """K6 against its plain version at every size the U-Nets gave it at
    B = 1, 4 and 8, f32 and bf16, on seeded inputs laid out as the U-Net
    passes them (NCHW views of NHWC memory, the weights' device layout made
    once): two calls bit-identical, the error over max |plain| within the
    bars.  The deep levels at B = 1 and the 16^2-64^2 ones at B = 8 make
    grids too small for the card, which split the channel chunks among
    blocks and sum f32 partials in a second kernel: at least one size in
    each dtype must."""
    from tha4_tpu_torch.ops import cuda_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    split = {"f32": 0, "bf16": 0}
    for n, h, w, cin, cout, cs, mode in sorted(calls["k6_sizes"]):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        skip32 = randn(n, h, w, cs) if mode else None
        skip_w32 = randn(cout, cs) / math.sqrt(cs) if mode == 2 else None
        scale = torch.rand((n, cin), generator=gen, device="cuda") + 0.5
        shift = torch.rand((n, cin), generator=gen, device="cuda") - 0.5
        x32, w32, bias = randn(n, h, w, cin), randn(3, 3, cin, cout) / math.sqrt(9 * cin), randn(cout) * 0.1
        for dtype, tag, bar in [(torch.float32, "f32", K6_F32_REL), (torch.bfloat16, "bf16", K6_BF16_REL)]:
            x = x32.to(dtype).permute(0, 3, 1, 2)
            sk = None if skip32 is None else skip32.to(dtype).permute(0, 3, 1, 2)
            skw = None if skip_w32 is None else skip_w32.to(dtype)
            w9 = cuda_conv.to_w9(w32, dtype).contiguous()
            layout = cuda_conv.device_weight_layout(w9, skw, cuda_conv.layout_block(w9.shape[0], dtype), cuda_conv.CK, dtype)
            args = (x, scale, shift, w9, bias, sk, skw, layout)
            first = cuda_conv.fused_affine_conv3_nchw(*args)
            again = cuda_conv.fused_affine_conv3_nchw(*args)
            ref = cuda_conv.fused_affine_conv3_plain(*args[:7])
            torch.cuda.synchronize()
            size = f"N={n} {h}x{w} {cin}->{cout} skip {mode} {tag}"
            assert torch.equal(first, again), size
            rel = float((first.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
            assert first.dtype == dtype and first.shape == ref.shape and rel <= bar, (size, rel)
            split[tag] += cuda_conv._plan(n, h, w, cin, cout, cs, mode, int(dtype == torch.bfloat16))[0] > 1
    print(f"K6 within its bars at the {len(calls['k6_sizes'])} sizes of the teacher's calls; split grids {split}")
    assert split["f32"] and split["bf16"], split


@pytest.fixture(scope="module")
def exact(calls, teacher_params, image):
    """The B = 1 call on the CPU in f32 (the plain run) and in f64, and the
    gaps between the runs, output by output: card f32 vs CPU f32, card f32
    vs f64, CPU f32 vs f64 and card bf16 vs f64."""
    from tha4_tpu_torch.poser.modes import mode_07

    poses, card = calls["b1"]["f32"]
    _, card16 = calls["b1"]["bf16"]
    cpu_teacher = mode_07.Teacher.from_params(teacher_params).freeze(torch.float32, "cpu")
    exact_teacher = mode_07.Teacher.from_params(teacher_params).freeze(torch.float64, "cpu")
    with torch.no_grad():
        plain = mode_07.compute_outputs(cpu_teacher, image.cpu(), poses.cpu())
        f64 = mode_07.compute_outputs(exact_teacher, image.cpu().double(), poses.cpu().double())
    rows = {i: _gaps(card[i], plain[i], f64[i], card16[i]) for i in range(len(card))}
    return {"rows": rows, "psnr": min(psnr(a, b) for a, b in zip(card, plain)), "plain": plain,
            "cpu_teacher": cpu_teacher, "exact_teacher": exact_teacher, "poses": poses}


def _gaps(on_card, on_cpu, on_exact, on_bf16) -> dict:
    def gap(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    return {"card_cpu": gap(on_card, on_cpu), "card_exact": gap(on_card, on_exact), "cpu_exact": gap(on_cpu, on_exact),
            "bf16_exact": gap(on_bf16, on_exact)}


def _further_than_the_cpu(rows: dict) -> list:
    """The outputs where the card's f32 is further from the exact answer
    than ``TEACHER_EXACT_RATIO`` times the CPU's f32."""
    return [(k, r["card_exact"], r["cpu_exact"]) for k, r in rows.items()
            if not r["card_exact"] <= TEACHER_EXACT_RATIO * r["cpu_exact"] + 1e-7]


def test_f32_teacher_matches_its_cpu_run_and_f64(exact):
    rows = exact["rows"]
    for name, i in CHECKED.items():
        print(f"{name}: {rows[i]}")
        assert rows[i]["card_cpu"] <= TEACHER_F32_ATOL[name] and rows[i]["card_exact"] <= TEACHER_EXACT_ATOL[name], name
    assert not _further_than_the_cpu(rows)
    assert exact["psnr"] > TEACHER_F32_MIN_PSNR


@pytest.fixture(scope="module")
def unets(calls, exact):
    """The body morpher and the upscaler alone, each on the CPU f32 run's
    inputs, on the card in f32 and bf16, on the CPU in f32 and f64: the
    gaps by network and output."""
    from tha4_tpu_torch.models import body_morpher
    from tha4_tpu_torch.ops.resize import resize_bilinear
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.poser.modes.pose_parameters import NUM_EYEBROW_PARAMS, NUM_FACE_PARAMS

    plain = exact["plain"]
    rotation = exact["poses"].cpu()[:, NUM_EYEBROW_PARAMS + NUM_FACE_PARAMS :]
    half = resize_bilinear(plain[mode_07.INDEX_FACE_MORPHED_FULL], (256, 256))
    coarse = [resize_bilinear(plain[6 + i], (512, 512)) for i in (body_morpher.INDEX_MERGED, body_morpher.INDEX_GRID_CHANGE)]
    inputs = {"body_morpher": (half, rotation), "upscaler": (plain[mode_07.INDEX_FACE_MORPHED_FULL], *coarse, rotation)}
    rows = {}
    for name, args in inputs.items():
        with torch.no_grad():
            on_card = getattr(calls["teachers"]["f32"], name)(*(t.cuda() for t in args))
            on_cpu = getattr(exact["cpu_teacher"], name)(*args)
            on_exact = getattr(exact["exact_teacher"], name)(*(t.double() for t in args))
            on_bf16 = getattr(calls["teachers"]["bf16"], name)(*(t.to("cuda", torch.bfloat16) for t in args))
        rows[name] = {k: _gaps(a.cpu(), b, e, h.cpu()) for k, a, b, e, h in zip(UNET_OUTPUT_NAMES, on_card, on_cpu, on_exact, on_bf16)}
    return rows


def test_f32_unets_alone_match_their_cpu_runs_and_f64(unets):
    held = [("body_morpher", k) for k in UNET_OUTPUT_NAMES] + [("upscaler", "alpha"), ("upscaler", "grid_change")]
    assert all(unets[net][k]["card_cpu"] <= UNET_F32_ATOL for net, k in held), unets
    assert all(r["card_exact"] <= UNET_EXACT_ATOL for rows in unets.values() for r in rows.values()), unets
    assert not _further_than_the_cpu(unets["body_morpher"]) and not _further_than_the_cpu(unets["upscaler"])


def test_bf16_teacher_fails_the_f32_bars(exact, unets):
    """The bars have teeth: bf16 fails each of them."""
    passed = [name for name, i in CHECKED.items() if exact["rows"][i]["bf16_exact"] <= TEACHER_EXACT_ATOL[name]]
    passed += [(net, k) for net in unets for k, r in unets[net].items() if r["bf16_exact"] <= UNET_EXACT_ATOL]
    assert not passed


# -- the teacher poser -----------------------------------------------------------


@pytest.mark.parametrize("tag,extra,outputs", [
    ("f32", ["--output", "pose_f32.png"], ["pose_f32.png"]),
    ("bf16", ["--bf16", "--output", "pose_bf16.png"], ["pose_bf16.png"]),
    ("bf16 sweep", ["--bf16", "--sweep", "head_y", "--frames", "3", "--output-dir", "sweep"],
     [os.path.join("sweep", f"head_y_{i:03d}.png") for i in range(3)]),
])
def test_teacher_pose_cli_writes_its_pngs(teacher_files, workdir, tag, extra, outputs):
    """``tha4-torch-pose`` from the five full-width ``.pt`` files."""
    import PIL.Image

    files, png = teacher_files
    module_args = [a for key, path in files.items() for a in ("--module-file", f"{key}={path}")]
    extra = [os.path.join(workdir, a) if a.endswith(".png") or a == "sweep" else a for a in extra]
    cmd = [sys.executable, "-m", "tha4_tpu_torch.apps.full_manual_poser", *module_args, "--input", png,
           "--set", "head_y=0.5", "--device", "cuda", *extra]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    for out in outputs:
        assert PIL.Image.open(os.path.join(workdir, out)).size == (512, 512), out


@pytest.fixture(scope="module")
def poser_image(teacher_files):
    """The character on the card, one object: the decomposer runs once a poser."""
    from tha4_tpu_torch.core import imagecodec

    return torch.from_numpy(imagecodec.load_image_hwc(teacher_files[1])).cuda()


def _poser(teacher_files, dtype):
    from tha4_tpu_torch.poser.modes import mode_07

    return mode_07.create_poser(module_file_names=teacher_files[0], compute_dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mode_07_poser_poses_an_image_four_times(teacher_files, poser_image, dtype):
    """33 finite f32 outputs a pose on the card; 102 K6, 5 K2 and 102 fold
    launches a call that is not a replay; the eyebrow decomposer run once
    (the prologue cache)."""
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.tools import bench

    poser = _poser(teacher_files, dtype)
    counters = (cuda_conv.fused_affine_conv3_nchw, cuda_warp.grid_sample_fast, cuda_conv.fold_groupnorm_film)
    reset(counters)
    per_call = []
    for pose in bench.pose_sweep(poser.pose_parameters, POSES):
        before = [c.launches for c in counters]
        outs = poser.get_posing_outputs(poser_image, pose)
        per_call.append(tuple(c.launches - b for c, b in zip(counters, before)))
        assert [tuple(t.shape[:3]) for t in outs] == [(1, s, s) for s in SIZES]
        assert all(t.dtype == torch.float32 and t.device.type == "cuda" and bool(torch.isfinite(t).all()) for t in outs)
    # The first call warms its signature up, the second captures it, the
    # rest replay it.
    assert per_call == [(K6_PER_TEACHER_CALL, 5, K6_PER_TEACHER_CALL)] * 2 + [(0, 0, 0)] * (POSES - 2)
    assert teacher_calls() == graph_calls(POSES)
    assert poser.prologue_cache_misses == 1


def test_mode_07_f32_poser_equals_compute_outputs(teacher_files, poser_image):
    """cuDNN's default algorithms are not all deterministic: two runs of the
    same teacher may differ by a rounding, which the random full-width
    cascade carries to ~1e-4.  So the poser is held against
    ``compute_outputs`` in cuDNN's deterministic mode, on a new image object
    (the prologue runs again, in that mode too)."""
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import bench

    poser = _poser(teacher_files, torch.float32)
    pose = bench.pose_sweep(poser.pose_parameters, POSES)[-1]
    with torch.no_grad():
        repeat = [mode_07.compute_outputs(poser.params, poser_image[None], torch.from_numpy(pose)[None].cuda()) for _ in range(2)]
    print(f"two compute_outputs calls in cuDNN's default mode differ by {max(float((a - b).abs().max()) for a, b in zip(*repeat)):.3e}")
    torch.backends.cudnn.deterministic = True
    try:
        fresh = poser_image.clone()
        got = poser.get_posing_outputs(fresh, pose)
        with torch.no_grad():
            inline = mode_07.compute_outputs(poser.params, fresh[None], torch.from_numpy(pose)[None].cuda())
    finally:
        torch.backends.cudnn.deterministic = False
    assert max(float((a - b).abs().max()) for a, b in zip(got, inline)) <= POSER_F32_ATOL


def test_mode_12_poser_gives_22_finite_outputs(teacher_files, poser_image):
    """(K6, K2) launches (0, 2) and no prologue."""
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_12
    from tha4_tpu_torch.tools import bench

    files = teacher_files[0]
    face = mode_12.create_poser(module_file_names={k: files[k] for k in mode_12.NETWORK_KEYS}, compute_dtype=torch.bfloat16)
    cuda_conv.fused_affine_conv3_nchw.launches = 0
    cuda_warp.grid_sample_fast.launches = 0
    outs = face.get_posing_outputs(poser_image, bench.pose_sweep(face.pose_parameters, 1)[0])
    torch.cuda.synchronize()
    assert [tuple(t.shape[:3]) for t in outs] == [(1, s, s) for s in [192] * 8 + [128] * 14]
    assert (cuda_conv.fused_affine_conv3_nchw.launches, cuda_warp.grid_sample_fast.launches) == (0, 2)
    assert not face.prologue_cache_misses
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in outs)


# -- the teacher's call as a CUDA graph ------------------------------------------

GRAPH_CALLS = 5  # a signature's calls: one eager, one capture, three replays
GRAPH_NEW_IMAGE = 3  # the call from which on the character differs
GRAPH_CASES = [("bf16", BATCH, False), ("f32", 1, True)]  # the training step's call; the poser's, decomposer cached


@pytest.fixture(scope="module")
def graphed(teacher_params, image):
    """``GRAPH_CALLS`` calls of one signature each, in cuDNN's deterministic
    mode, through a wrapper on ``mode_07.compute_outputs`` as the
    benchmark's tap wraps it (it keeps what each call returned): a new
    pose every call, a new character from ``GRAPH_NEW_IMAGE`` on (with its
    own decomposer outputs where they are given).  Beside each, the body
    run eagerly on the same inputs."""
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.poser.modes import mode_07

    out = {}
    compute = mode_07.compute_outputs
    torch.backends.cudnn.deterministic = True
    try:
        for tag, n, given in GRAPH_CASES:
            dtype = torch.bfloat16 if tag == "bf16" else torch.float32
            teacher = mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")
            poses = sample_poses(torch.Generator().manual_seed(SEED + 40 + n), n * GRAPH_CALLS).cuda().to(dtype)
            characters = [image.to(dtype), image.flip(2).to(dtype)]
            seen, got, eager = [], [], []

            def tapped(*args, **kwargs):
                result = compute(*args, **kwargs)
                seen.append(result)
                return result

            mode_07.counts.reset()
            mode_07.compute_outputs = tapped
            try:
                with torch.no_grad():
                    for i in range(GRAPH_CALLS):
                        character = characters[i >= GRAPH_NEW_IMAGE].expand(n, -1, -1, -1)
                        dec = mode_07.compute_decomposer_outputs(teacher, character) if given else None
                        pose = poses[i * n : (i + 1) * n].clone()  # a new tensor, as the trainer feeds its poses
                        got.append(mode_07.compute_outputs(teacher, character, pose, dec))
                        eager.append(mode_07._compute_outputs(teacher, character, pose, dec))
            finally:
                mode_07.compute_outputs = compute
            torch.cuda.synchronize()
            out[tag] = {"teacher": teacher, "got": got, "eager": eager, "seen": seen,
                        "calls": teacher_calls()}
    finally:
        torch.backends.cudnn.deterministic = False
    return out


@pytest.mark.parametrize("tag", [c[0] for c in GRAPH_CASES])
def test_replayed_outputs_equal_the_eager_body_bit_for_bit(graphed, tag):
    """Every call, the replays too, against the body on the same inputs:
    a new pose and a new character reach the graph."""
    run = graphed[tag]
    for i, (got, eager) in enumerate(zip(run["got"], run["eager"])):
        assert len(got) == len(eager) == 33
        assert all(torch.equal(a, b) for a, b in zip(got, eager)), f"call {i}"
    assert not torch.equal(run["got"][GRAPH_NEW_IMAGE - 1][0], run["got"][GRAPH_NEW_IMAGE][0])


@pytest.mark.parametrize("tag", [c[0] for c in GRAPH_CASES])
def test_each_call_owns_its_outputs(graphed, tag):
    """No two calls' outputs share memory, and a later replay leaves an
    earlier call's outputs as they were (the comparison above ran after
    every call)."""
    ptrs = [o.data_ptr() for outs in graphed[tag]["got"] for o in outs]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("tag", [c[0] for c in GRAPH_CASES])
def test_calls_of_one_signature_capture_once_and_replay_the_rest(graphed, tag):
    assert graphed[tag]["calls"] == graph_calls(GRAPH_CALLS)


@pytest.mark.parametrize("tag", [c[0] for c in GRAPH_CASES])
def test_a_wrapper_on_compute_outputs_sees_every_call(graphed, tag):
    run = graphed[tag]
    assert len(run["seen"]) == GRAPH_CALLS and all(s is g for s, g in zip(run["seen"], run["got"]))


def _profiled_kernels(fn) -> collections.Counter:
    """The card's kernels that ``fn`` ran, by name, as ``torch.profiler``
    records them: K6's and its fold's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = (e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA)
    return collections.Counter(n for n in names if "affine_silu_conv3" in n or "group_norm_" in n)


def test_a_profiler_started_after_the_capture_sees_the_replays_kernels(graphed, image):
    """The benchmark's traced window starts after set-up has captured the
    graph: a replay there shows the same K6 and fold kernels as the eager
    body."""
    from tha4_tpu_torch.poser.modes import mode_07

    teacher = graphed["bf16"]["teacher"]
    character = image.to(torch.bfloat16).expand(BATCH, -1, -1, -1)
    pose = torch.rand((BATCH, 45), generator=torch.Generator().manual_seed(SEED + 41)).cuda().to(torch.bfloat16)
    torch.backends.cudnn.deterministic = True  # the graph's signature
    try:
        with torch.no_grad():
            eager = _profiled_kernels(lambda: mode_07._compute_outputs(teacher, character, pose))
            mode_07.counts.reset()
            replayed = _profiled_kernels(lambda: mode_07.compute_outputs(teacher, character, pose))
    finally:
        torch.backends.cudnn.deterministic = False
    assert teacher_calls() == (0, 0, 1)
    assert sum(eager.values()) >= 2 * K6_PER_TEACHER_CALL and replayed == eager, (eager, replayed)


def test_a_call_inside_a_callers_capture_runs_its_body_into_that_graph(graphed, image):
    """A caller that captures a graph of its own gets the body in it: the
    call is refused a graph of mode_07's, and the caller's replay equals
    the eager body."""
    from tha4_tpu_torch.poser.modes import mode_07

    teacher = graphed["bf16"]["teacher"]
    character = image.to(torch.bfloat16).expand(BATCH, -1, -1, -1)
    pose = torch.rand((BATCH, 45), generator=torch.Generator().manual_seed(SEED + 42)).cuda().to(torch.bfloat16)
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            eager = mode_07._compute_outputs(teacher, character, pose)
            mode_07.counts.reset()
            outer = torch.cuda.CUDAGraph()
            with torch.cuda.graph(outer):
                captured = mode_07.compute_outputs(teacher, character, pose)
            outer.replay()
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert teacher_calls() == (1, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
