"""tha4-torch-verify against tha4-verify on the same stand-in bundle, on the
CPU.

The bundle (the layout of ``tests/test_verify.py``'s, which needs the
reference source) is written here without it: five small teacher ``.pt``
files from JAX-initialised params through the port's bridge
(``convert.export_torch.teacher_07_state_dicts``), the zero-init heads
damped to the small regime of ``tests/test_verify.py:83-91``; a
``pose_dataset.pt``; a synthetic character and face mask; a narrow random
character model.  ``--reference-src`` points at a missing directory, so the
golden render (2) and the student eval (5) report ``skip`` in both
packages, as they do until the reference source is in the repository.
Both ``main``s run on the same files; their summaries must have the same
checks and statuses, and equal numbers where the weights are shared.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from tests.test_torch_mode14 import _port_cfgs
from tha4_tpu.apps import verify as jverify
from tha4_tpu.models import body_morpher as jbm
from tha4_tpu.models import eyebrow as jeb
from tha4_tpu.models import face_morpher as jfm
from tha4_tpu.models import unet as junet
from tha4_tpu.models import upscaler as jup
from tha4_tpu.poser.modes import mode_07 as jmode_07
from tha4_tpu_torch.apps import verify
from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image, synthetic_face_mask, write_random_character_model
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, unet, upscaler
from tha4_tpu_torch.poser.modes import mode_07
from tha4_tpu_torch.utils import fidelity

torch.set_num_threads(2)

NETS = dict(start_channels=8, num_bottleneck_blocks=1, max_channels=32)
UNET = dict(in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 2, 2),
            level_use_attention=(False, False, True), num_res_blocks_per_level=1, num_middle_res_blocks=2,
            time_embedding_channels=None, cond_input_channels=6, cond_internal_channels=16, dropout_prob=0.0)
ATTENTION = dict(num_heads=2, use_new_attention_order=True)


def _cfgs():
    """tests/test_verify.py's small teacher, in both packages."""
    ju = junet.UnetConfig(attention=junet.AttentionConfig(**ATTENTION), **UNET)
    u = unet.UnetConfig(attention=unet.AttentionConfig(**ATTENTION), **UNET)
    jcfg = jmode_07.TeacherConfig(
        eyebrow_decomposer=jeb.EyebrowDecomposerConfig(**NETS), eyebrow_combiner=jeb.EyebrowCombinerConfig(**NETS),
        face_morpher=jfm.FaceMorpherConfig(**NETS), body_morpher=dataclasses.replace(jbm.BodyMorpherConfig(), unet=ju),
        upscaler=dataclasses.replace(jup.UpscalerConfig(), unet=ju))
    cfg = mode_07.TeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**NETS), eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**NETS),
        face_morpher=face_morpher.FaceMorpherConfig(**NETS),
        body_morpher=dataclasses.replace(body_morpher.BodyMorpherConfig(), unet=u),
        upscaler=dataclasses.replace(upscaler.UpscalerConfig(), unet=u))
    return jcfg, cfg


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    jcfg, cfg = _cfgs()
    params = jax.tree.map(np.array, jmode_07.init(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(7)

    def damp(tree, key, std):
        tree[key] = (rng.standard_normal(tree[key].shape) * std).astype(np.float32)

    damp(params["eyebrow_morphing_combiner"]["morphed_eyebrow_layer_grid_change"]["conv"], "w", 0.02)
    damp(params["face_morpher"]["iris_mouth_grid_change"]["conv"], "w", 0.02)
    for net in ("body_morpher", "upscaler"):
        damp(params[net]["body"]["last_conv"], "w", 0.01)
        damp(params[net]["body"]["last_conv"], "b", 0.01)
    damp(params["upscaler"]["coarse_image_conv"], "w", 0.05)
    damp(params["upscaler"]["coarse_image_conv"], "b", 0.05)
    (data / "tha4").mkdir()
    for key, sd in export_torch.teacher_07_state_dicts(params).items():
        torch.save(sd, data / "tha4" / f"{key}.pt")
    torch.save(torch.from_numpy(fidelity.random_pose_suite(64, seed=5)), data / "pose_dataset.pt")
    model = data / "character_models" / "lambda_00"
    write_random_character_model(str(model), 3, *_port_cfgs())
    PIL.Image.fromarray(synthetic_character_image(512, 11), mode="RGBA").save(model / "character.png")
    (data / "images").mkdir()
    PIL.Image.fromarray(synthetic_face_mask(512, 11)).save(data / "images" / "lambda_00_face_mask.png")
    return str(data), jcfg, cfg


def _run(main, argv, cfg, capsys):
    rc = main(argv, teacher_cfg=cfg)
    out = capsys.readouterr().out
    return rc, json.loads(out.strip().splitlines()[-1])


def test_verify_matches_jax_on_the_same_bundle(bundle, capsys, tmp_path):
    data, jcfg, cfg = bundle
    argv = ["--data-dir", data, "--poses", "1", "--examples", "16", "--int8-cal-poses", "2",
            "--reference-src", str(tmp_path / "no_reference")]
    jrc, theirs = _run(jverify.main, argv, jcfg, capsys)
    rc, ours = _run(verify.main, argv + ["--device", "cpu"], cfg, capsys)
    assert rc == jrc == 0, (ours, theirs)
    assert ours["checks"].keys() == theirs["checks"].keys()
    assert {k: v["status"] for k, v in ours["checks"].items()} == {k: v["status"] for k, v in theirs["checks"].items()} == {
        "teacher files load": "ok", "teacher weight conversion": "ok", "golden render": "skip",
        "int8 teacher fidelity": "ok", "pose dataset": "ok", "distill smoke (loss decrease)": "ok",
        "student fidelity eval": "skip"}
    checks, jchecks = ours["checks"], theirs["checks"]
    assert checks["teacher files load"]["tensors"] == jchecks["teacher files load"]["tensors"]
    assert checks["pose dataset"] == jchecks["pose dataset"] == {"status": "ok", "rows": 64, "dims": 45}
    int8, jint8 = checks["int8 teacher fidelity"], jchecks["int8 teacher fidelity"]
    assert int8["convs_quantized"] == jint8["convs_quantized"] > 0
    assert int8["recommend"] in ("on", "off") and jint8["recommend"] in ("on", "off")
    assert int8.keys() == jint8.keys()
    smoke = checks["distill smoke (loss decrease)"]
    assert smoke["examples"] == jchecks["distill smoke (loss decrease)"]["examples"] == 16
    assert smoke["loss_after"] < smoke["loss_before"]
    # The int8 check's numbers on the same weights: the same label PSNR and
    # grid-change L1 to the digits reported (read: equal).
    np.testing.assert_allclose(int8["psnr_min"], jint8["psnr_min"], atol=0.05)
    np.testing.assert_allclose(int8["grid_change_l1_max"], jint8["grid_change_l1_max"], rtol=1e-2)
    assert checks["teacher weight conversion"] == jchecks["teacher weight conversion"]


def test_verify_skips_as_jax_does(bundle, capsys, tmp_path):
    data, jcfg, cfg = bundle
    argv = ["--data-dir", data, "--skip-distill", "--skip-int8", "--reference-src", str(tmp_path / "none")]
    jrc, theirs = _run(jverify.main, argv, jcfg, capsys)
    rc, ours = _run(verify.main, argv + ["--device", "cpu"], cfg, capsys)
    assert rc == jrc == 0
    assert {k: v for k, v in ours["checks"].items() if k != "teacher weight conversion"} == {
        k: v for k, v in theirs["checks"].items() if k != "teacher weight conversion"}


def test_verify_reports_missing_files(tmp_path, capsys):
    """A placeholder bundle (no .pt files): exit 2 and one line a file, in
    both packages."""
    (tmp_path / "tha4").mkdir()
    jrc, theirs = _run(jverify.main, ["--data-dir", str(tmp_path), "--skip-distill"], None, capsys)
    rc, ours = _run(verify.main, ["--data-dir", str(tmp_path), "--skip-distill", "--device", "cpu"], None, capsys)
    assert rc == jrc == 2
    assert ours == theirs
    assert {v["status"] for v in ours["checks"].values()} == {"missing"} and len(ours["checks"]) == 5


def test_verify_detects_unloadable_file(tmp_path, capsys):
    (tmp_path / "tha4").mkdir()
    for name in mode_07.NETWORK_KEYS:
        (tmp_path / "tha4" / f"{name}.pt").write_bytes(b"placeholder")
    rc = verify.main(["--data-dir", str(tmp_path), "--skip-distill", "--device", "cpu"])
    assert rc == jverify.main(["--data-dir", str(tmp_path), "--skip-distill"]) == 2
    report, jreport = verify.check_torch_files(str(tmp_path)), jverify.check_torch_files(str(tmp_path))
    assert all("unloadable" in v["status"] for v in report.values())
    assert {k: v["status"].split(":")[0] for k, v in report.items()} == {k: v["status"].split(":")[0] for k, v in jreport.items()}
    assert {k: os.path.basename(v["path"]) for k, v in report.items()} == {k: os.path.basename(v["path"]) for k, v in jreport.items()}
