"""The mode_14 student frame of the PyTorch port against the JAX package.

The slice runs at the real 512^2 geometry with narrow widths (face
41->16x3->4, body levels 16/8/8 channels x 2 layers).  JAX initialises the
students; the weight bridge (``tha4_tpu_torch.convert.export_torch``) carries
its params, as numpy arrays, into the port.  Image and pose are numpy arrays
from a seed, fed to both.  On the CPU the port runs the plain versions of
its kernels and JAX its jnp paths.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from tha4_tpu.convert import export_torch as jexport
from tha4_tpu.core import imagecodec as jcodec
from tha4_tpu.models import siren as jsiren
from tha4_tpu.poser.modes import mode_14 as jmode_14
from tha4_tpu.poser.modes import pose_parameters as jpose_parameters
from tha4_tpu_torch.apps import character_model_manual_poser
from tha4_tpu_torch.charmodel import CharacterModel
from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image, write_random_character_model
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_14, pose_parameters

torch.set_num_threads(2)

OUTPUT_NAMES = ["blended", "alpha", "color_change", "warped", "grid_change", "face"]
# f32 bars of tests/test_mode_14_parity.py:79-92,127-135.
F32_ATOL = {"blended": 2e-3, "alpha": 2e-4, "color_change": 2e-4, "warped": 2e-3, "grid_change": 2e-4, "face": 2e-4}


def _jax_cfgs():
    face = jsiren.SirenFaceMorpherConfig(siren=jsiren.SirenConfig(41, 4, 16, 3))
    body = jsiren.SirenMorpherConfig(
        levels=(
            jsiren.SirenMorpherLevelConfig(128, 16, 2),
            jsiren.SirenMorpherLevelConfig(256, 8, 2),
            jsiren.SirenMorpherLevelConfig(512, 8, 2),
        )
    )
    return face, body


def _port_cfgs():
    face = siren.SirenFaceMorpherConfig(siren=siren.SirenConfig(41, 4, 16, 3))
    body = siren.SirenMorpherConfig(
        levels=(
            siren.SirenMorpherLevelConfig(128, 16, 2),
            siren.SirenMorpherLevelConfig(256, 8, 2),
            siren.SirenMorpherLevelConfig(512, 8, 2),
        )
    )
    return face, body


def _random_pose(rng, n=1):
    pose = rng.uniform(0.0, 1.0, size=(n, 45)).astype(np.float32)
    pose[:, 35:42] = rng.uniform(-1.0, 1.0, size=(n, 7))
    return pose


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(4.0 / mse)  # signal range [-1, 1]


@pytest.fixture(scope="module")
def slice_run():
    """JAX params, the bridged port modules, one image and pose, and both
    packages' six outputs in f32 and bf16."""
    jface_cfg, jbody_cfg = _jax_cfgs()
    kf, kb = jax.random.split(jax.random.PRNGKey(14))
    params = {
        jmode_14.KEY_FACE_MORPHER: jsiren.siren_face_morpher_init(kf, jface_cfg),
        jmode_14.KEY_BODY_MORPHER: jsiren.siren_morpher_init(kb, jbody_cfg),
    }
    np_params = jax.tree.map(np.asarray, params)

    face_cfg, body_cfg = _port_cfgs()
    face, body = siren.SirenFaceMorpher(face_cfg), siren.SirenMorpher(body_cfg)
    face.load_state_dict(export_torch.siren_face_morpher_state_dict(np_params[jmode_14.KEY_FACE_MORPHER]))
    body.load_state_dict(export_torch.siren_morpher_state_dict(np_params[jmode_14.KEY_BODY_MORPHER]))

    rng = np.random.default_rng(1414)
    image = imagecodec.load_image_hwc(PIL.Image.fromarray(synthetic_character_image(512, seed=3), mode="RGBA"))
    pose = _random_pose(rng)

    run = {"params": params, "np_params": np_params, "face": face, "body": body, "image": image, "pose": pose}
    for name, jdtype, tdtype in [("f32", jnp.float32, torch.float32), ("bf16", jnp.bfloat16, torch.bfloat16)]:
        jposer = jmode_14.StudentPoser(params, jface_cfg, jbody_cfg, compute_dtype=jdtype)
        run[f"jax_{name}"] = [np.asarray(o) for o in jposer.get_posing_outputs(image, pose)]
        poser = mode_14.StudentPoser(face, body, compute_dtype=tdtype, device="cpu")
        run[f"port_{name}"] = [o.numpy() for o in poser.get_posing_outputs(image, pose)]
    return run


@pytest.mark.parametrize("index,name", list(enumerate(OUTPUT_NAMES)))
def test_slice_matches_jax_f32(slice_run, index, name):
    ours, ref = slice_run["port_f32"][index], slice_run["jax_f32"][index]
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=F32_ATOL[name], err_msg=name)
    if name in ("blended", "warped"):
        assert _psnr(ours, ref) > 60.0, name


def test_slice_bf16_within_3db_of_jax_bf16(slice_run):
    """bf16 rounds at other places in the two packages, so the port's bf16
    frame is held to JAX's own bf16 error: its PSNR against the JAX f32
    frame may be at most 3 dB under JAX-bf16-vs-JAX-f32."""
    ref = slice_run["jax_f32"][0]
    jax_db = _psnr(slice_run["jax_bf16"][0], ref)
    port_db = _psnr(slice_run["port_bf16"][0], ref)
    assert all(o.dtype == np.float32 and np.isfinite(o).all() for o in slice_run["port_bf16"])
    assert port_db >= jax_db - 3.0, (port_db, jax_db)


def test_compute_outputs_leaves_the_image_alone(slice_run):
    face, body = slice_run["face"], slice_run["body"]
    image = torch.from_numpy(slice_run["image"])[None]
    before = image.clone()
    outs = mode_14.compute_outputs(
        face.cfg, body.cfg, face.pack(torch.float32), body.pack(torch.float32), image, torch.from_numpy(slice_run["pose"])
    )
    assert len(outs) == mode_14.OUTPUT_LENGTH
    torch.testing.assert_close(image, before, rtol=0, atol=0)


def test_weight_bridge_matches_jax_export(slice_run):
    np_params = slice_run["np_params"]
    for ours_fn, theirs_fn, key in [
        (export_torch.siren_face_morpher_state_dict, jexport.siren_face_morpher_state_dict, jmode_14.KEY_FACE_MORPHER),
        (export_torch.siren_morpher_state_dict, jexport.siren_morpher_state_dict, jmode_14.KEY_BODY_MORPHER),
    ]:
        ours, theirs = ours_fn(np_params[key]), theirs_fn(np_params[key])
        assert list(ours) == list(theirs)
        for k in ours:
            torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    sd = slice_run["body"].state_dict()
    assert sd["siren_layers.1.0.linear.weight"].shape == (8, 8 + 45 + 2, 1, 1)
    assert sd["last_linear.weight"].shape == (7, 8, 1, 1)


def test_pose_schema_equals_jax():
    ours, theirs = pose_parameters.get_pose_parameters(), jpose_parameters.get_pose_parameters()
    assert ours.get_parameter_count() == theirs.get_parameter_count() == 45
    names = [ours.get_parameter_name(i) for i in range(45)]
    assert names == [theirs.get_parameter_name(i) for i in range(45)]
    np.testing.assert_array_equal(ours.get_default_pose(), theirs.get_default_pose())
    for a, b in zip(ours.get_pose_parameter_groups(), theirs.get_pose_parameter_groups()):
        assert (a.get_group_name(), a.get_arity(), a.get_range(), a.get_default_value(), a.is_discrete(), a.get_parameter_index()) == (
            b.get_group_name(), b.get_arity(), b.get_range(), b.get_default_value(), b.is_discrete(), b.get_parameter_index()
        )
        assert a.get_category().name == b.get_category().name


@pytest.fixture(scope="module")
def jax_exported_model(slice_run, tmp_path_factory):
    """A character model whose two ``.pt`` files JAX's export_torch wrote."""
    d = tmp_path_factory.mktemp("jax_model")
    np_params = slice_run["np_params"]
    jexport.save_face_morpher_pt(np_params[jmode_14.KEY_FACE_MORPHER], str(d / "face_morpher.pt"))
    jexport.save_body_morpher_pt(np_params[jmode_14.KEY_BODY_MORPHER], str(d / "body_morpher.pt"))
    PIL.Image.fromarray(synthetic_character_image(512, seed=3), mode="RGBA").save(d / "character.png")
    yaml_path = str(d / "character_model.yaml")
    CharacterModel(str(d / "character.png"), str(d / "face_morpher.pt"), str(d / "body_morpher.pt")).save(yaml_path)
    return yaml_path


def test_jax_exported_pt_poses_through_character_model(slice_run, jax_exported_model):
    model = CharacterModel.load(jax_exported_model)
    poser = model.get_poser(torch.float32, "cpu")
    assert poser is model.get_poser(torch.float32, "cpu")
    assert poser is not model.get_poser(torch.bfloat16, "cpu")
    assert (poser.get_image_size(), poser.get_output_length(), poser.get_num_parameters()) == (512, 6, 45)
    assert poser.face_cfg == _port_cfgs()[0] and poser.body_cfg == _port_cfgs()[1]
    image = model.get_character_image()
    np.testing.assert_allclose(image, slice_run["image"], atol=0)
    frame = poser.pose(image, slice_run["pose"]).numpy()
    np.testing.assert_allclose(frame, slice_run["jax_f32"][0], atol=F32_ATOL["blended"])


def test_npz_checkpoints_are_refused_clearly(tmp_path):
    """A .npz that the JAX package's trainer wrote (its params pytree,
    flattened by path) is not the port's: it raises and says why."""
    from tha4_tpu.training import checkpoint as jckpt

    jface_cfg, _ = _jax_cfgs()
    path = str(tmp_path / "module_module.npz")
    jckpt._save_npz(path, jsiren.siren_face_morpher_init(jax.random.PRNGKey(0), jface_cfg))
    with pytest.raises(ValueError, match="do not load each other's .npz checkpoints"):
        mode_14.create_poser({mode_14.KEY_FACE_MORPHER: path}, device="cpu")


def test_port_npz_of_the_other_student_is_refused_as_such(tmp_path):
    """The port's own face checkpoint given as the body student raises as
    not a port body checkpoint, without blaming the JAX package."""
    from tha4_tpu_torch.training import checkpoint as ckpt

    face_cfg, _ = _port_cfgs()
    face = siren.SirenFaceMorpher(face_cfg, generator=torch.Generator().manual_seed(6))
    ckpt.save_state(str(tmp_path / "face"), {"module": face}, {}, 0, 0)
    path = str(tmp_path / "face" / "module_module.npz")
    assert isinstance(mode_14._load_student(path, "face"), siren.SirenFaceMorpher)
    with pytest.raises(ValueError, match="not a port body student checkpoint") as info:
        mode_14._load_student(path, "body")
    assert "JAX" not in str(info.value)


def test_port_npz_students_pose_as_their_exported_pt(tmp_path):
    """After one training step each, the students' checkpoints
    (module_module.npz, as the trainer writes them) and their exported .pt
    files give bit-equal frames through CharacterModel.get_poser."""
    from tha4_tpu_torch.training import checkpoint as ckpt

    face_cfg, body_cfg = _port_cfgs()
    gen = torch.Generator().manual_seed(6)
    face, body = siren.SirenFaceMorpher(face_cfg, generator=gen), siren.SirenMorpher(body_cfg, generator=gen)
    pose = torch.from_numpy(_random_pose(np.random.default_rng(6), n=2))
    files = {}
    for name, module, loss in [
        ("face", face, lambda: siren.siren_face_morpher_train_apply(face, pose[:, : face_cfg.pose_size], torch.float32).square().mean()),
        ("body", body, lambda: siren.siren_morpher_train_head(body, pose, torch.float32).square().mean()),
    ]:
        optimizer = torch.optim.Adam(module.parameters(), lr=1e-3)
        loss().backward()
        optimizer.step()
        ckpt.save_state(str(tmp_path / name), {"module": module}, {"module": optimizer}, 2, 0)
        files[name] = (str(tmp_path / name / "module_module.npz"), str(tmp_path / f"{name}.pt"))
        export_torch.save_module_pt(module, files[name][1])
    png = str(tmp_path / "character.png")
    PIL.Image.fromarray(synthetic_character_image(512, seed=3), mode="RGBA").save(png)
    frames = []
    for k in range(2):
        model = CharacterModel(png, files["face"][k], files["body"][k])
        outs = model.get_poser(torch.float32, "cpu").get_posing_outputs(model.get_character_image(), pose[:1].numpy())
        frames.append([o.numpy() for o in outs])
    for name, a, b in zip(OUTPUT_NAMES, *frames):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("bf16", [False, True])
def test_cli_writes_png(tmp_path, bf16):
    face_cfg, body_cfg = _port_cfgs()
    yaml_path = write_random_character_model(str(tmp_path / "model"), seed=5, face_cfg=face_cfg, body_cfg=body_cfg)
    out = tmp_path / "out.png"
    argv = ["--model", yaml_path, "--device", "cpu", "--set", "eye_wink_left=1", "--set", "head_x=-0.5", "--output", str(out)]
    assert character_model_manual_poser.main(argv + (["--bf16"] if bf16 else [])) == 0
    png = PIL.Image.open(out)
    assert png.size == (512, 512) and png.mode == "RGBA"


def test_image_codec_matches_jax(tmp_path):
    u8 = synthetic_character_image(64, seed=7)
    pil = PIL.Image.fromarray(u8, mode="RGBA")
    ours = imagecodec.load_image_hwc(pil)
    np.testing.assert_allclose(ours, jcodec.load_image_hwc(pil), atol=1e-6)
    encoded = imagecodec.encode_display_u8(torch.from_numpy(ours)).numpy()
    np.testing.assert_array_equal(encoded, np.asarray(jcodec.encode_display_u8(jnp.asarray(ours))))
    imagecodec.save_image_hwc(torch.from_numpy(ours), str(tmp_path / "a.png"))
    jcodec.save_image_hwc(ours, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(np.asarray(PIL.Image.open(tmp_path / "a.png")), np.asarray(PIL.Image.open(tmp_path / "b.png")))
    assert os.path.getsize(tmp_path / "a.png") > 0
