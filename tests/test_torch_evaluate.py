"""tha4-torch-eval against tha4-eval, on the CPU: both ``main``s on the same
two narrow character models (``--against``), and the reference-less exit."""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_fidelity import STATS_RTOL
from tests.test_torch_mode14 import _port_cfgs
from tha4_tpu.apps import evaluate as jevaluate
from tha4_tpu_torch.apps import evaluate
from tha4_tpu_torch.charmodel.synthetic import write_random_character_model
from tha4_tpu_torch.poser.modes import mode_14


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_models")
    return [write_random_character_model(str(root / name), seed, *_port_cfgs()) for name, seed in (("a", 5), ("b", 6))]


def _stats(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_against_matches_jax(models, capsys):
    argv = ["--model", models[0], "--against", models[1], "--poses", "2", "--seed", "3"]
    jrc, theirs = _stats(jevaluate.main, argv, capsys)
    rc, ours = _stats(evaluate.main, argv + ["--device", "cpu"], capsys)
    assert rc == jrc == 0
    assert ours.keys() == theirs.keys() and ours["dtype"] == theirs["dtype"] == "f32" and ours["frames"] == 2
    for key, rtol in STATS_RTOL.items():
        np.testing.assert_allclose(ours[key], theirs[key], rtol=rtol, err_msg=key)


def test_eval_bf16_and_matmul_precision(models, capsys, monkeypatch):
    """--dtype bf16 poses the first model in bf16; --matmul-precision holds
    for its poser's calls (JAX's words mapped onto torch's), the f32 model
    it is compared with turns TF32 off, and the command restores what it
    found."""
    before, calls = torch.get_float32_matmul_precision(), []
    real = torch.set_float32_matmul_precision
    monkeypatch.setattr(torch, "set_float32_matmul_precision", lambda p: calls.append(p) or real(p))
    rc, ours = _stats(evaluate.main, ["--model", models[0], "--against", models[0], "--poses", "1", "--dtype", "bf16",
                                      "--matmul-precision", "default", "--device", "cpu"], capsys)
    assert rc == 0 and ours["dtype"] == "bf16"
    assert 20.0 < ours["psnr_min"] < float("inf")  # bf16 against f32 of the same model
    # The f32 poser's full f32, the bf16 poser's one call at medium, the command's restore.
    assert calls == ["highest", "medium", "highest", before]


@pytest.mark.parametrize("word,torch_word", [("default", "medium"), ("high", "high"), ("highest", "highest")])
def test_eval_matmul_precision_reaches_the_poser(models, capsys, monkeypatch, word, torch_word):
    """--matmul-precision is the precision in force while ``compare_posers``
    runs the evaluated poser, an f32 one too (its default would be full
    f32); the compared poser without one runs at full f32; afterwards
    ``torch.get_float32_matmul_precision()`` still answers, with what it
    said before, and cuDNN's TF32 flag is as it was."""
    seen = []
    real = mode_14.compute_outputs

    def recording(face_cfg, *args):
        seen.append(torch.get_float32_matmul_precision())
        return real(face_cfg, *args)

    monkeypatch.setattr(mode_14, "compute_outputs", recording)
    before, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    rc, _ = _stats(evaluate.main, ["--model", models[0], "--against", models[1], "--poses", "2",
                                   "--matmul-precision", word, "--device", "cpu"], capsys)
    assert rc == 0
    assert seen == [torch_word, "highest"] * 2  # poser a, then b, for each pose
    assert torch.get_float32_matmul_precision() == before and torch.backends.cudnn.allow_tf32 == cudnn


def test_eval_without_the_reference_exits_2(models, capsys, tmp_path):
    argv = ["--model", models[0], "--reference-src", str(tmp_path / "none"), "--poses", "1"]
    assert jevaluate.main(argv) == evaluate.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.count("reference implementation not found; use --against") == 2
