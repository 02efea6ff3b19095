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
    """--dtype bf16 poses the first model in bf16; --matmul-precision is
    set for the call (JAX's words mapped onto torch's) and restored."""
    before, calls = torch.get_float32_matmul_precision(), []
    real = torch.set_float32_matmul_precision
    monkeypatch.setattr(torch, "set_float32_matmul_precision", lambda p: calls.append(p) or real(p))
    rc, ours = _stats(evaluate.main, ["--model", models[0], "--against", models[0], "--poses", "1", "--dtype", "bf16",
                                      "--matmul-precision", "default", "--device", "cpu"], capsys)
    assert rc == 0 and ours["dtype"] == "bf16"
    assert 20.0 < ours["psnr_min"] < float("inf")  # bf16 against f32 of the same model
    assert calls == ["medium", before]


def test_eval_without_the_reference_exits_2(models, capsys, tmp_path):
    argv = ["--model", models[0], "--reference-src", str(tmp_path / "none"), "--poses", "1"]
    assert jevaluate.main(argv) == evaluate.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.count("reference implementation not found; use --against") == 2
