"""``tha4-torch-distill`` and ``tha4-torch-distill-config`` (headless and
``--web``): the JAX package's tests of its two commands
(tests/test_distill.py:229-332, tests/test_distiller_web.py), against the
port, with ``run_config`` monkeypatched.  The character and mask are the
port's synthetic inputs (``charmodel/synthetic.write_distiller_inputs``).
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
import yaml

from tha4_tpu_torch.apps import distill as distill_app
from tha4_tpu_torch.apps import distiller_ui
from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
from tha4_tpu_torch.distiller import pipeline
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.param_help import PARAM_HELP, explain


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(config yaml, character PNG, mask PNG)."""
    directory = str(tmp_path_factory.mktemp("inputs"))
    path = write_distiller_inputs(directory, seed=6)
    return path, os.path.join(directory, "character.png"), os.path.join(directory, "face_mask.png")


@pytest.fixture
def seen(monkeypatch):
    out = {}

    def fake_run_config(config, target="all", **kwargs):
        out.update(kwargs, target=target, prefix=config.prefix)

    monkeypatch.setattr(pipeline, "run_config", fake_run_config)
    return out


def test_distill_cli_random_teacher_flag(inputs, seen, monkeypatch):
    """--random-teacher injects the port's full-architecture random teacher
    (``mode_07.init`` with a seed-0 generator) instead of loading
    data/tha4/*.pt; without it no teacher is injected."""
    calls = []

    def fake_init(gen, cfg):
        calls.append(torch.randint(0, 2**31, (1,), generator=gen).item())
        return {"marker": "random-teacher"}

    monkeypatch.setattr("tha4_tpu_torch.poser.modes.mode_07.init", fake_init)
    assert distill_app.main(["--config_file", inputs[0], "--random-teacher"]) == 0
    assert seen["teacher_params_07"] == {"marker": "random-teacher"}
    assert seen["prefix"] == DistillerConfig.load(inputs[0]).prefix
    assert calls == [torch.randint(0, 2**31, (1,), generator=torch.Generator().manual_seed(0)).item()]
    seen.clear()
    assert distill_app.main(["--config_file", inputs[0]]) == 0
    assert "teacher_params_07" not in seen


def test_distill_cli_only_mixed_dtype_and_device_flags(inputs, seen):
    """--only picks the DAG node, --mixed (the default) / --no-mixed the
    body student's precision, --bf16 (the default) / --f32 the compute
    dtype; the card unless --device cpu."""
    assert distill_app.main(["--config_file", inputs[0], "--only", "body", "--mixed"]) == 0
    assert seen["target"] == "body" and seen["student_mixed"] is True
    assert seen["compute_dtype"] == torch.bfloat16 and seen["device"] == "cuda"
    seen.clear()
    assert distill_app.main(["--config_file", inputs[0]]) == 0
    assert seen["target"] == "all" and seen["student_mixed"] is True
    seen.clear()
    assert distill_app.main(["--config_file", inputs[0], "--no-mixed", "--f32", "--device", "cpu", "--only", "face"]) == 0
    assert seen["student_mixed"] is False and seen["compute_dtype"] == torch.float32
    assert seen["device"] == "cpu" and seen["target"] == "face"


@pytest.mark.parametrize("flag,value,ok", [("--face-examples", "200000", True), ("--body-examples", "100000", True),
                                           ("--face-examples", "150000", False), ("--body-examples", "0", False),
                                           ("--body-examples", "-100000", False)])
def test_distill_cli_examples_must_be_checkpoint_multiples(inputs, seen, capsys, flag, value, ok):
    argv = ["--config_file", inputs[0], flag, value]
    if ok:
        assert distill_app.main(argv) == 0
        assert seen[flag[2:].replace("-examples", "_total_examples")] == int(value)
    else:
        with pytest.raises(SystemExit) as exc_info:
            distill_app.main(argv)
        assert exc_info.value.code == 2
        assert "must be a positive multiple of 100000" in capsys.readouterr().err
        assert not seen


def test_distill_cli_refuses_the_int8_teacher(inputs, seen, capsys):
    """The int8 teacher, refused until it was ported, now reaches the
    pipeline as the JAX command's flag does (``teacher_int8``), and is off
    without the flag."""
    assert distill_app.main(["--config_file", inputs[0], "--teacher-int8"]) == 0
    assert seen["teacher_int8"] is True
    seen.clear()
    assert distill_app.main(["--config_file", inputs[0]]) == 0
    assert seen["teacher_int8"] is False


def test_distill_config_headless_writes_the_yaml_and_trains(inputs, seen, tmp_path):
    _, character, mask = inputs
    prefix = str(tmp_path / "job")
    assert distiller_ui.main(["--prefix", prefix, "--character", character, "--mask", mask, "--face-seed-0", "7",
                              "--body-batch-size", "4", "--body-sample-cadence", "100000", "--num-chips", "1"]) == 0
    assert not seen
    config = DistillerConfig.load(f"{prefix}/config.yaml")
    assert (config.face_morpher_random_seed_0, config.body_morpher_batch_size) == (7, 4)
    assert config.body_morpher_num_training_examples_per_sample_output == 100_000
    assert config.face_morpher_num_training_examples_per_sample_output == 10_000
    assert distiller_ui.main(["--load", f"{prefix}/config.yaml", "--num-chips", "1", "--train", "--device", "cpu"]) == 0
    assert seen["prefix"] == prefix and seen["device"] == "cpu"


def test_distill_config_explain(capsys):
    assert distiller_ui.main(["--explain", "num_gpus"]) == 0
    assert "one GPU" in capsys.readouterr().out
    assert distiller_ui.main(["--explain", "all"]) == 0
    text = capsys.readouterr().out
    assert all(name in text for name in PARAM_HELP)
    assert set(PARAM_HELP) == {f.name for f in dataclasses.fields(DistillerConfig)}
    assert distiller_ui.main(["--explain", "nope"]) == 2
    with pytest.raises(KeyError):
        explain("nope")


# -- the --web editor (tests/test_distiller_web.py, against the port) --------


@pytest.fixture()
def web_editor():
    server, train_state = distiller_ui._make_web_server(0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", train_state
    finally:
        server.shutdown()
        server.server_close()


def _page_token(base):
    page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
    marker = "const TOKEN = '"
    start = page.index(marker) + len(marker)
    return page[start : page.index("'", start)]


def _post(url, payload, token=None, headers=None):
    base = url.rsplit("/", 1)[0]
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    req.add_header("X-Tha4-Token", token if token is not None else _page_token(base))
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    return urllib.request.urlopen(req, timeout=10)


def _values(inputs, prefix):
    return {"prefix": str(prefix), "character_image_file_name": inputs[1], "face_mask_image_file_name": inputs[2]}


def test_meta_and_page(web_editor):
    base, _ = web_editor
    assert b"distiller config" in urllib.request.urlopen(base + "/", timeout=10).read()
    meta = json.loads(urllib.request.urlopen(base + "/meta", timeout=10).read())
    by_name = {f["name"]: f for f in meta["fields"]}
    assert "prefix" in by_name and "num_gpus" in by_name
    assert "512" in by_name["character_image_file_name"]["help"]
    assert by_name["face_morpher_num_training_examples_per_sample_output"]["choices"] == [10_000, 100_000, 1_000_000, None]
    assert by_name["face_morpher_random_seed_0"]["seed"]
    assert by_name["prefix"]["value"] == ""
    assert by_name["face_morpher_batch_size"]["value"] == 8


def test_save_validates_and_writes_yaml(web_editor, inputs, tmp_path):
    base, _ = web_editor
    values = dict(_values(inputs, tmp_path / "job"), face_morpher_random_seed_0="42", body_morpher_batch_size="4",
                  face_morpher_num_training_examples_per_sample_output="100000",
                  body_morpher_num_training_examples_per_sample_output="null")
    resp = _post(base + "/save", values)
    assert resp.status == 200
    path = json.loads(resp.read())["path"]
    with open(path) as f:
        conf = yaml.safe_load(f)
    assert conf["prefix"] == str(tmp_path / "job")
    assert conf["face_morpher_random_seed_0"] == 42 and conf["body_morpher_batch_size"] == 4
    assert conf["face_morpher_num_training_examples_per_sample_output"] == 100_000
    assert conf["body_morpher_num_training_examples_per_sample_output"] is None
    DistillerConfig.load(path)


def test_save_absent_cadence_keeps_default(web_editor, inputs, tmp_path):
    base, _ = web_editor
    resp = _post(base + "/save", _values(inputs, tmp_path))
    with open(json.loads(resp.read())["path"]) as f:
        conf = yaml.safe_load(f)
    assert conf["face_morpher_num_training_examples_per_sample_output"] == 10_000
    assert conf["body_morpher_num_training_examples_per_sample_output"] == 10_000


@pytest.mark.parametrize("overrides", [
    {"prefix": ""},  # required
    {"character_image_file_name": "mask"},  # RGB where RGBA is required
    {"face_morpher_batch_size": "99"},  # out of [1, 8]
    {"face_morpher_batch_size": "not-an-int"},
    {"face_morpher_random_seed_0": "-1"},
])
def test_save_rejects_bad_values(web_editor, inputs, tmp_path, overrides):
    base, _ = web_editor
    values = dict(_values(inputs, tmp_path), **overrides)
    if values["character_image_file_name"] == "mask":
        values["character_image_file_name"] = inputs[2]
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(base + "/save", values)
    assert exc_info.value.code == 400
    assert json.loads(exc_info.value.read())["error"]


def test_train_runs_config_in_process(web_editor, inputs, tmp_path, monkeypatch):
    """RUN = save + the port's run_config in a thread, on the card by
    default; /state reports progress and a second RUN while active is
    rejected."""
    base, _ = web_editor
    started, release = threading.Event(), threading.Event()
    seen = {}

    def fake_run_config(config, **kwargs):
        seen.update(kwargs, prefix=config.prefix)
        started.set()
        release.wait(timeout=30)

    monkeypatch.setattr(pipeline, "run_config", fake_run_config)
    values = _values(inputs, tmp_path / "job")
    assert _post(base + "/train", values).status == 200
    assert started.wait(timeout=10)
    assert seen == {"prefix": str(tmp_path / "job"), "device": "cuda"}
    state = json.loads(urllib.request.urlopen(base + "/state", timeout=10).read())
    assert state["running"] and not state["done"]
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(base + "/train", values)
    assert exc_info.value.code == 400
    assert "already active" in json.loads(exc_info.value.read())["error"]
    release.set()
    deadline = time.time() + 10
    while time.time() < deadline:
        state = json.loads(urllib.request.urlopen(base + "/state", timeout=10).read())
        if state["done"]:
            break
        time.sleep(0.1)
    assert state["done"] and state["error"] is None


def test_post_without_token_rejected(web_editor, inputs, tmp_path):
    base, _ = web_editor
    values = _values(inputs, tmp_path / "evil")
    for endpoint in ("/save", "/train"):
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(base + endpoint, values, token="")
        assert exc_info.value.code == 403
    assert not (tmp_path / "evil").exists()
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(base + "/save", values, token="0" * 32)
    assert exc_info.value.code == 403


def test_cross_origin_post_rejected_even_with_token(web_editor, inputs, tmp_path):
    base, _ = web_editor
    values = _values(inputs, tmp_path / "evil2")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(base + "/save", values, headers={"Origin": "http://evil.example"})
    assert exc_info.value.code == 403
    assert _post(base + "/save", values, headers={"Origin": base}).status == 200


def test_meta_serializes_big_seeds_as_strings(web_editor, inputs, tmp_path):
    base, _ = web_editor
    meta = json.loads(urllib.request.urlopen(base + "/meta", timeout=10).read())
    by_name = {f["name"]: f for f in meta["fields"]}
    default = DistillerConfig.__dataclass_fields__["face_morpher_random_seed_0"].default
    assert default > 2**53
    assert by_name["face_morpher_random_seed_0"]["value"] == str(default)
    assert by_name["face_morpher_batch_size"]["value"] == 8
    values = {f["name"]: f["value"] for f in meta["fields"]}
    values.update(_values(inputs, tmp_path / "rt"))
    resp = _post(base + "/save", values)
    with open(json.loads(resp.read())["path"]) as f:
        assert yaml.safe_load(f)["face_morpher_random_seed_0"] == default


def test_save_oserror_returns_json_500(web_editor, inputs, tmp_path, monkeypatch):
    def boom(self, path):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(DistillerConfig, "save", boom)
    base, _ = web_editor
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(base + "/save", _values(inputs, tmp_path / "full"))
    assert exc_info.value.code == 500
    assert "No space left" in json.loads(exc_info.value.read())["error"]
