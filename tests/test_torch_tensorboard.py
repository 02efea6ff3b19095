"""The port's TensorBoard events writer (``tha4_tpu_torch/training/
tensorboard.py``) against the JAX package's: the same bytes for the same
scalars, and each package reads the other's files."""

import json
import os

import numpy as np
import pytest

from tha4_tpu.training import tensorboard as jtb
from tha4_tpu_torch.training import tensorboard as tb

PACKAGES = {"jax": jtb, "port": tb}


@pytest.mark.parametrize("length", [0, 1, 7, 32, 1000])
def test_crc32c_matches_jax(length):
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    assert tb.crc32c(data) == jtb.crc32c(data)
    assert tb._masked_crc(data) == jtb._masked_crc(data)
    if length == 0:
        assert tb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("step", [0, 8, 1_499_992, 2**40 + 3])
def test_scalar_and_version_events_are_byte_equal(step):
    rng = np.random.default_rng(step % 1000)
    scalars = {"training_module_loss_loss": float(rng.standard_normal()), "learning_rate": 1e-4,
               "training_module_full_blended_loss": float(rng.uniform()), "x/ü": -3.5}
    wall = 1.7e9 + float(rng.uniform())
    assert tb.encode_scalar_event(wall, step, scalars) == jtb.encode_scalar_event(wall, step, scalars)
    assert tb.encode_file_version_event(wall) == jtb.encode_file_version_event(wall)
    assert tb._record(b"payload") == jtb._record(b"payload")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_files_read_back_across_packages(tmp_path, writer, reader):
    w = PACKAGES[writer].SummaryWriter(str(tmp_path))
    rows = [(8 * (i + 1), {"training_module_loss_loss": 1.0 / (i + 1), "learning_rate": 1e-4 / (i + 1)}) for i in range(5)]
    for step, scalars in rows:
        w.add_scalars(scalars, step, wall_time=1.7e9 + step)
    w.add_scalar("single", 2.5, 99)
    w.flush()
    w.close()
    events = PACKAGES[reader].read_events(w.path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert [e["step"] for e in events[1:]] == [s for s, _ in rows] + [99]
    for event, (step, scalars) in zip(events[1:], rows):
        assert event["wall_time"] == 1.7e9 + step
        assert event["scalars"] == {k: float(np.float32(v)) for k, v in scalars.items()}
    assert events[-1]["scalars"] == {"single": 2.5}
    with open(w.path, "rb") as f:
        body = f.read()
    # The same events encoded by the other package give the same records after the header.
    other = b"".join(PACKAGES[reader]._record(PACKAGES[reader].encode_scalar_event(1.7e9 + s, s, sc)) for s, sc in rows)
    assert other in body


def test_jsonl_conversion_matches_jax(tmp_path):
    log = tmp_path / "scalars.jsonl"
    with open(log, "w") as f:
        for i in range(4):
            f.write(json.dumps({"loss": 0.5 / (i + 1), "full": 0.1 * i, "examples_seen": 8 * (i + 1), "lr": 1e-4,
                                "wall_time": 1.7e9 + i, "note": "text"}) + "\n")
        f.write("\n")
    read = {}
    for name, module in PACKAGES.items():
        out = tmp_path / name
        path = module.jsonl_to_tensorboard(str(log), str(out))
        assert os.path.dirname(path) == str(out)
        read[name] = [(e["step"], e["wall_time"], e["scalars"]) for e in tb.read_events(path)[1:]]
    assert read["port"] == read["jax"]
    assert [r[0] for r in read["port"]] == [8, 16, 24, 32] and "note" not in read["port"][0][2]
