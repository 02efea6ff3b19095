"""The port's web poser (``tha4_tpu_torch.apps.web_poser``) against the JAX
package's, on the CPU: the slider metadata, and ``/pose.png`` served by the
port's handler around the narrow CPU student against JAX's ``render_png``
of the same model and pose, under ``test_torch_puppeteer.py``'s PNG rule
(the float bars do not carry over to uint8 pixels; see there)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from tha4_tpu.apps import web_poser as jweb_poser
from tha4_tpu.charmodel import CharacterModel as JCharacterModel
from tha4_tpu_torch.apps import web_poser
from tha4_tpu_torch.charmodel import CharacterModel
from tha4_tpu_torch.charmodel.synthetic import write_random_character_model
from test_torch_mode14 import _port_cfgs
from test_torch_puppeteer import PNG_ALPHA_LEVELS, PNG_RGB_LEVELS, png_gaps


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """Both packages' ``_PoserState`` around one narrow model, f32."""
    face_cfg, body_cfg = _port_cfgs()
    yaml_path = write_random_character_model(str(tmp_path_factory.mktemp("narrow_model")), seed=6,
                                             face_cfg=face_cfg, body_cfg=body_cfg)
    model, jmodel = CharacterModel.load(yaml_path), JCharacterModel.load(yaml_path)
    poser = model.get_poser(torch.float32, "cpu")
    image = model.get_character_image()
    jposer = jmodel.get_poser(compute_dtype=jnp.float32)
    return (web_poser._PoserState(poser, torch.from_numpy(image), poser.pose_parameters),
            jweb_poser._PoserState(jposer, image, jposer.pose_parameters))


@pytest.fixture(scope="module")
def server(states):
    srv = web_poser.ThreadingHTTPServer(("127.0.0.1", 0), web_poser._make_handler(states[0]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def test_meta_equals_jax(states, server):
    ours, theirs = states
    assert ours.meta() == theirs.meta()
    served = json.loads(urllib.request.urlopen(server + "/meta", timeout=30).read())
    assert served == json.loads(json.dumps(theirs.meta())) and len(served["params"]) == 45
    assert b"pose.png" in urllib.request.urlopen(server + "/", timeout=30).read()


@pytest.mark.parametrize("index", [0, 1])
def test_pose_png_matches_jax_render(states, server, index):
    """Output 0 (the blended frame) and 1 (alpha, one channel, shown grey)."""
    pp = states[1].pose_parameters
    pose = pp.get_default_pose()
    for name, value in [("head_x", 0.5), ("eye_wink_left", 1.0), ("mouth_aaa", 0.7), ("body_z", -0.4)]:
        pose[pp.get_parameter_index(name)] = value
    query = ",".join(repr(float(v)) for v in pose)
    png = urllib.request.urlopen(f"{server}/pose.png?i={index}&p={query}", timeout=60).read()
    ours = np.asarray(PIL.Image.open(io.BytesIO(png)))
    theirs = np.asarray(PIL.Image.open(io.BytesIO(states[1].render_png(pose, index))))
    assert ours.shape == theirs.shape == (512, 512, 4) and ours.dtype == np.uint8
    alpha, rgb = png_gaps(ours, theirs)
    assert alpha <= PNG_ALPHA_LEVELS and rgb <= PNG_RGB_LEVELS, (alpha, rgb)


@pytest.mark.parametrize("query", ["i=6", "i=-1", "i=x", "p=0.5,zz"])
def test_bad_requests_return_400(server, query):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/pose.png?{query}", timeout=30)
    assert e.value.code == 400
