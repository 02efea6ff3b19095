"""The PyTorch port imports torch and never jax, nor the JAX package.

Checked in a fresh interpreter, since this test process has jax loaded.
"""

import os
import subprocess
import sys

_SCRIPT = r"""
import importlib, pkgutil, sys
import tha4_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tha4_tpu_torch.__path__, "tha4_tpu_torch.")]
# The face- and body-distillation, teacher-poser, serving, distill-to-a-character-model, verification,
# data-parallel, block-zoo/native and tools slices' modules are among them.
needed = {"ops.nn", "models.encoder_decoder", "models.eyebrow", "models.face_morpher", "poser.modes.mode_12",
          "training.losses", "training.schedules", "training.checkpoint", "training.trainer",
          "distiller.config", "distiller.pose_dataset", "distiller.recipes", "distiller.pipeline",
          "ops.cuda_poly_sin", "ops.cuda_warp", "ops.cuda_resize", "models.unet", "models.body_morpher", "models.upscaler",
          "poser.modes.mode_07", "charmodel.synthetic", "convert.export_torch",
          "ops.cuda_conv", "poser.general_poser", "apps.full_manual_poser",
          "mocap.ifacialmocap_constants", "mocap.ifacialmocap", "mocap.ifacialmocap_pose_converter",
          "mocap.mediapipe_face_pose", "mocap.mediapipe_face_pose_converter", "mocap.calibration",
          "utils.profiling", "utils.fidelity", "tools.bench", "tools.puppeteer_pairs", "apps.puppeteer",
          "apps.web_poser", "tasks.workspace", "training.tensorboard", "distiller.sample_output", "distiller.param_help",
          "apps.distill", "apps.tasks_cli", "apps.distiller_ui",
          "ops.quant", "ops.cuda_int8_conv", "apps.evaluate", "apps.verify", "utils.threefry",
          "parallel.mesh", "training.optimizers", "training.ema", "training.two_networks", "training.swarm",
          "native", "native.loader", "core.imagecodec", "tasks.indexed", "core.datasets", "ops.spectral_norm",
          "ops.norms_extra", "ops.separable", "ops.blocks", "models.resize_conv",
          "tools.body_eval", "tools.dtype_ab", "tools.quant_ab", "tools.run_report", "tools.eval_body_checkpoint"}
assert {"tha4_tpu_torch." + n for n in needed} <= set(names), sorted(needed - {n[len("tha4_tpu_torch."):] for n in names})
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "tha4_tpu.")) or m in ("tha4_tpu", "triton"))
print(len(names), "modules;", "imported:", bad)
assert not bad, bad
"""


def test_port_never_imports_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 70, proc.stdout
