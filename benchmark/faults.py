"""Faults planted under the timed path, to show that a run with one comes
out not correct (``tests/test_portbench_faults.py`` on the CPU) and to read
at a cell's own size on the chip where they land (``readings.py
--fault``).  Each is a context manager that patches the program and puts
it back."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    before = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, before)


def unchanged():
    """Training: a step that returns its state unchanged (Adam does nothing)."""
    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch():
    """Training: half of the batch left out, the loss's mean over the rest."""
    from tha4_tpu_torch.distiller import recipes

    body_loss = recipes.body_loss

    def half(student, targets, poses, weights, dtype, mixed):
        h = poses.shape[0] // 2
        return body_loss(student, [t[:h] for t in targets], poses[:h], weights, dtype, mixed)

    return _patched(recipes, "body_loss", half)


def grad_altered():
    """Training: an answer altered where it is produced (the step's
    gradients doubled: the loss doubled before its backward)."""
    from tha4_tpu_torch.distiller import recipes

    adam_step = recipes.adam_step
    return _patched(recipes, "adam_step", lambda optimizer, total, named, lr: adam_step(optimizer, 2.0 * total, named, lr))


def frame_altered():
    """Frame: an answer altered where it is produced (the alpha, +0.01)."""
    from tha4_tpu_torch.poser.modes import mode_14

    compute = mode_14.compute_outputs

    def altered(*args):
        outs = list(compute(*args))
        outs[1] = outs[1] + 1e-2
        return tuple(outs)

    return _patched(mode_14, "compute_outputs", altered)


def pose_altered():
    """Frame: the converter's pose altered where it is produced (x 1.001)."""
    from tha4_tpu_torch.mocap import ifacialmocap_pose_converter as conv

    convert = conv.IFacialMocapPoseConverter.convert
    return _patched(conv.IFacialMocapPoseConverter, "convert", lambda self, m, now=None: [v * 1.001 for v in convert(self, m, now)])


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "grad_altered": grad_altered,
          "frame_altered": frame_altered, "pose_altered": pose_altered}
