"""Post-training int8 quantization of the FROZEN teacher (counterpart of
``tha4_tpu/ops/quant.py``): the opt-in ``tha4-torch-distill --teacher-int8``
and step 2b of ``tha4-torch-verify``.

  * Weights: symmetric per-output-channel int8 (round(w / s), s =
    max|w| / 127), quantized from the f32 weight.  ``Teacher.freeze``
    stores them beside each eligible conv before it casts the convs to the
    compute dtype (``store_int8``), since bf16 weights would quantize to
    other integers than the JAX teacher's f32 params.
  * Activations: one static scale per call site, from a calibration pass
    (an eager forward that records max|x| of every eligible conv's input
    on the device and syncs once at the end).
  * Call sites match by position: the Nth eligible conv of the applied
    forward takes the Nth calibrated scale, and each one asserts the
    structural signature it was calibrated at, so a drift between the two
    programs raises instead of mis-scaling.
  * Eligibility: stride 1 and min(Cin, Cout) >= 16, which keeps the heads
    and the 4..8-channel first convs in the compute dtype.

Signatures are in the JAX convention, x NHWC (``x_shape[1:]`` = (H, W, C))
and w HWIO, so one ``tha4-int8-scales-v1`` file loads in both packages; the
port's NCHW convs are converted where a signature is made
(``nchw_signature``).  The hook that consumes the scope is ``ops.nn.Conv2d``
(every teacher conv goes through it); an eligible conv under
``apply_scales`` runs Q1 (``ops.cuda_int8_conv``), or its plain version on
the CPU.

Rounding follows the JAX code: ``inv = f32(1 / x_scale)`` divided in double,
round half to even before the clip to [-127, 127], the dequantize
``acc.f32 * (f32(x_scale) * w_s)`` cast to x's dtype and the bias added after,
in x's dtype.
"""

from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
from torch import nn

from tha4_tpu_torch.ops import cuda_int8_conv

# The scope in force: a Calibration, an _Apply, or None.  Teacher forwards
# run on one thread.
_CURRENT: Optional[object] = None

MIN_QUANT_CHANNELS = 16
SCALES_FORMAT = "tha4-int8-scales-v1"


def _signature(x_shape, w_shape, stride: int) -> Tuple:
    # Batch excluded: calibration may run at another batch than training.
    return (tuple(int(s) for s in x_shape[1:]), tuple(int(s) for s in w_shape), int(stride))


def nchw_signature(x: torch.Tensor, conv: nn.Conv2d) -> Tuple:
    """The JAX signature of ``conv`` (OIHW weight) on NCHW ``x``."""
    n, c, h, w = x.shape
    o, i, kh, kw = conv.weight.shape
    return _signature((n, h, w, c), (kh, kw, i, o), conv.stride[0])


def eligible(x_shape, w_shape, stride: int) -> bool:
    cin, cout = int(w_shape[2]), int(w_shape[3])
    return stride == 1 and min(cin, cout) >= MIN_QUANT_CHANNELS


def conv_eligible(conv: nn.Conv2d) -> bool:
    """``eligible`` for a conv module (square stride, OIHW weight)."""
    o, i = conv.weight.shape[:2]
    return conv.stride[0] == 1 and conv.stride[1] == 1 and min(o, i) >= MIN_QUANT_CHANNELS


@dataclasses.dataclass
class _CalibRecord:
    sig: Tuple
    maxabs: object  # a device scalar during the pass, a float after


def _entry(sig: Tuple, maxabs: float, margin: float) -> dict:
    return {"sig": [list(sig[0]), list(sig[1]), int(sig[2])], "scale": max(float(maxabs) * margin, 1e-8) / 127.0}


class Calibration:
    """Records max|x| of every eligible conv's input during a forward."""

    def __init__(self):
        self.records: List[_CalibRecord] = []

    def observe(self, sig: Tuple, x: torch.Tensor) -> None:
        self.records.append(_CalibRecord(sig=sig, maxabs=x.detach().float().abs().max()))

    def finalize(self, margin: float = 1.1) -> List[dict]:
        """The scales, fetched from the device in one copy."""
        if not self.records:
            return []
        maxima = torch.stack([r.maxabs for r in self.records]).cpu().numpy()
        return [_entry(r.sig, v, margin) for r, v in zip(self.records, maxima)]

    @staticmethod
    def merge(runs: List[List[dict]]) -> List[dict]:
        """Max-merge several calibration runs (e.g. different pose draws)."""
        base = [dict(e) for e in runs[0]]
        for run in runs[1:]:
            if len(run) != len(base):
                raise ValueError("calibration runs disagree on conv count")
            for b, e in zip(base, run):
                if b["sig"] != e["sig"]:
                    raise ValueError(f"calibration runs disagree on signature: {b['sig']} vs {e['sig']}")
                b["scale"] = max(b["scale"], e["scale"])
        return base


class _Apply:
    def __init__(self, scales: List[dict]):
        self.scales = scales
        self.idx = 0

    def next_scale(self, sig: Tuple) -> float:
        if self.idx >= len(self.scales):
            raise RuntimeError(
                f"int8 teacher: the program has more eligible convs ({self.idx + 1}+) "
                f"than the calibration recorded ({len(self.scales)}) — recalibrate"
            )
        entry = self.scales[self.idx]
        got = (tuple(entry["sig"][0]), tuple(entry["sig"][1]), int(entry["sig"][2]))
        if sig != got:
            raise RuntimeError(
                f"int8 teacher: conv #{self.idx} signature mismatch — traced {sig}, "
                f"calibrated {got}; the calibrated program does not match this one"
            )
        self.idx += 1
        return float(entry["scale"])


@contextmanager
def calibrate():
    """Calibration scope: run the teacher forward inside."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, Calibration()
    try:
        yield _CURRENT
    finally:
        _CURRENT = prev


@torch.no_grad()
def run_calibration(fn, *args, margin: float = 1.1) -> List[dict]:
    """Calibrate ``fn(*args)``: one eager forward, the maxima kept on the
    device and fetched once at the end.  ``margin`` head-rooms them; the
    round/clip at +-127 absorbs anything beyond."""
    with calibrate() as rec:
        fn(*args)
    return rec.finalize(margin)


@contextmanager
def apply_scales(scales: Optional[List[dict]]):
    """Scope in which every eligible conv runs int8.  ``scales=None`` is a
    no-op (keeps call sites unconditional)."""
    global _CURRENT
    if scales is None:
        yield None
        return
    ctx = _Apply(scales)
    prev, _CURRENT = _CURRENT, ctx
    ok = False
    try:
        yield ctx
        ok = True
    finally:
        _CURRENT = prev
        # Check the count only on a clean exit: never mask an exception in
        # flight (e.g. a signature mismatch) with the count error.
        if ok and ctx.idx != len(scales):
            raise RuntimeError(
                f"int8 teacher: program consumed {ctx.idx} of {len(scales)} calibrated "
                f"convs — the calibrated program does not match this one"
            )


def current():
    return _CURRENT


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kh, kw, Ci, Co) HWIO -> (int8 weights, per-Co f32 scale), from f32."""
    wf = w.float()
    s = wf.abs().amax(dim=(0, 1, 2)).clamp_min(1e-8) / 127.0
    w8 = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return w8, s


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, x_scale: float, padding: int) -> torch.Tensor:
    """The plain int8 conv in the JAX signature: x NHWC, w HWIO (float),
    stride 1; output NHWC in x's dtype, without bias."""
    w8, w_s = quantize_weight(w)
    return cuda_int8_conv.int8_conv_plain(x, w8, w_s, x_scale, padding)


def save_scales(path: str, scales: List[dict]) -> None:
    with open(path, "w") as f:
        json.dump({"format": SCALES_FORMAT, "scales": scales}, f)


def load_scales(path: str) -> List[dict]:
    with open(path) as f:
        blob = json.load(f)
    if blob.get("format") != SCALES_FORMAT:
        raise ValueError(f"{path}: not a tha4 int8 scales file")
    return blob["scales"]


# ---------------------------------------------------------------------------
# The conv hook and the frozen weights
# ---------------------------------------------------------------------------


@torch.no_grad()
def store_int8(module: nn.Module) -> None:
    """Keep, beside every eligible conv under ``module``, its weight as Q1
    reads it (``int8_layout``, ``cuda_int8_conv.weight_layout``) and its
    per-Cout f32 scale (``int8_scale``), quantized from the weight as it
    stands, which must still be f32 (a conv that has them keeps them):
    buffers outside the state dict, for a frozen network (a later change to
    a weight does not reach them)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and conv_eligible(m) and getattr(m, "int8_layout", None) is None:
            if m.weight.dtype != torch.float32:
                raise ValueError(f"store_int8: quantize from the f32 weight, got {m.weight.dtype}")
            w8, s = quantize_weight(m.weight.permute(2, 3, 1, 0))
            m.register_buffer("int8_layout", cuda_int8_conv.weight_layout(w8), persistent=False)
            m.register_buffer("int8_scale", s.contiguous(), persistent=False)


def _int8_weights(conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    layout = getattr(conv, "int8_layout", None)
    if layout is not None:
        return layout, conv.int8_scale
    if conv.weight.dtype not in (torch.float32, torch.float64):
        raise RuntimeError(f"int8 teacher: a {conv.weight.dtype} conv without stored int8 weights; freeze the teacher "
                           "(Teacher.freeze quantizes from f32 first)")
    w8, s = quantize_weight(conv.weight.permute(2, 3, 1, 0))
    return cuda_int8_conv.weight_layout(w8), s


def conv_hook(ctx, conv: nn.Conv2d, x: torch.Tensor) -> Optional[torch.Tensor]:
    """What ``ops.nn.Conv2d`` does with an eligible conv under a scope: a
    calibration records x and returns None (the conv runs as usual); an
    apply scope returns the int8 conv of NCHW ``x``, NCHW (channels-last
    memory), in x's dtype, bias added."""
    sig = nchw_signature(x, conv)
    if isinstance(ctx, Calibration):
        ctx.observe(sig, x)
        return None
    x_scale = ctx.next_scale(sig)
    layout, w_s = _int8_weights(conv)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    out = cuda_int8_conv.int8_conv(x.permute(0, 2, 3, 1), layout, w_s, x_scale, conv.padding[0], bias)
    return out.permute(0, 3, 1, 2)

