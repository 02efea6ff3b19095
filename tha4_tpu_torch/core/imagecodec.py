"""Image codec: sRGB <-> linear, premultiplied alpha, [0,1] <-> [-1,1]
(counterpart of ``tha4_tpu/core/imagecodec.py``).

The pixel functions take numpy arrays or tensors and return the same kind:
a tensor stays on its device, as the JAX package's ``xp`` switch keeps a
device array on the device.

Model units are premultiplied-alpha, linear-light RGBA scaled to [-1, 1]
(``image * 2 - 1``), HWC at the host boundary.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_SRGB_LINEAR_THRESHOLD = 0.04045
_LINEAR_SRGB_THRESHOLD = 0.003130804953560372


def srgb_to_linear(x):
    """Piecewise sRGB EOTF on numpy arrays or tensors."""
    xp = torch if torch.is_tensor(x) else np
    x = xp.clip(x, 0.0, 1.0)
    return xp.where(x <= _SRGB_LINEAR_THRESHOLD, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    xp = torch if torch.is_tensor(x) else np
    x = xp.clip(x, 0.0, 1.0)
    return xp.where(x <= _LINEAR_SRGB_THRESHOLD, x * 12.92, 1.055 * (x ** (1.0 / 2.4)) - 0.055)


def unpremultiply_alpha(rgb, alpha, epsilon: float = 1e-5):
    """Straight alpha from premultiplied."""
    xp = torch if torch.is_tensor(rgb) else np
    small = xp.abs(alpha) < epsilon
    denom = xp.where(small, xp.ones_like(alpha), alpha)
    return xp.where(small, xp.zeros_like(rgb), rgb / denom)


def load_image_hwc(
    path_or_pil,
    scale: float = 2.0,
    offset: float = -1.0,
    premultiply_alpha: bool = True,
    srgb_to_linear_conversion: bool = True,
) -> np.ndarray:
    """PNG file (or PIL image) -> HWC float32 array in model units:
    uint8 -> [0,1], sRGB -> linear on RGB, premultiply by alpha, then
    ``image * scale + offset``."""
    import PIL.Image

    pil_image = path_or_pil if hasattr(path_or_pil, "mode") else PIL.Image.open(path_or_pil)
    has_alpha = _pil_has_transparency(pil_image)
    target_mode = "RGBA" if has_alpha else "RGB"
    if pil_image.mode != target_mode:
        pil_image = pil_image.convert(target_mode)
    image = np.asarray(pil_image, dtype=np.float32) / 255.0
    if srgb_to_linear_conversion:
        image[:, :, 0:3] = srgb_to_linear(image[:, :, 0:3])
    if has_alpha and premultiply_alpha:
        image[:, :, 0:3] = image[:, :, 0:3] * image[:, :, 3:4]
    return image * scale + offset


def save_image_hwc(
    image,
    file_name: str,
    scale: float = 2.0,
    offset: float = -1.0,
    straight_alpha: bool = True,
    linear_to_srgb_conversion: bool = True,
) -> None:
    """HWC model-unit array (numpy or tensor) -> PNG."""
    import PIL.Image

    if torch.is_tensor(image):
        image = image.detach().float().cpu().numpy()
    image = (np.asarray(image, dtype=np.float32) - offset) / scale
    if image.shape[2] == 4:
        rgb = image[:, :, 0:3]
        a = np.clip(image[:, :, 3:4], 0.0, 1.0)
        if straight_alpha:
            rgb = unpremultiply_alpha(rgb, a)
        rgb = linear_to_srgb(rgb) if linear_to_srgb_conversion else np.clip(rgb, 0.0, 1.0)
        out = np.concatenate([rgb, a], axis=2)
        pil = PIL.Image.fromarray(np.uint8(np.rint(out * 255.0)), mode="RGBA")
    else:
        rgb = linear_to_srgb(image) if linear_to_srgb_conversion else np.clip(image, 0.0, 1.0)
        pil = PIL.Image.fromarray(np.uint8(np.rint(rgb * 255.0)), mode="RGB")
    dir_name = os.path.dirname(file_name)
    if dir_name:
        os.makedirs(dir_name, exist_ok=True)
    pil.save(file_name)


def encode_display_u8(image_hwc: torch.Tensor, scale: float = 2.0, offset: float = -1.0) -> torch.Tensor:
    """Model-unit RGBA tensor -> display-ready uint8 RGBA on the same device:
    the pixel math of ``save_image_hwc`` (straight alpha, linear -> sRGB,
    round to nearest), so a frame can be encoded before it leaves the card."""
    image = (image_hwc.float() - offset) / scale
    rgb = image[..., 0:3]
    a = image[..., 3:4].clamp(0.0, 1.0)
    rgb = linear_to_srgb(unpremultiply_alpha(rgb, a))
    return torch.round(torch.cat([rgb, a], dim=-1) * 255.0).to(torch.uint8)


def save_image_u8_hwc(image_u8, file_name: str) -> None:
    """uint8 HWC RGBA/RGB (already display-encoded; numpy or tensor) -> PNG."""
    import PIL.Image

    if torch.is_tensor(image_u8):
        image_u8 = image_u8.cpu().numpy()
    image_u8 = np.asarray(image_u8)
    mode = "RGBA" if image_u8.shape[-1] == 4 else "RGB"
    dir_name = os.path.dirname(file_name)
    if dir_name:
        os.makedirs(dir_name, exist_ok=True)
    PIL.Image.fromarray(image_u8, mode=mode).save(file_name)


def _cat(parts):
    return torch.cat(parts, dim=-1) if torch.is_tensor(parts[0]) else np.concatenate(parts, axis=-1)


def to_display_rgba(image_hwc, scale: float = 2.0, offset: float = -1.0):
    """Model units -> displayable [0,1] RGBA (linear->sRGB, keep premultiplied),
    the puppeteer's postprocess
    (reference: src/tha4/app/character_model_ifacialmocap_puppeteer.py:325-345)."""
    image = (image_hwc - offset) / scale
    rgb = linear_to_srgb(image[..., 0:3])
    a = image[..., 3:4].clip(0.0, 1.0)
    return _cat([rgb, a])


def composite_greenscreen(image_hwc, scale: float = 2.0, offset: float = -1.0):
    """Model-unit premultiplied RGBA -> RGB over a green background in sRGB
    (reference: src/tha4/shion/base/image_util.py:72-90): linear->sRGB of the
    (premultiplied-as-straight) RGB, multiply by alpha, add (1-a) to green."""
    image = (image_hwc - offset) / scale
    rgb = linear_to_srgb(image[..., 0:3])
    a = image[..., 3:4]
    zero = (torch if torch.is_tensor(a) else np).zeros_like(a)
    return rgb * a + _cat([zero, 1.0 - a, zero])


def _pil_has_transparency(pil_image) -> bool:
    if pil_image.info.get("transparency", None) is not None:
        return True
    if pil_image.mode == "P":
        transparent = pil_image.info.get("transparency", -1)
        for _, index in pil_image.getcolors():
            if index == transparent:
                return True
    elif pil_image.mode == "RGBA":
        extrema = pil_image.getextrema()
        if extrema[3][0] < 255:
            return True
    return False
