"""Native (C++) host components, built with g++ at first use and loaded
through ctypes (counterpart of ``tha4_tpu/native``): the iFacialMocap UDP
drain thread, the RGBA image codec and the pose converter's viseme solve.
A failed build raises; see ``loader``."""

from tha4_tpu_torch.native.loader import get_codec_library, get_mocap_library, get_viseme_library

__all__ = ["get_codec_library", "get_mocap_library", "get_viseme_library"]
