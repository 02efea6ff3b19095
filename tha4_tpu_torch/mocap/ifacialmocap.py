"""iFacialMocap wire protocol: UDP capture + v1/v2 text parsers (counterpart of
``tha4_tpu/mocap/ifacialmocap.py``, without its native drain thread).

Reference: src/tha4/mocap/ifacialmocap_v2.py and the puppeteer's socket
handling (src/tha4/app/character_model_ifacialmocap_puppeteer.py:109-121):
a nonblocking UDP socket on port 49983, draining to the latest packet.
"""

from __future__ import annotations

import errno
import math
import socket
from typing import Dict, Optional

from tha4_tpu_torch.mocap.ifacialmocap_constants import (
    BLENDSHAPE_NAMES,
    HEAD_BONE_QUAT,
    HEAD_BONE_X,
    HEAD_BONE_Y,
    HEAD_BONE_Z,
    LEFT_EYE_BONE_QUAT,
    LEFT_EYE_BONE_X,
    LEFT_EYE_BONE_Y,
    LEFT_EYE_BONE_Z,
    RIGHT_EYE_BONE_QUAT,
    RIGHT_EYE_BONE_X,
    RIGHT_EYE_BONE_Y,
    RIGHT_EYE_BONE_Z,
)

IFACIALMOCAP_PORT = 49983
IFACIALMOCAP_START_STRING = (
    "iFacialMocap_sahuasouryya9218sauhuiayeta91555dy3719|sendDataVersion=v2".encode("utf-8")
)


def create_default_ifacialmocap_pose() -> Dict[str, object]:
    """All blendshapes 0, all rotations 0, identity quats
    (reference ifacialmocap_pose.py)."""
    pose: Dict[str, object] = {name: 0.0 for name in BLENDSHAPE_NAMES}
    for key in (
        HEAD_BONE_X, HEAD_BONE_Y, HEAD_BONE_Z,
        LEFT_EYE_BONE_X, LEFT_EYE_BONE_Y, LEFT_EYE_BONE_Z,
        RIGHT_EYE_BONE_X, RIGHT_EYE_BONE_Y, RIGHT_EYE_BONE_Z,
    ):
        pose[key] = 0.0
    for key in (HEAD_BONE_QUAT, LEFT_EYE_BONE_QUAT, RIGHT_EYE_BONE_QUAT):
        pose[key] = [0.0, 0.0, 0.0, 1.0]
    return pose


def _normalize_key(key: str) -> str:
    if key.endswith("_L"):
        return key[:-2] + "Left"
    if key.endswith("_R"):
        return key[:-2] + "Right"
    return key


def _parse_rotation(prefix_stripped: str, out: Dict, kx: str, ky: str, kz: str) -> None:
    components = prefix_stripped.split(",")
    out[kx] = float(components[0]) * math.pi / 180
    out[ky] = float(components[1]) * math.pi / 180
    out[kz] = float(components[2]) * math.pi / 180


def parse_ifacialmocap_v2_pose(text: str) -> Dict[str, object]:
    """'key&value|...|=head#x,y,z,...' -> blendshape dict (degrees -> radians)
    (reference ifacialmocap_v2.py:11-48)."""
    output: Dict[str, object] = {}
    for part in text.split("|"):
        part = part.strip()
        if not part:
            continue
        if "&" in part:
            key, value = part.split("&", 1)
            key = _normalize_key(key)
            if key in BLENDSHAPE_NAMES:
                output[key] = float(value) / 100.0
        elif part.startswith("=head#"):
            components = part[len("=head#"):].split(",")
            assert len(components) == 6
            _parse_rotation(part[len("=head#"):], output, HEAD_BONE_X, HEAD_BONE_Y, HEAD_BONE_Z)
        elif part.startswith("rightEye#"):
            _parse_rotation(part[len("rightEye#"):], output, RIGHT_EYE_BONE_X, RIGHT_EYE_BONE_Y, RIGHT_EYE_BONE_Z)
        elif part.startswith("leftEye#"):
            _parse_rotation(part[len("leftEye#"):], output, LEFT_EYE_BONE_X, LEFT_EYE_BONE_Y, LEFT_EYE_BONE_Z)
    output[HEAD_BONE_QUAT] = [0.0, 0.0, 0.0, 1.0]
    output[LEFT_EYE_BONE_QUAT] = [0.0, 0.0, 0.0, 1.0]
    output[RIGHT_EYE_BONE_QUAT] = [0.0, 0.0, 0.0, 1.0]
    return output


def parse_ifacialmocap_v1_pose(text: str) -> Dict[str, object]:
    """v1 format: 'key-value|...' (reference ifacialmocap_v2.py:52-89)."""
    output: Dict[str, object] = {}
    for part in text.split("|"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("=head#"):
            _parse_rotation(part[len("=head#"):], output, HEAD_BONE_X, HEAD_BONE_Y, HEAD_BONE_Z)
        elif part.startswith("rightEye#"):
            _parse_rotation(part[len("rightEye#"):], output, RIGHT_EYE_BONE_X, RIGHT_EYE_BONE_Y, RIGHT_EYE_BONE_Z)
        elif part.startswith("leftEye#"):
            _parse_rotation(part[len("leftEye#"):], output, LEFT_EYE_BONE_X, LEFT_EYE_BONE_Y, LEFT_EYE_BONE_Z)
        elif "-" in part:
            key, value = part.split("-", 1)
            key = _normalize_key(key)
            if key in BLENDSHAPE_NAMES:
                output[key] = float(value) / 100.0
    output[HEAD_BONE_QUAT] = [0.0, 0.0, 0.0, 1.0]
    output[LEFT_EYE_BONE_QUAT] = [0.0, 0.0, 0.0, 1.0]
    output[RIGHT_EYE_BONE_QUAT] = [0.0, 0.0, 0.0, 1.0]
    return output


def parse_ifacialmocap_pose(text: str) -> Dict[str, object]:
    """Version-dispatching parser: v2 packets carry 'key&value' pairs, v1
    packets 'key-value' pairs (reference ifacialmocap_v2.py:11 vs :52).  A
    legacy v1 packet fed to the v2 parser would silently drop every
    blendshape (no '&' anywhere) and render a neutral face; dispatch on the
    separator instead so both documented wire formats really work."""
    if "&" in text:
        return parse_ifacialmocap_v2_pose(text)
    return parse_ifacialmocap_v1_pose(text)


class IFacialMocapReceiver:
    """UDP receiver draining to the freshest packet per frame
    (reference character_model_ifacialmocap_puppeteer.py:93-121): the
    reference's nonblocking-socket drain on the render thread.  The JAX
    package's receiver can also drain on a native thread
    (``tha4_tpu/native/mocap_receiver.cpp``); the port has no such thread
    yet, so each frame parses whatever sat in the kernel buffer since the
    previous frame."""

    def __init__(self, port: int = IFACIALMOCAP_PORT, capture_address: Optional[str] = None):
        self.port = port
        self.capture_address = capture_address
        self.socket: Optional[socket.socket] = None

    def start(self) -> None:
        self.socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.socket.bind(("", self.port))
        self.socket.setblocking(False)
        if self.capture_address is not None:
            # Ask the iOS app to start streaming to us.
            self.socket.sendto(IFACIALMOCAP_START_STRING, (self.capture_address, self.port))

    def read_pose(self) -> Optional[Dict[str, object]]:
        """Parse the freshest packet, or None if none arrived since last call."""
        if self.socket is None:
            return None
        data = None
        while True:
            try:
                data = self.socket.recv(8192)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                raise
        if data is None:
            return None
        return self._complete(parse_ifacialmocap_pose(data.decode("utf-8", errors="replace")))

    @staticmethod
    def _complete(parsed: Dict[str, object]) -> Dict[str, object]:
        """Overlay the parsed packet on a default pose.  The reference
        replaces its pose dict wholesale
        (character_model_ifacialmocap_puppeteer.py:120), which crashes the
        converter when a packet omits blendshapes — the iOS app always sends
        complete packets, masking it.  Overlaying is bit-identical for
        complete packets and robust to partial/foreign senders."""
        pose = create_default_ifacialmocap_pose()
        pose.update(parsed)
        return pose

    def close(self) -> None:
        if self.socket is not None:
            self.socket.close()
            self.socket = None
