"""SIBR remote-viewer TCP protocol.

Port of opengaussian_tpu/viewer/network_gui.py (reference
gaussian_renderer/network_gui.py, wire format at :26-86; the reference keeps
the hookup commented out, train.py:1057). A `ViewerServer` listens without
blocking; once a viewer connects, each poll receives a custom camera and
flags and replies with the rendered RGB bytes. The messages are the SIBR
remote viewer's: little-endian lengths, JSON, float32 matrices. The trainer
owns the server (`Trainer.viewer_port`, `--port`) and polls it once per
iteration; each frame is one `render`, one K1 launch on the GPU.
"""

from __future__ import annotations

import json
import socket
import struct
import traceback

import numpy as np


class ViewerServer:
    """One listening socket and at most one connected viewer."""

    def __init__(self, wish_host: str = "127.0.0.1", wish_port: int = 6009):
        self.conn: socket.socket | None = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((wish_host, wish_port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self):
        """Accept a waiting viewer, if one is waiting."""
        try:
            self.conn, self.addr = self.listener.accept()
        except BlockingIOError:
            return
        print(f"viewer connected by {self.addr}")
        self.conn.settimeout(None)

    def _read_bytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.conn.recv(n - len(out))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            out += chunk
        return out

    def read(self) -> dict:
        (length,) = struct.unpack("<I", self._read_bytes(4))
        return json.loads(self._read_bytes(length).decode("utf-8"))

    def receive(self):
        """-> (camera dict or None, do_training, keep_alive, scaling_modifier)."""
        msg = self.read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None, msg["train"], msg["keep_alive"], msg["scaling_modifier"]
        # SIBR sends the transposed w2c with flipped Y/Z axes; undo it as the
        # reference does (network_gui.py:74-76 negates columns 1, 2)
        m = np.reshape(np.asarray(msg["view_matrix"], np.float32), (4, 4)).copy()
        m[:, 1] = -m[:, 1]
        m[:, 2] = -m[:, 2]
        cam = dict(width=width, height=height, fovx=msg["fov_x"], fovy=msg["fov_y"],
                   znear=msg["z_near"], zfar=msg["z_far"], w2c=m.T)
        return cam, msg["train"], msg["keep_alive"], msg["scaling_modifier"]

    def send(self, image_bytes: bytes | None, source_path: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(source_path).to_bytes(4, "little"))
        self.conn.sendall(source_path.encode("utf-8"))

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
        self.conn = None

    def poll_and_render(self, render_fn, source_path: str):
        """The train loop's viewer tick: render_fn(cam_dict, scaling_modifier)
        -> uint8 HxWx3 bytes. Serves the connected viewer until it asks for
        training to go on (reference train.py:235-248). A viewer that fails
        or leaves is dropped and training goes on."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scale_mod = self.receive()
                payload = None
                if cam is not None:
                    payload = render_fn(cam, scale_mod)
                self.send(payload, source_path)
                if do_training and not keep_alive:
                    break
            except ConnectionError as e:  # the viewer left
                print(f"viewer: {e}")
                self._drop()
            except Exception:  # the viewer must never stop training
                traceback.print_exc()
                self._drop()

    def close(self):
        self._drop()
        self.listener.close()


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009) -> ViewerServer:
    """A server listening on (wish_host, wish_port)."""
    return ViewerServer(wish_host, wish_port)
