"""Resource librarian + built-in asset packs (counterpart of
clap_tpu/utils/librarian.py; reference: core/librarian.{c,h} +
core/cpio.c + tools/ucpio + pack-assets.cmake).

URI resolution by resource type (librarian.c:61-95):
  RES_CONFIG → <base>/config/, RES_ASSET → <base>/asset/,
  RES_SHADER → <base>/asset/shaders/, RES_STATE → the user state dir.

Lookups consult built-in asset PACKS first (librarian.c:113 checks the
cpio baked into the binary before the filesystem). Packs here are
uncompressed tar archives — same role as the reference's cpio, stdlib
only; ``tools/packer.py`` is the ucpio analogue.

``lib_request`` keeps the reference's callback-on-load handle shape.
"""
from __future__ import annotations

import io
import tarfile
from dataclasses import dataclass, field
from enum import IntEnum
from pathlib import Path

from .settings import state_dir


class RES(IntEnum):
    CONFIG = 0
    ASSET = 1
    SHADER = 2
    STATE = 3


_SUBDIR = {RES.CONFIG: "config", RES.ASSET: "asset",
           RES.SHADER: "asset/shaders"}


@dataclass
class Librarian:
    base: Path = field(default_factory=Path.cwd)
    packs: list = field(default_factory=list)   # list[dict[name, bytes]]

    def add_pack(self, pack_path) -> int:
        """Mount a built-in asset pack (checked before the filesystem)."""
        entries = {}
        with tarfile.open(pack_path, "r") as tf:
            for m in tf.getmembers():
                if m.isfile():
                    entries[m.name] = tf.extractfile(m).read()
        self.packs.append(entries)
        return len(entries)

    def resolve(self, res_type: RES, name: str) -> Path:
        """URI → filesystem path (librarian.c:61-95)."""
        if res_type == RES.STATE:
            return state_dir() / name
        return self.base / _SUBDIR[res_type] / name

    def fetch(self, res_type: RES, name: str) -> bytes:
        """Built-in packs first, then the filesystem (librarian.c:104-120)."""
        if res_type != RES.STATE:
            key = f"{_SUBDIR[res_type]}/{name}"
            for pack in self.packs:
                if key in pack:
                    return pack[key]
                if name in pack:
                    return pack[name]
        return self.resolve(res_type, name).read_bytes()

    def lib_request(self, res_type: RES, name: str, on_load) -> "LibHandle":
        """Callback-on-load handle (librarian.h:39-43). Loading is
        synchronous here (no GL thread to keep unblocked), but the handle
        contract matches so call sites port 1:1."""
        h = LibHandle(name=name, res_type=res_type)
        try:
            h.data = self.fetch(res_type, name)
            h.state = "loaded"
        except (OSError, KeyError) as e:
            h.state = "error"
            h.error = str(e)
        on_load(h)
        return h


@dataclass
class LibHandle:
    name: str
    res_type: RES
    data: bytes | None = None
    state: str = "empty"
    error: str = ""


def make_pack(out_path, files: dict[str, bytes]) -> None:
    """Build an asset pack (pack-assets.cmake / ucpio role)."""
    with tarfile.open(out_path, "w") as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
