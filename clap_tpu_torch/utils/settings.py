"""User settings persistence (counterpart of clap_tpu/utils/settings.py;
reference: core/settings.{c,h}).

JSON document persisted under a state directory (RES_STATE,
librarian.c:61-95: $HOME-based), typed get/set, onload callback pattern
— the reference restores window geometry and debug-UI state from it
(clap.c:530-549). Same schema here, minus the window (headless engine
keeps render options, seeds, volume, debug flags).
"""
from __future__ import annotations

import json
import os
from pathlib import Path


def state_dir() -> Path:
    base = os.environ.get("XDG_STATE_HOME") or os.path.join(
        os.path.expanduser("~"), ".local", "state")
    p = Path(base) / "clap_tpu"
    p.mkdir(parents=True, exist_ok=True)
    return p


class Settings:
    def __init__(self, name: str = "settings.json", on_load=None):
        self.path = state_dir() / name
        self.doc: dict = {}
        if self.path.exists():
            try:
                self.doc = json.loads(self.path.read_text())
            except (json.JSONDecodeError, OSError):
                self.doc = {}
        if on_load:
            on_load(self)

    def get(self, key: str, default=None):
        cur = self.doc
        for part in key.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def set(self, key: str, value) -> None:
        parts = key.split(".")
        cur = self.doc
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = value
        self.flush()

    def flush(self) -> None:
        self.path.write_text(json.dumps(self.doc, indent=2))
