#!/usr/bin/env python
"""Asset packer CLI on the PyTorch port (the twin of tools/packer.py;
reference: tools/ucpio — the cpio archive tool used to bake built-in
assets). Imports only clap_tpu_torch, so it runs where JAX is not
installed.

Usage:
  python tools/torch_packer.py create out.pak file1 [file2 ...]
  python tools/torch_packer.py list out.pak
  python tools/torch_packer.py extract out.pak destdir
"""
import sys
import tarfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clap_tpu_torch.utils.librarian import make_pack


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        return 1
    cmd, pak = sys.argv[1], sys.argv[2]
    if cmd == "create":
        files = {}
        for f in sys.argv[3:]:
            p = Path(f)
            files[str(p)] = p.read_bytes()
        make_pack(pak, files)
        print(f"packed {len(files)} files -> {pak}")
    elif cmd == "list":
        with tarfile.open(pak) as tf:
            for m in tf.getmembers():
                print(f"{m.size:10d}  {m.name}")
    elif cmd == "extract":
        dest = sys.argv[3] if len(sys.argv) > 3 else "."
        with tarfile.open(pak) as tf:
            tf.extractall(dest, filter="data")
        print("extracted to", dest)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
