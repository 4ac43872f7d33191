"""Write the damaged-JPEG corpus chip_smoke.py decodes on the card, with Pillow's outcome for each file.

The card's machine has no Pillow, so the files are made here, by Pillow 12.1's JPEG save and chip_smoke.py's
arithmetic writer, damaged by `chip_smoke.jpeg_damage` (tests/jpeg_damage_files.py lists them), and stored
under tests/data/jpeg_damage/ beside `digests.json`: for each file the shape and the SHA-256 of
`Image.open(path).convert("RGB")`'s pixels, or the class of the error Pillow raises.  Seeded, so a rerun
writes the same bytes; `tests/test_torch_jpeg_damage.py` checks the digests still hold.

    python scripts/make_damaged_jpegs.py [--out tests/data/jpeg_damage]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jpeg_damage_files as files  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "tests" / "data" / "jpeg_damage"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.iterdir():
        old.unlink()
    digests = {}
    for name, data in files.corpus().items():
        (out / name).write_bytes(data)
        rgb = files.pillow_outcome(data)
        digests[name] = ({"error": rgb} if isinstance(rgb, str) else
                         {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()})
    (out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum((out / n).stat().st_size for n in digests)
    refused = sum("error" in e for e in digests.values())
    print(f"{len(digests)} files ({refused} refused by Pillow), {total} bytes, in {out}")


if __name__ == "__main__":
    main()
