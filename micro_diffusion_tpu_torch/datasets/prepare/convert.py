"""Convert raw images + captions into image MDS shards (width/height/jpg/caption).

Generic equivalent of the reference's per-dataset convert.py files (same column schema,
jdb/convert.py:42-47): walks an images directory, pairs each image with its caption,
filters by minimum side, optionally applies NSFW-score and caption-cleaning rules from
the dataset spec, and writes MDS shards.

CLI:
    python -m micro_diffusion_tpu_torch.datasets.prepare.convert \
        --dataset jdb --images_dir ... --captions_file captions.json \
        --local_mds_dir ...

The port's own copy of micro_diffusion_tpu/datasets/prepare/convert.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import json
import os
from glob import glob
from typing import Dict, Iterator, Optional, Tuple

from ..mds import MDSWriter
from ..captions import CaptionProcessor
from .common import image_passes_filter, to_rgb
from .specs import DATASETS

COLUMNS = {"width": "int32", "height": "int32", "jpg": "jpeg", "caption": "str"}


def iter_image_caption_pairs(
    images_dir: str, captions: Dict[str, str]
) -> Iterator[Tuple[str, str]]:
    exts = (".jpg", ".jpeg", ".png", ".webp")
    for path in sorted(glob(os.path.join(images_dir, "**", "*"), recursive=True)):
        if not path.lower().endswith(exts):
            continue
        key = os.path.splitext(os.path.basename(path))[0]
        if key in captions:
            yield path, captions[key]


def load_captions(captions_file: str) -> Dict[str, str]:
    """captions file: json dict {image_stem: caption} or jsonl with
    {'img_path'/'key': ..., 'prompt'/'caption'/'Caption': ...} rows."""
    caps: Dict[str, str] = {}
    with open(captions_file) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            data = json.load(f)
            if isinstance(data, dict):
                return {str(k): str(v) for k, v in data.items()}
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            key = row.get("key") or row.get("img_path") or row.get("image")
            cap = row.get("caption") or row.get("prompt") or row.get("Caption")
            if key and cap:
                caps[os.path.splitext(os.path.basename(str(key)))[0]] = str(cap)
    return caps


def convert_to_mds(
    dataset: str,
    images_dir: str,
    captions_file: str,
    local_mds_dir: str,
    min_side: Optional[int] = None,
    size_limit: int = 256 * (1 << 20),
) -> int:
    from PIL import Image

    spec = DATASETS[dataset]
    min_side = min_side if min_side is not None else spec.min_side
    cleaner = CaptionProcessor() if spec.clean_captions else None
    captions = load_captions(captions_file)

    n = 0
    with MDSWriter(out=local_mds_dir, columns=COLUMNS, size_limit=size_limit) as w:
        for path, caption in iter_image_caption_pairs(images_dir, captions):
            try:
                img = to_rgb(Image.open(path))
            except Exception:
                continue
            width, height = img.size
            if not image_passes_filter(width, height, min_side):
                continue
            if cleaner is not None:
                caption = cleaner(caption)
            w.write({"width": width, "height": height, "jpg": img,
                     "caption": caption})
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    p.add_argument("--images_dir", required=True)
    p.add_argument("--captions_file", required=True)
    p.add_argument("--local_mds_dir", required=True)
    p.add_argument("--min_side", type=int, default=None)
    args = p.parse_args(argv)
    n = convert_to_mds(
        args.dataset, args.images_dir, args.captions_file, args.local_mds_dir,
        args.min_side,
    )
    print(f"wrote {n} samples to {args.local_mds_dir}")


if __name__ == "__main__":
    main()
