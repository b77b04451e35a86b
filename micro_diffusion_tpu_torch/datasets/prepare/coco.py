"""COCO-2014 val prepare pipeline (the online-eval set): annotation JSON -> MDS.

Reference: micro_diffusion/datasets/prepare/coco/convert.py.
Facts reproduced here:
  * sources: images ``val2014.zip`` + ``annotations_trainval2014.zip``
    (convert.py:44-47);
  * captions come from ``annotations/captions_val2014.json``'s ``annotations`` list
    ({image_id, caption}); captions are grouped per image, newlines stripped, and the
    FIRST caption is kept (convert.py:50-66,81);
  * image file name is ``val2014/COCO_val2014_{image_id:012d}.jpg`` (convert.py:63);
  * MDS columns are jpg + caption('json') only (convert.py:68).

The port's own copy of micro_diffusion_tpu/datasets/prepare/coco.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import json
import os
from typing import Dict, List

from ..mds import MDSWriter

IMAGES_URL = "http://images.cocodataset.org/zips/val2014.zip"
ANNOTATIONS_URL = (
    "http://images.cocodataset.org/annotations/annotations_trainval2014.zip"
)

MDS_COLUMNS = {"jpg": "jpeg", "caption": "json"}


def image_file_name(image_id: int) -> str:
    return f"COCO_val2014_{image_id:012d}.jpg"


def group_captions(annotations: List[Dict]) -> Dict[int, List[str]]:
    """{image_id: [captions...]} preserving annotation order, newlines stripped
    (convert.py:52-60)."""
    out: Dict[int, List[str]] = {}
    for sample in annotations:
        image_id = int(sample["image_id"])
        caption = str(sample["caption"]).replace("\n", "")
        out.setdefault(image_id, []).append(caption)
    return out


def convert_to_mds(datadir: str, local_mds_dir: str) -> int:
    """datadir holds ``annotations/captions_val2014.json`` + ``val2014/*.jpg``."""
    from PIL import Image

    captions_path = os.path.join(datadir, "annotations", "captions_val2014.json")
    with open(captions_path) as f:
        data = json.load(f)
    coco_captions = group_captions(data["annotations"])

    n = 0
    with MDSWriter(out=local_mds_dir, columns=MDS_COLUMNS) as w:
        for image_id, caps in coco_captions.items():
            path = os.path.join(datadir, "val2014", image_file_name(image_id))
            try:
                img = Image.open(path)
                img.load()
            except Exception:
                continue
            w.write({"jpg": img, "caption": caps[0]})
            n += 1
    print(f"coco: wrote {n} samples")
    return n


def download(datadir: str) -> None:
    """Fetch + unzip val2014 images and annotations (convert.py:44-47). Network."""
    import urllib.request
    import zipfile

    os.makedirs(datadir, exist_ok=True)
    for url in (IMAGES_URL, ANNOTATIONS_URL):
        dest = os.path.join(datadir, os.path.basename(url))
        if not os.path.exists(dest):
            urllib.request.urlretrieve(url, dest)
        with zipfile.ZipFile(dest) as z:
            z.extractall(datadir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download")
    d.add_argument("--datadir", required=True)
    c = sub.add_parser("convert")
    c.add_argument("--datadir", required=True)
    c.add_argument("--local_mds_dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "download":
        download(args.datadir)
    else:
        convert_to_mds(args.datadir, args.local_mds_dir)


if __name__ == "__main__":
    main()
