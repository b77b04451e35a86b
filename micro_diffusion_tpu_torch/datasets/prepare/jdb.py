"""JourneyDB prepare pipeline: download tgz archives + jsonl captions, convert to MDS.

Reference: micro_diffusion/datasets/prepare/jdb/{download,convert}.py.
Layout facts reproduced here:
  * image archives live at ``data/{split}/imgs/{idx:>03}.tgz`` on the
    JourneyDB/JourneyDB HF dataset repo, idx 0..199 per split (download.py:109-125);
  * caption metadata is ``data/train/train_anno_realease_repath.jsonl`` /
    ``data/valid/valid_anno_repath.jsonl`` (download.py:62-105), rows
    ``{"img_path": "./000/xxx.jpg", "prompt": ...}`` (convert.py:63-66);
  * convert keeps only rows whose archive dir was actually downloaded
    (convert.py:58-68) and writes width/height/jpg/caption MDS shards;
  * download filters min-side < 256 and bicubic-downsizes so the shorter side is
    <= 512 (download.py:137-165) - shared logic in common.py / download.py.

The fetch layer needs network; everything below it (extract, filter, caption pairing,
MDS write) is pure-local and unit-tested against synthetic fixtures.

The port's own copy of micro_diffusion_tpu/datasets/prepare/jdb.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import json
import os
from glob import glob
from typing import Dict, Iterator, List, Optional, Tuple

from ..mds import MDSWriter
from .common import image_passes_filter, to_rgb
from .download import extract_and_filter

HF_REPO = "JourneyDB/JourneyDB"
NUM_ARCHIVES = 200
TRAIN_CAPTIONS = "train_anno_realease_repath.jsonl"
VALID_CAPTIONS = "valid_anno_repath.jsonl"

MDS_COLUMNS = {"width": "int32", "height": "int32", "jpg": "jpeg", "caption": "str"}


def archive_path(split: str, idx: int) -> str:
    """In-repo path of one image archive (download.py:109-125)."""
    assert split in ("train", "valid"), split
    return f"data/{split}/imgs/{idx:>03}.tgz"


def captions_path(split: str) -> str:
    name = TRAIN_CAPTIONS if split == "train" else VALID_CAPTIONS
    return f"data/{split}/{name}"


def iter_caption_rows(captions_jsonl: str) -> Iterator[Tuple[str, str]]:
    """Yield (relative img_path, prompt) rows from the annotation jsonl
    (convert.py:63-66). Rows without a prompt or path are skipped."""
    with open(captions_jsonl) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            path = row.get("img_path")
            prompt = row.get("prompt")
            if path and prompt:
                yield str(path).strip("./"), str(prompt)


def convert_to_mds(
    images_dir: str,
    captions_jsonl: str,
    local_mds_dir: str,
    size_limit: int = 256 * (1 << 20),
) -> int:
    """images_dir holds per-archive subdirs (e.g. ``000/``, ``001/``); pairs each
    jsonl row with its image and writes MDS (convert.py:40-87). Rows whose archive
    was not downloaded are skipped."""
    from PIL import Image

    valid_archives = {
        os.path.basename(p) for p in glob(os.path.join(images_dir, "*"))
    }
    n = 0
    with MDSWriter(out=local_mds_dir, columns=MDS_COLUMNS,
                   size_limit=size_limit) as w:
        for rel_path, prompt in iter_caption_rows(captions_jsonl):
            if os.path.dirname(rel_path) not in valid_archives:
                continue
            try:
                img = to_rgb(Image.open(os.path.join(images_dir, rel_path)))
            except Exception:
                continue
            width, height = img.size
            w.write({"width": width, "height": height, "jpg": img,
                     "caption": prompt})
            n += 1
    return n


def download(
    datadir: str,
    valid_ids: Optional[List[int]] = None,
    splits: Tuple[str, ...] = ("train", "valid"),
    min_side: int = 256,
    downsize_to: int = 512,
    num_proc: int = 8,
) -> None:
    """Fetch caption jsonls + the selected image archives, extract + filter + downsize
    (download.py flow). Requires network access."""
    from huggingface_hub import hf_hub_download

    ids = valid_ids if valid_ids is not None else list(range(NUM_ARCHIVES))
    comp = os.path.join(datadir, "compressed")
    raw = os.path.join(datadir, "raw")
    for split in splits:
        os.makedirs(os.path.join(raw, split, "imgs"), exist_ok=True)
        cap_rel = captions_path(split)
        hf_hub_download(
            HF_REPO, repo_type="dataset",
            subfolder=os.path.dirname(cap_rel) ,
            filename=os.path.basename(cap_rel) + ".tgz", local_dir=comp,
        )
        extract_and_filter(  # jsonl-only tgz: images filter is a no-op
            os.path.join(comp, cap_rel + ".tgz"),
            os.path.join(raw, split), min_side=0, downsize_to=downsize_to,
            keep_non_images=True,
        )
        for idx in ids:
            rel = archive_path(split, idx)
            path = hf_hub_download(
                HF_REPO, repo_type="dataset", subfolder=os.path.dirname(rel),
                filename=os.path.basename(rel), local_dir=comp,
            )
            extract_and_filter(
                path, os.path.join(raw, split, "imgs", f"{idx:>03}"),
                min_side=min_side, downsize_to=downsize_to,
            )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download")
    d.add_argument("--datadir", required=True)
    d.add_argument("--valid_ids", type=int, nargs="*", default=None)
    d.add_argument("--num_proc", type=int, default=8)
    c = sub.add_parser("convert")
    c.add_argument("--images_dir", required=True)
    c.add_argument("--captions_jsonl", required=True)
    c.add_argument("--local_mds_dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "download":
        download(args.datadir, args.valid_ids, num_proc=args.num_proc)
    else:
        n = convert_to_mds(args.images_dir, args.captions_jsonl, args.local_mds_dir)
        print(f"jdb: wrote {n} samples to {args.local_mds_dir}")


if __name__ == "__main__":
    main()
