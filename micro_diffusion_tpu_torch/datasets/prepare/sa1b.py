"""SA1B prepare pipeline: Meta tar links + synthetic LLaVA captions -> MDS.

Reference: micro_diffusion/datasets/prepare/sa1b/{download,convert}.py.
Layout facts reproduced here:
  * the SA1B website serves a dynamic tab-separated links file: a header line, then
    ``<file_name>\t<url>`` rows (download.py:163-180);
  * synthetic captions come from PixArt-alpha/SAM-LLaVA-Captions10M's
    ``SA1B_caption.tar.gz``, one ``sa_<id>.txt`` per image (download.py:146-160);
  * convert pairs ``sa_<id>.jpg`` with ``captions_dir/sa_<id>.txt`` and writes the
    caption under the ``caption_syn_pixart_llava15`` column (convert.py:58-97);
  * download-time min-side filter 256 / downsize-to 512 (download.py:83-127).

The port's own copy of micro_diffusion_tpu/datasets/prepare/sa1b.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import os
from glob import glob
from typing import Iterator, List, Optional, Tuple

from ..mds import MDSWriter
from .common import parallel_mds_write, to_rgb

CAPTION_COLUMN = "caption_syn_pixart_llava15"
CAPTIONS_SOURCE = (
    "https://huggingface.co/datasets/PixArt-alpha/SAM-LLaVA-Captions10M/"
    "resolve/main/SA1B_caption.tar.gz"
)
LINKS_PAGE = "https://ai.meta.com/datasets/segment-anything-downloads/"

MDS_COLUMNS = {"width": "int32", "height": "int32", "jpg": "jpeg",
               CAPTION_COLUMN: "str"}


def parse_links_file(text: str) -> List[Tuple[str, str]]:
    """Parse the SA1B links file: skip the header line, split remaining lines on tab
    into (file_name, url) (download.py:166-180)."""
    out = []
    for line in text.splitlines()[1:]:
        line = line.strip()
        if not line:
            continue
        parts = line.split("\t")
        if len(parts) >= 2:
            out.append((parts[0], parts[1]))
    return out


def caption_path_for_image(captions_dir: str, image_path: str) -> str:
    """sa_433759.jpg -> <captions_dir>/sa_433759.txt (convert.py:80-84)."""
    stem = os.path.basename(image_path).split(".")[0]
    return os.path.join(captions_dir, stem + ".txt")


def _write_images(work: list, subdir: str) -> int:
    from PIL import Image

    n = 0
    with MDSWriter(out=subdir, columns=MDS_COLUMNS) as w:
        for img_path, captions_dir in work:
            try:
                img = to_rgb(Image.open(img_path))
                with open(caption_path_for_image(captions_dir, img_path)) as f:
                    cap = f.read().strip()
            except Exception:
                continue  # missing caption / unreadable image: skip (convert.py:92-97)
            width, height = img.size
            w.write({"width": width, "height": height, "jpg": img,
                     CAPTION_COLUMN: cap})
            n += 1
    return n


def convert_to_mds(
    images_dir: str,
    captions_dir: str,
    local_mds_dir: str,
    num_proc: int = 1,
) -> int:
    images = sorted(glob(os.path.join(images_dir, "**", "*jpg"), recursive=True))
    work = [(p, captions_dir) for p in images]
    n = parallel_mds_write(_write_images, work, local_mds_dir, num_proc)
    print(f"sa1b: wrote {n} of {len(images)} images")
    return n


def download(
    datadir: str,
    links_file: Optional[str] = None,
    data_fraction: float = 1.0,
    min_side: int = 256,
    downsize_to: int = 512,
    skip_existing: bool = False,
) -> None:
    """Fetch the LLaVA captions + the SA1B tars listed in ``links_file`` (the
    dynamic URL file saved from the SA1B website - its URL rotates, so it must be
    provided; download.py:163-174 prints the same instruction). Needs network."""
    import tarfile
    import urllib.request

    from .download import extract_and_filter

    os.makedirs(datadir, exist_ok=True)
    cap_tgz = os.path.join(datadir, "SA1B_caption.tar.gz")
    if not os.path.exists(cap_tgz):
        urllib.request.urlretrieve(CAPTIONS_SOURCE, cap_tgz)
    cap_dir = os.path.join(datadir, "captions")
    os.makedirs(cap_dir, exist_ok=True)
    with tarfile.open(cap_tgz) as tar:
        tar.extractall(cap_dir, filter="data")

    if links_file is None:
        raise RuntimeError(
            "SA1B tar URLs rotate; save the links file from "
            f"{LINKS_PAGE} and pass --links_file"
        )
    with open(links_file) as f:
        links = parse_links_file(f.read())
    links = links[: int(len(links) * data_fraction)]
    raw = os.path.join(datadir, "raw")
    for file_name, url in links:
        dest = os.path.join(datadir, "compressed", file_name)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        out_dir = os.path.join(raw, os.path.splitext(file_name)[0])
        if skip_existing and os.path.isdir(out_dir) and os.listdir(out_dir):
            continue
        urllib.request.urlretrieve(url, dest)
        if file_name.endswith(".tar"):
            extract_and_filter(dest, out_dir, min_side=min_side,
                               downsize_to=downsize_to)
            os.remove(dest)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download")
    d.add_argument("--datadir", required=True)
    d.add_argument("--links_file", default=None)
    d.add_argument("--data_fraction", type=float, default=1.0)
    d.add_argument("--skip_existing", action="store_true")
    c = sub.add_parser("convert")
    c.add_argument("--images_dir", required=True)
    c.add_argument("--captions_dir", required=True)
    c.add_argument("--local_mds_dir", required=True)
    c.add_argument("--num_proc", type=int, default=16)
    args = p.parse_args(argv)
    if args.cmd == "download":
        download(args.datadir, args.links_file, args.data_fraction,
                 skip_existing=args.skip_existing)
    else:
        convert_to_mds(args.images_dir, args.captions_dir, args.local_mds_dir,
                       args.num_proc)


if __name__ == "__main__":
    main()
