"""CC12M prepare pipeline: webdataset tars (paired .jpg/.txt members) -> MDS.

Reference: micro_diffusion/datasets/prepare/cc12m/{download,convert}.py.
Layout facts reproduced here:
  * tars ``cc12m-train-{idx:>04}.tar`` (2176 of them) on pixparse/cc12m-wds
    (download.py:49-52);
  * each tar pairs ``<stem>.jpg`` with ``<stem>.txt`` holding the caption
    (convert.py:57-69);
  * convert-time min-side filter (256) and bicubic downsize of the shorter side to
    <= 512 (convert.py:96-121) - unlike jdb/diffdb, cc12m filters at convert because
    the raw tars are kept;
  * two MDS variants are built: min-side >= 256 and >= 512
    (scripts/get_cc12m_dataset.sh:27-31);
  * per-process writers + merge_index (convert.py:134-148).

TPU-first deviation: tar members are streamed directly with tarfile (no extractall to
a temp dir + rmtree as in convert.py:53-73) - same pairs, no disk churn.

The port's own copy of micro_diffusion_tpu/datasets/prepare/cc12m.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import os
import tarfile
from glob import glob
from io import BytesIO
from typing import Iterator, List, Optional, Tuple

from ..mds import MDSWriter
from .common import downsize_image, image_passes_filter, parallel_mds_write, to_rgb

HF_REPO = "pixparse/cc12m-wds"
NUM_ARCHIVES = 2176

MDS_COLUMNS = {"width": "int32", "height": "int32", "jpg": "jpeg", "caption": "str"}


def archive_filename(idx: int) -> str:
    return f"cc12m-train-{idx:>04}.tar"


def iter_tar_pairs(tar_path: str) -> Iterator[Tuple[object, str]]:
    """Yield (PIL image, caption) for every .jpg/.txt stem pair in a wds tar
    (convert.py:57-69). Unpaired members are skipped."""
    from PIL import Image

    with tarfile.open(tar_path, "r") as tar:
        members = {m.name: m for m in tar.getmembers() if m.isfile()}
        for name in sorted(members):
            if not name.endswith(".txt"):
                continue
            jpg_name = name[: -len(".txt")] + ".jpg"
            if jpg_name not in members:
                continue
            try:
                cap = tar.extractfile(members[name]).read().decode("utf-8")
                img = Image.open(BytesIO(tar.extractfile(members[jpg_name]).read()))
                img.load()
            except Exception:
                continue
            yield img, cap


def _write_tars(work: list, subdir: str) -> int:
    n = 0
    with MDSWriter(out=subdir, columns=MDS_COLUMNS) as w:
        for tar_path, min_side, downsize_to in work:
            for img, cap in iter_tar_pairs(tar_path):
                width, height = img.size
                if min(width, height) > downsize_to:
                    img = downsize_image(img, downsize_to)
                    width, height = img.size
                if not image_passes_filter(width, height, min_side):
                    continue
                w.write({"width": width, "height": height, "jpg": to_rgb(img),
                         "caption": cap})
                n += 1
    return n


def convert_to_mds(
    wds_dir: str,
    local_mds_dir: str,
    min_side: int = 256,
    downsize_to: int = 512,
    num_proc: int = 1,
) -> int:
    tars = sorted(glob(os.path.join(wds_dir, "*tar")))
    work = [(t, min_side, downsize_to) for t in tars]
    n = parallel_mds_write(_write_tars, work, local_mds_dir, num_proc)
    print(f"cc12m: wrote {n} samples from {len(tars)} tars (min_side {min_side})")
    return n


def download(datadir: str, valid_ids: Optional[List[int]] = None) -> None:
    """Fetch the raw wds tars (kept as-is; filtering happens at convert)."""
    from huggingface_hub import hf_hub_download

    ids = valid_ids if valid_ids is not None else list(range(NUM_ARCHIVES))
    for idx in ids:
        hf_hub_download(HF_REPO, repo_type="dataset",
                        filename=archive_filename(idx), local_dir=datadir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download")
    d.add_argument("--datadir", required=True)
    d.add_argument("--valid_ids", type=int, nargs="*", default=None)
    c = sub.add_parser("convert")
    c.add_argument("--wds_dir", required=True)
    c.add_argument("--local_mds_dir", required=True)
    c.add_argument("--min_image_size", type=int, default=256)
    c.add_argument("--max_image_size", type=int, default=512)
    c.add_argument("--num_proc", type=int, default=16)
    args = p.parse_args(argv)
    if args.cmd == "download":
        download(args.datadir, args.valid_ids)
    else:
        convert_to_mds(args.wds_dir, args.local_mds_dir, args.min_image_size,
                       args.max_image_size, args.num_proc)


if __name__ == "__main__":
    main()
