"""DiffusionDB prepare pipeline: zip parts + parquet metadata -> MDS, with the NSFW
filter actually enforced.

Reference: micro_diffusion/datasets/prepare/diffdb/{download,convert}.py.
Layout facts reproduced here:
  * image archives ``part-{idx:>06}.zip`` under subfolder ``diffusiondb-large-part-1``
    for idx <= 10000 else ``...-part-2``, idx 1..14000 (download.py:80-96);
  * metadata-large.parquet columns part_id / image_name / prompt / image_nsfw /
    prompt_nsfw (convert.py:66-70);
  * a sample is DROPPED when image_nsfw > threshold OR prompt_nsfw > threshold,
    default threshold 0.2 (convert.py:67-72, exposed as --safety_threshold);
  * images live at ``images/part-{part_id:>06}/{image_name}``; missing files are
    skipped silently (subset downloads, convert.py:76-80);
  * per-process MDS writers merged via merge_index (convert.py:101-116).

The port's own copy of micro_diffusion_tpu/datasets/prepare/diffdb.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import os
from typing import List, Optional

from ..mds import MDSWriter
from .common import parallel_mds_write, to_rgb

HF_REPO = "poloclub/diffusiondb"
NUM_ARCHIVES = 14000
SAFETY_THRESHOLD = 0.2

MDS_COLUMNS = {"width": "int32", "height": "int32", "jpg": "jpeg", "caption": "str"}


def archive_subfolder(idx: int) -> str:
    """Which repo subfolder holds part ``idx`` (download.py:80-83)."""
    return "diffusiondb-large-part-1" if idx < 10001 else "diffusiondb-large-part-2"


def archive_filename(idx: int) -> str:
    return f"part-{idx:>06}.zip"


def image_rel_path(part_id: int, image_name: str) -> str:
    return os.path.join("images", f"part-{part_id:>06}", image_name)


def filter_metadata(df, safety_threshold: float = SAFETY_THRESHOLD):
    """Apply the NSFW filter: keep rows with BOTH scores <= threshold
    (convert.py:67-72). Returns (kept_df, n_dropped)."""
    keep = (df["image_nsfw"] <= safety_threshold) & (
        df["prompt_nsfw"] <= safety_threshold
    )
    return df[keep], int((~keep).sum())


def _write_rows(rows: list, subdir: str) -> int:
    from PIL import Image

    n = 0
    with MDSWriter(out=subdir, columns=MDS_COLUMNS) as w:
        for images_dir, part_id, image_name, prompt in rows:
            path = os.path.join(images_dir, image_rel_path(int(part_id), image_name))
            if not os.path.exists(path):
                continue  # subset download: this part isn't on disk
            try:
                img = to_rgb(Image.open(path))
            except Exception:
                continue
            width, height = img.size
            w.write({"width": width, "height": height, "jpg": img,
                     "caption": str(prompt)})
            n += 1
    return n


def convert_to_mds(
    images_dir: str,
    local_mds_dir: str,
    metadata_parquet: Optional[str] = None,
    safety_threshold: float = SAFETY_THRESHOLD,
    num_proc: int = 1,
) -> int:
    """Read the parquet metadata, enforce the NSFW filter, write MDS shards
    (convert.py main flow)."""
    import pandas as pd

    metadata_parquet = metadata_parquet or os.path.join(
        images_dir, "metadata-large.parquet"
    )
    df = pd.read_parquet(metadata_parquet)
    df, dropped = filter_metadata(df, safety_threshold)
    rows = [
        (images_dir, pid, name, prompt)
        for pid, name, prompt in zip(df["part_id"], df["image_name"], df["prompt"])
    ]
    n = parallel_mds_write(_write_rows, rows, local_mds_dir, num_proc)
    print(f"diffdb: wrote {n}, dropped {dropped} above NSFW {safety_threshold}")
    return n


def download(
    datadir: str,
    valid_ids: Optional[List[int]] = None,
    min_side: int = 256,
    downsize_to: int = 512,
) -> None:
    """Fetch metadata parquet + the selected zip parts, extract + filter + downsize
    (download.py flow). Requires network access."""
    from huggingface_hub import hf_hub_download

    from .download import extract_and_filter

    comp = os.path.join(datadir, "compressed")
    raw = os.path.join(datadir, "raw")
    os.makedirs(raw, exist_ok=True)
    meta = hf_hub_download(HF_REPO, repo_type="dataset",
                           filename="metadata-large.parquet", local_dir=comp)
    import shutil

    shutil.copy(meta, os.path.join(raw, "metadata-large.parquet"))
    ids = valid_ids if valid_ids is not None else list(range(1, NUM_ARCHIVES + 1))
    for idx in ids:
        path = hf_hub_download(
            HF_REPO, repo_type="dataset", subfolder=archive_subfolder(idx),
            filename=archive_filename(idx), local_dir=comp,
        )
        extract_and_filter(
            path, os.path.join(raw, "images", f"part-{idx:>06}"),
            min_side=min_side, downsize_to=downsize_to, keep_non_images=True,
        )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download")
    d.add_argument("--datadir", required=True)
    d.add_argument("--valid_ids", type=int, nargs="*", default=None)
    c = sub.add_parser("convert")
    c.add_argument("--images_dir", required=True)
    c.add_argument("--local_mds_dir", required=True)
    c.add_argument("--metadata_parquet", default=None)
    c.add_argument("--safety_threshold", type=float, default=SAFETY_THRESHOLD)
    c.add_argument("--num_proc", type=int, default=16)
    args = p.parse_args(argv)
    if args.cmd == "download":
        download(args.datadir, args.valid_ids)
    else:
        convert_to_mds(args.images_dir, args.local_mds_dir, args.metadata_parquet,
                       args.safety_threshold, args.num_proc)


if __name__ == "__main__":
    main()
