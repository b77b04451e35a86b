"""Dataset download pipeline (jdb / diffdb / cc12m / sa1b / textcaps / coco).

Generic equivalent of the reference's per-dataset download.py files: fetches archives
(HF hub, HF datasets, or direct URLs per specs.py), extracts in a multiprocessing pool,
filters images below the minimum side, and bicubic-downsizes so the shorter side is
<= 512 to save disk (reference jdb/download.py:109-192).

Subset support for smoke runs: --valid_ids (explicit archive indices) and
--data_fraction (~1% recommended for initial experimentation, reference README.md:26);
--skip_existing resumes partial downloads (sa1b/download.py:56-59).

NOTE: on a machine without network access the download raises a clear error when the
fetch backend is unreachable. The extract/filter/downsize path is shared with
convert.py and covered by tests.

The port's own copy of micro_diffusion_tpu/datasets/prepare/download.py (these notes
reworded), over the port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
import os
import tarfile
import zipfile
from multiprocessing import Pool
from typing import List, Optional

from .common import downsize_image, image_passes_filter, to_rgb
from .specs import DATASETS


def select_archives(
    num_archives: int,
    valid_ids: Optional[List[int]],
    data_fraction: float,
) -> List[int]:
    if valid_ids:
        return [i for i in valid_ids if 0 <= i < num_archives]
    count = max(1, round(num_archives * data_fraction))
    return list(range(count))


def fetch_archive(spec, idx: int, datadir: str) -> Optional[str]:
    """Fetch one archive. Requires network access (hf_hub / urllib)."""
    os.makedirs(datadir, exist_ok=True)
    try:
        if spec.source_kind == "hf_hub":
            from huggingface_hub import hf_hub_download

            return hf_hub_download(
                spec.source, filename=f"{idx:05d}", repo_type="dataset",
                local_dir=datadir,
            )
        if spec.source_kind == "url":
            import urllib.request

            dest = os.path.join(datadir, os.path.basename(spec.source))
            urllib.request.urlretrieve(spec.source, dest)
            return dest
        raise ValueError(spec.source_kind)
    except Exception as e:
        raise RuntimeError(
            f"cannot fetch {spec.name} archive {idx}: {e}. The fetch needs network "
            "access; run download on a connected host."
        ) from e


def extract_and_filter(
    archive_path: str, out_dir: str, min_side: int = 256,
    downsize_to: int = 512, skip_existing: bool = False,
    keep_non_images: bool = False,
) -> int:
    """Extract an archive, drop small images, downsize large ones (shared with the
    reference's per-archive worker, jdb/download.py:109-172). With
    ``keep_non_images``, non-image members (caption jsonl/json/parquet metadata) are
    extracted verbatim alongside."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    kept = 0
    opener = tarfile.open if archive_path.endswith((".tar", ".tgz", ".tar.gz")) \
        else zipfile.ZipFile
    with opener(archive_path) as arc:
        names = arc.getnames() if hasattr(arc, "getnames") else arc.namelist()
        for name in names:
            if not name.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                if keep_non_images and os.path.basename(name):
                    fobj = (arc.extractfile(name) if hasattr(arc, "extractfile")
                            else arc.open(name))
                    if fobj is not None:
                        with open(os.path.join(out_dir, os.path.basename(name)),
                                  "wb") as dst:
                            dst.write(fobj.read())
                continue
            dest = os.path.join(out_dir, os.path.basename(name))
            if skip_existing and os.path.exists(dest):
                kept += 1
                continue
            fobj = (
                arc.extractfile(name) if hasattr(arc, "extractfile") else arc.open(name)
            )
            if fobj is None:
                continue
            try:
                img = to_rgb(Image.open(fobj))
            except Exception:
                continue
            if not image_passes_filter(*img.size, min_side):
                continue
            img = downsize_image(img, downsize_to)
            # Keep the original basename/extension: downstream caption pairing
            # (jdb convert) matches jsonl img_path against these names
            # (reference jdb/download.py:166-168 re-saves under the same name).
            try:
                img.save(dest)
            except (ValueError, OSError):
                img.save(os.path.splitext(dest)[0] + ".jpg", "JPEG", quality=95)
            kept += 1
    return kept


def download_dataset(
    dataset: str,
    datadir: str,
    valid_ids: Optional[List[int]] = None,
    data_fraction: float = 1.0,
    num_proc: int = 8,
    skip_existing: bool = False,
) -> None:
    spec = DATASETS[dataset]
    arch_dir = os.path.join(datadir, "archives")
    img_dir = os.path.join(datadir, "images")
    ids = select_archives(spec.num_archives or 1, valid_ids, data_fraction)
    archives = [fetch_archive(spec, i, arch_dir) for i in ids]
    with Pool(num_proc) as pool:
        counts = pool.starmap(
            extract_and_filter,
            [
                (a, img_dir, spec.min_side, spec.downsize_min_side_to, skip_existing)
                for a in archives
                if a
            ],
        )
    print(f"{dataset}: kept {sum(counts)} images from {len(archives)} archives")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    p.add_argument("--datadir", required=True)
    p.add_argument("--valid_ids", type=int, nargs="*", default=None)
    p.add_argument("--data_fraction", type=float, default=1.0)
    p.add_argument("--num_proc", type=int, default=8)
    p.add_argument("--skip_existing", action="store_true")
    args = p.parse_args(argv)
    download_dataset(
        args.dataset, args.datadir, args.valid_ids, args.data_fraction,
        args.num_proc, args.skip_existing,
    )


if __name__ == "__main__":
    main()
