"""Shared helpers of the prepare pipelines, the port's own copy of
micro_diffusion_tpu/datasets/prepare/common.py (``to_rgb`` :18, ``resize_center_crop``
:24, ``downsize_image`` :42, ``image_passes_filter`` :54, ``parallel_mds_write`` :58,
``PrecomputeImageDataset`` :86). The same PIL operations (bicubic shorter-side resize,
``round()`` sizes, floor-centred crop), so the arrays equal the JAX package's bit for
bit. The image MDS is read through the port's ``MDSReader``, which decodes ``jpeg``
columns into PIL images.

The reference implements six ~95%-identical per-dataset pipelines
(micro_diffusion/datasets/prepare/{jdb,diffdb,cc12m,sa1b,textcaps,coco}, SURVEY.md #2.3);
the shared machinery lives once and per-dataset deltas are data (specs.py).
"""

import io
import os
from multiprocessing import Pool
from typing import Callable, Dict, Iterator, Sequence

import numpy as np

from ..mds import MDSReader, merge_index


def to_rgb(img):
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def resize_center_crop(img, size: int) -> np.ndarray:
    """Bicubic shorter-side resize + center crop + normalize to [-1, 1], CHW float32
    (reference base.py transforms: Resize/CenterCrop/ToTensor/Normalize(0.5, 0.5))."""
    from PIL import Image

    img = to_rgb(img)
    w, h = img.size
    scale = size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr.transpose(2, 0, 1)


def downsize_image(img, max_min_side: int = 512):
    """Downsize so the SHORTER side is <= max_min_side (download-time disk saver,
    reference jdb/download.py:141-172)."""
    from PIL import Image

    w, h = img.size
    if min(w, h) <= max_min_side:
        return img
    scale = max_min_side / min(w, h)
    return img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)


def image_passes_filter(width: int, height: int, min_side: int = 256) -> bool:
    return min(width, height) >= min_side


def parallel_mds_write(
    worker: Callable[[list, str], int],
    work_items: list,
    out_dir: str,
    num_proc: int = 1,
) -> int:
    """Split ``work_items`` across ``num_proc`` processes, each writing its own MDS
    subdirectory ``out_dir/<i>``, then merge the per-process indexes into one root
    index.json - the reference's per-process MDSWriter + merge_index pattern
    (diffdb/convert.py, cc12m/convert.py, sa1b/convert.py).

    ``worker(items, subdir) -> n_written`` must be picklable (module-level).
    Returns the total number of samples written.
    """
    os.makedirs(out_dir, exist_ok=True)
    k = max(1, num_proc)
    bounds = np.linspace(0, len(work_items), k + 1).astype(int)
    chunks = [list(work_items[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]
    subdirs = [os.path.join(out_dir, str(i)) for i in range(len(chunks))]
    if num_proc <= 1:
        counts = [worker(c, d) for c, d in zip(chunks, subdirs)]
    else:
        with Pool(num_proc) as pool:
            counts = pool.starmap(worker, list(zip(chunks, subdirs)))
    merge_index(out_dir)
    return int(sum(counts))


class PrecomputeImageDataset:
    """Reads image MDS shards (width/height/jpg/caption columns) and yields, per sample,
    resized image arrays at each requested resolution + the raw caption (reference
    base.py StreamingXDatasetForPreCompute)."""

    def __init__(
        self,
        datadirs: Sequence[str],
        resize_sizes: Sequence[int] = (256, 512),
        caption_key: str = "caption",
        caption_processor=None,
    ):
        self.readers = [MDSReader(d) for d in datadirs]
        self._cum = np.cumsum([0] + [len(r) for r in self.readers])
        self.resize_sizes = list(resize_sizes)
        self.caption_key = caption_key
        self.caption_processor = caption_processor

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, index: int) -> Dict:
        stream = int(np.searchsorted(self._cum, index, side="right")) - 1
        sample = self.readers[stream][index - int(self._cum[stream])]
        from PIL import Image

        img = sample["jpg"]
        if isinstance(img, (bytes, bytearray)):
            img = Image.open(io.BytesIO(img))
        caption = sample.get(self.caption_key, "")
        if self.caption_processor is not None:
            caption = self.caption_processor(caption)
        out = {"caption": caption, "sample": sample}
        for size in self.resize_sizes:
            out[f"image_{size}"] = resize_center_crop(img, size)
        return out

    def iter_slice(self, process_index: int, process_count: int) -> Iterator[Dict]:
        """Disjoint contiguous per-process slice (the multi-host partitioning used at
        precompute, reference precompute.py accelerate sharding equivalent)."""
        n = len(self)
        per = -(-n // process_count)
        lo = process_index * per
        hi = min(n, lo + per)
        for i in range(lo, hi):
            yield self[i]
