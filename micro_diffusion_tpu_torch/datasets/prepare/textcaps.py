"""TextCaps prepare pipeline: HF datasets -> MDS (first reference caption).

Reference: micro_diffusion/datasets/prepare/textcaps/convert.py.
Facts reproduced here:
  * source is ``load_dataset("HuggingFaceM4/TextCaps", split="train+validation")``
    (convert.py:42-45);
  * per sample: image_height / image_width / image / image_id / reference_strs,
    the caption is ``reference_strs[0]`` (convert.py:56-88);
  * MDS columns height/width/jpg/image_id/caption (convert.py:64-70).

``write_samples`` is the testable core; the HF fetch is isolated in ``download``.

The port's own copy of micro_diffusion_tpu/datasets/prepare/textcaps.py, line for line, over the
port's ``mds``, ``captions``, ``common`` and ``specs``: the same MDS bytes.
"""

import argparse
from typing import Any, Dict, Iterable

from ..mds import MDSWriter

HF_DATASET = "HuggingFaceM4/TextCaps"
SPLIT = "train+validation"

MDS_COLUMNS = {"height": "int32", "width": "int32", "jpg": "jpeg",
               "image_id": "str", "caption": "str"}


def write_samples(samples: Iterable[Dict[str, Any]], local_mds_dir: str) -> int:
    """Write TextCaps-schema samples (image_height/image_width/image/image_id/
    reference_strs) to MDS, taking the FIRST reference caption (convert.py:80-88).
    Samples with no captions or a broken image are skipped."""
    n = 0
    with MDSWriter(out=local_mds_dir, columns=MDS_COLUMNS) as w:
        for s in samples:
            try:
                refs = s["reference_strs"]
                if not refs:
                    continue
                w.write({
                    "height": int(s["image_height"]),
                    "width": int(s["image_width"]),
                    "jpg": s["image"],
                    "image_id": str(s["image_id"]),
                    "caption": str(refs[0]),
                })
                n += 1
            except Exception:
                continue
    return n


def convert_to_mds(local_mds_dir: str, split: str = SPLIT) -> int:
    """Stream the HF dataset and write MDS. Requires network unless the dataset is
    already in the local HF cache."""
    from datasets import load_dataset

    ds = load_dataset(HF_DATASET, split=split)
    n = write_samples(iter(ds), local_mds_dir)
    print(f"textcaps: wrote {n} samples")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--local_mds_dir", required=True)
    p.add_argument("--split", default=SPLIT)
    args = p.parse_args(argv)
    convert_to_mds(args.local_mds_dir, args.split)


if __name__ == "__main__":
    main()
