"""Per-dataset prepare specs, the port's own copy of
micro_diffusion_tpu/datasets/prepare/specs.py (``DatasetSpec`` :25, ``DATASETS`` :39):
the deltas between the reference's six pipelines as data. The precompute CLI's
``--dataset`` reads ``caption_key`` and ``clean_captions`` from it.

Sources and behaviors (SURVEY.md #2.3, citations into the reference repository):
  jdb      - HF JourneyDB/JourneyDB tgz archives (200 train ids) + jsonl captions
             (jdb/download.py:60-172, jdb/convert.py:40-87)
  diffdb   - HF poloclub/diffusiondb, 14000 zip parts, parquet metadata, NSFW filter:
             drop if image/prompt score > 0.2 (diffdb/convert.py:67-72)
  cc12m    - HF pixparse/cc12m-wds webdataset tars (2176); two MDS variants
             (minside>=256 and >=512); DeepFloyd caption cleaning applied
             (cc12m/base.py; scripts/get_cc12m_dataset.sh:27-31)
  sa1b     - Meta tar links + synthetic LLaVA captions from
             PixArt-alpha/SAM-LLaVA-Captions10M, caption key
             caption_syn_pixart_llava15 (sa1b/download.py:145-160, sa1b/convert.py:62)
  textcaps - HF datasets HuggingFaceM4/TextCaps, first reference caption
             (textcaps/convert.py)
  coco     - COCO-2014 val zips + annotations, first caption per image (eval set)
             (coco/convert.py)
"""

from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    source_kind: str  # 'hf_hub' | 'hf_datasets' | 'url'
    source: str
    caption_key: str = "caption"
    caption_source: Optional[str] = None  # external caption dataset (sa1b)
    clean_captions: bool = False  # DeepFloyd caption cleaning (cc12m only)
    nsfw_max_score: Optional[float] = None  # drop above this (diffdb)
    min_side: int = 256
    downsize_min_side_to: int = 512
    num_archives: Optional[int] = None
    notes: str = ""


DATASETS = {
    "jdb": DatasetSpec(
        name="jdb",
        source_kind="hf_hub",
        source="JourneyDB/JourneyDB",
        num_archives=200,
        notes="tgz archives + jsonl captions; synthetic (Midjourney) images",
    ),
    "diffdb": DatasetSpec(
        name="diffdb",
        source_kind="hf_hub",
        source="poloclub/diffusiondb",
        num_archives=14000,
        nsfw_max_score=0.2,
        notes="zip parts + parquet metadata; prompt is the caption",
    ),
    "cc12m": DatasetSpec(
        name="cc12m",
        source_kind="hf_hub",
        source="pixparse/cc12m-wds",
        num_archives=2176,
        clean_captions=True,
        notes="webdataset tars; also build a minside>=512 variant for 512px stages",
    ),
    "sa1b": DatasetSpec(
        name="sa1b",
        source_kind="url",
        source="https://ai.meta.com/datasets/segment-anything-downloads/",
        caption_key="caption_syn_pixart_llava15",
        caption_source="PixArt-alpha/SAM-LLaVA-Captions10M",
        notes="tar links from the dynamic URL file + synthetic LLaVA captions",
    ),
    "textcaps": DatasetSpec(
        name="textcaps",
        source_kind="hf_datasets",
        source="HuggingFaceM4/TextCaps",
        notes="first reference caption per image",
    ),
    "coco": DatasetSpec(
        name="coco",
        source_kind="url",
        source="http://images.cocodataset.org/zips/val2014.zip",
        notes="COCO-2014 val: the online-eval set",
    ),
}
