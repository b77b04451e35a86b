"""The port's download and convert pipelines (datasets/prepare/download.py,
convert.py and the six datasets' modules) against the JAX package's, on the
synthetic raw files of tests/test_prepare_datasets.py: the port's converter, run
through its command line, writes MDS shards and an index.json byte-identical to
the JAX converter's on the same files; the port's download step extracts the same
image files."""

import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from micro_diffusion_tpu.datasets.prepare import cc12m as jcc12m
from micro_diffusion_tpu.datasets.prepare import coco as jcoco
from micro_diffusion_tpu.datasets.prepare import convert as jconvert
from micro_diffusion_tpu.datasets.prepare import diffdb as jdiffdb
from micro_diffusion_tpu.datasets.prepare import download as jdownload
from micro_diffusion_tpu.datasets.prepare import jdb as jjdb
from micro_diffusion_tpu.datasets.prepare import sa1b as jsa1b
from micro_diffusion_tpu.datasets.prepare import textcaps as jtextcaps
from micro_diffusion_tpu_torch.datasets.mds import MDSReader
from micro_diffusion_tpu_torch.datasets.prepare import cc12m, coco, convert, diffdb, download
from micro_diffusion_tpu_torch.datasets.prepare import jdb, sa1b, textcaps

from test_prepare_datasets import _img, _make_wds_tar


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _jdb(tmp):
    for arch, seed in (("000", 1), ("001", 2)):
        os.makedirs(tmp / "imgs" / arch)
        _img(seed=seed).save(tmp / "imgs" / arch / f"{arch}.jpg")
    with open(tmp / "anno.jsonl", "w") as f:
        for row in ({"img_path": "./000/000.jpg", "prompt": "caption a"},
                    {"img_path": "./001/001.jpg", "prompt": "caption b"},
                    {"img_path": "./002/c.jpg", "prompt": "not downloaded"},
                    {"img_path": "./000/000.jpg"}):
            f.write(json.dumps(row) + "\n")
    src = (str(tmp / "imgs"), str(tmp / "anno.jsonl"))
    return (lambda out: jjdb.convert_to_mds(*src, out),
            lambda out: jdb.main(["convert", "--images_dir", src[0], "--captions_jsonl", src[1],
                                  "--local_mds_dir", out]))


def _diffdb(tmp):
    import pandas as pd

    part = tmp / "raw" / "images" / "part-000001"
    os.makedirs(part)
    for name, seed in (("ok.webp", 1), ("nsfw.webp", 2), ("ok2.webp", 3)):
        _img(seed=seed).save(part / name, "WEBP")
    pd.DataFrame({"part_id": [1, 1, 1, 1],
                  "image_name": ["ok.webp", "nsfw.webp", "ok2.webp", "missing.webp"],
                  "prompt": ["fine", "bad", "fine too", "no file"],
                  "image_nsfw": [0.1, 0.5, 0.0, 0.05],
                  "prompt_nsfw": [0.2, 0.0, 0.1, 0.1]}).to_parquet(
        tmp / "raw" / "metadata-large.parquet")
    raw = str(tmp / "raw")
    return (lambda out: jdiffdb.convert_to_mds(raw, out, num_proc=1),
            lambda out: diffdb.main(["convert", "--images_dir", raw, "--local_mds_dir", out,
                                     "--num_proc", "1"]))


def _cc12m(tmp):
    os.makedirs(tmp / "wds")
    _make_wds_tar(tmp / "wds" / "cc12m-train-0000.tar",
                  [("s0", _img(300, 280, 1), "caption zero"), ("s1", _img(120, 100, 2), "small"),
                   ("s2", _img(800, 700, 3), "downsize me")],
                  extra=[("orphan.txt", b"no image")])
    _make_wds_tar(tmp / "wds" / "cc12m-train-0001.tar", [("s3", _img(600, 520, 4), "more")])
    wds = str(tmp / "wds")
    return (lambda out: jcc12m.convert_to_mds(wds, out, min_side=512),
            lambda out: cc12m.main(["convert", "--wds_dir", wds, "--local_mds_dir", out,
                                    "--min_image_size", "512", "--num_proc", "1"]))


def _sa1b(tmp):
    os.makedirs(tmp / "raw" / "sa_000000")
    os.makedirs(tmp / "captions")
    for i in range(3):
        _img(seed=i).save(tmp / "raw" / "sa_000000" / f"sa_{i}.jpg")
    (tmp / "captions" / "sa_0.txt").write_text("a llava caption\n")
    (tmp / "captions" / "sa_2.txt").write_text("another\n")
    raw, caps = str(tmp / "raw"), str(tmp / "captions")
    return (lambda out: jsa1b.convert_to_mds(raw, caps, out, num_proc=1),
            lambda out: sa1b.main(["convert", "--images_dir", raw, "--captions_dir", caps,
                                   "--local_mds_dir", out, "--num_proc", "1"]))


def _textcaps(tmp):
    def samples():
        return [{"image_height": 280, "image_width": 300, "image": _img(seed=1),
                 "image_id": "id0", "reference_strs": ["first cap", "second cap"]},
                {"image_height": 280, "image_width": 300, "image": _img(seed=2),
                 "image_id": "id1", "reference_strs": []},
                {"image_height": 200, "image_width": 310, "image": _img(310, 200, 3),
                 "image_id": "id2", "reference_strs": ["third"]}]
    return (lambda out: jtextcaps.write_samples(samples(), out),
            lambda out: textcaps.write_samples(samples(), out))


def _coco(tmp):
    anns = [{"image_id": 42, "caption": "first\ncaption"}, {"image_id": 42, "caption": "second"},
            {"image_id": 7, "caption": "lonely"}, {"image_id": 99, "caption": "missing"}]
    os.makedirs(tmp / "annotations")
    with open(tmp / "annotations" / "captions_val2014.json", "w") as f:
        json.dump({"annotations": anns}, f)
    os.makedirs(tmp / "val2014")
    _img(seed=1).save(tmp / "val2014" / jcoco.image_file_name(42))
    _img(seed=2).save(tmp / "val2014" / jcoco.image_file_name(7))
    return (lambda out: jcoco.convert_to_mds(str(tmp), out),
            lambda out: coco.main(["convert", "--datadir", str(tmp), "--local_mds_dir", out]))


def _convert(tmp):
    os.makedirs(tmp / "imgs" / "sub")
    _img(seed=1).save(tmp / "imgs" / "a.jpg")
    _img(600, 560, 2).save(tmp / "imgs" / "sub" / "b.png")
    _img(100, 90, 3).save(tmp / "imgs" / "c.jpg")  # under the minimum side
    with open(tmp / "caps.json", "w") as f:
        json.dump({"a": "<b>Visit</b> http://x.org now", "b": "caption b", "c": "small"}, f)
    src = (str(tmp / "imgs"), str(tmp / "caps.json"))
    return (lambda out: jconvert.convert_to_mds("cc12m", *src, out),
            lambda out: convert.main(["--dataset", "cc12m", "--images_dir", src[0],
                                      "--captions_file", src[1], "--local_mds_dir", out]))


def _download(tmp):
    arc = tmp / "part.tar"
    with tarfile.open(arc, "w") as t:
        for name, img in (("big.jpg", _img(900, 700, 1)), ("ok.png", _img(300, 280, 2)),
                          ("small.jpg", _img(100, 90, 3))):
            path = tmp / name
            img.save(path)
            t.add(path, arcname=f"dir/{name}")
        (tmp / "meta.jsonl").write_text('{"k": 1}\n')
        t.add(tmp / "meta.jsonl", arcname="dir/meta.jsonl")
    return (lambda out: jdownload.extract_and_filter(str(arc), out, keep_non_images=True),
            lambda out: download.extract_and_filter(str(arc), out, keep_non_images=True))


FIXTURES = {"jdb": _jdb, "diffdb": _diffdb, "cc12m": _cc12m, "sa1b": _sa1b,
            "textcaps": _textcaps, "coco": _coco, "convert": _convert, "download": _download}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_converter_writes_the_jax_bytes(name, tmp_path):
    """The same raw files through the JAX converter and through the port's (its
    command line where it has one): every file of the two outputs byte for byte."""
    jax_run, port_run = FIXTURES[name](tmp_path)
    jax_run(str(tmp_path / "jax"))
    port_run(str(tmp_path / "port"))
    want, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert want and sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    if name != "download":
        assert len(MDSReader(str(tmp_path / "port"))) > 0


def test_the_converters_filter_and_clean():
    """The rules the byte comparison rides on, in the port's own modules: the cc12m
    caption cleaning of the generic converter, the dataset specs, the archive names."""
    assert jdb.archive_path("train", 7) == "data/train/imgs/007.tgz"
    assert diffdb.archive_filename(37) == "part-000037.zip"
    assert cc12m.archive_filename(3) == "cc12m-train-0003.tar"
    assert coco.group_captions([{"image_id": 1, "caption": "a\nb"}]) == {1: ["ab"]}
    assert sa1b.parse_links_file("file_name\tcdn_link\nsa_0.tar\thttps://x/0\n") == [
        ("sa_0.tar", "https://x/0")]
    assert np.array_equal(np.asarray(download.downsize_image(_img(900, 700, 1), 512)).shape,
                          (512, 658, 3))
    assert isinstance(_img(), Image.Image)
