"""The port's GenEval harness (micro_diffusion_tpu_torch/eval/geneval.py) against the
JAX package's: the official manifest and its vendored jsonl, the judging rules over
200 seeded synthetic cases (counts, colours by the hue heuristic, positions,
confidence), the score table and per-image records, the CLIP colour judge and the
``evaluate`` CLI. Everything here is exact: the same answers, not close ones."""

import json
import os

import numpy as np
import pytest

from micro_diffusion_tpu.eval import geneval as jg
from micro_diffusion_tpu_torch.eval import geneval as tg

from test_clip_zero_shot import tiny_clip, write_clip_tokenizer, write_snapshot

CASES = 200


def test_official_manifest_and_vendored_jsonl():
    assert tg.build_official_manifest(43) == jg.build_official_manifest(43)
    assert os.path.dirname(tg.OFFICIAL_MANIFEST).endswith(
        os.path.join("micro_diffusion_tpu_torch", "eval"))
    with open(tg.OFFICIAL_MANIFEST, "rb") as a, open(jg.OFFICIAL_MANIFEST, "rb") as b:
        assert a.read() == b.read()
    rows = tg.load_official_manifest()
    assert len(rows) == sum(tg.OFFICIAL_COUNTS.values()) == 553
    assert rows == jg.load_official_manifest()
    objs = ["car", "dog", "cat", "bus"]
    assert tg.build_prompt_manifest(objs, per_category=7, seed=3) == jg.build_prompt_manifest(
        objs, per_category=7, seed=3)


def synthetic_cases(seed=0, n=CASES, side=32):
    """Manifest rows drawn from the vendored manifest, detections around each row's
    classes (and other COCO classes) with random boxes, scores and colour fields,
    and random images."""
    rng = np.random.default_rng(seed)
    rows = tg.load_official_manifest()
    manifest, dets, images = [], [], []
    for _ in range(n):
        entry = rows[int(rng.integers(len(rows)))]
        classes = [r["class"] for r in entry["include"]] + list(
            rng.choice(tg.COCO_CLASSES, 2))
        case = []
        for _ in range(int(rng.integers(0, 6))):
            x0, y0 = rng.uniform(-4, side, 2)
            d = {"class": str(rng.choice(classes)),
                 "bbox": [float(x0), float(y0), float(x0 + rng.uniform(0, side)),
                          float(y0 + rng.uniform(0, side))],
                 "score": float(rng.uniform(0, 1))}
            if rng.uniform() < 0.3:
                d["color"] = str(rng.choice(tg.GENEVAL_COLORS))
            case.append(d)
        manifest.append(entry)
        dets.append(case)
        images.append(rng.integers(0, 256, (side, side, 3), np.uint8))
    return manifest, dets, images


def test_judging_matches_jax():
    manifest, dets, images = synthetic_cases()
    got = [tg.evaluate_detections(e, d, image=im) for e, d, im in zip(manifest, dets, images)]
    ref = [jg.evaluate_detections(e, d, image=im) for e, d, im in zip(manifest, dets, images)]
    assert got == ref and 0 < sum(got) < len(got)
    for d, im in zip(dets, images):
        for det in d:
            assert tg.hue_color_classifier(im, det["bbox"]) == jg.hue_color_classifier(
                im, det["bbox"])
    for rel in ("left of", "right of", "above", "below"):
        boxes = np.random.default_rng(5).uniform(0, 32, (50, 2, 4))
        assert ([tg.check_position(a, b, rel) for a, b in boxes]
                == [jg.check_position(a, b, rel) for a, b in boxes])
    with pytest.raises(ValueError, match="unknown relation"):
        tg.check_position([0, 0, 1, 1], [0, 0, 1, 1], "near")

    t_rows, j_rows = [], []
    t_scores = tg.score_generated_images(manifest, dets, images, conf_threshold=0.25,
                                         results_out=t_rows)
    j_scores = jg.score_generated_images(manifest, dets, images, conf_threshold=0.25,
                                         results_out=j_rows)
    assert t_scores == j_scores and t_rows == j_rows
    assert set(t_rows[0]) == {"filename", "tag", "prompt", "correct"}
    assert all(0.0 <= v <= 1.0 for v in t_scores.values())
    results = [{"tag": r["tag"], "correct": r["correct"]} for r in t_rows]
    assert tg.aggregate_scores(results) == jg.aggregate_scores(results)


@pytest.fixture(scope="module")
def clip_snapshot(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("geneval") / "clip")
    bos_id, eos_id = write_clip_tokenizer(snap)
    write_snapshot(*tiny_clip(bos_id, eos_id), snap)
    return snap


def test_clip_color_fn_matches_jax(clip_snapshot):
    manifest, dets, images = synthetic_cases(seed=1, n=12)
    t_fn = tg.make_clip_color_fn(clip_snapshot, device="cpu")
    j_fn = jg.make_clip_color_fn(clip_snapshot)
    boxes = [(im, d["bbox"], d["class"]) for d, im in zip(dets, images) for d in d]
    boxes.append((images[0], [40, 40, 50, 50], "car"))  # an empty crop
    assert [t_fn(*b) for b in boxes] == [j_fn(*b) for b in boxes]
    assert t_fn(*boxes[-1]) == "unknown"
    assert (tg.score_generated_images(manifest, dets, images, color_fn=t_fn)
            == jg.score_generated_images(manifest, dets, images, color_fn=j_fn))


def test_evaluate_cli_matches_jax(tmp_path, capsys, clip_snapshot):
    from PIL import Image

    manifest, dets, images = synthetic_cases(seed=2, n=6)
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    (tmp_path / "det.json").write_text(json.dumps(dets))
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(img_dir / f"{i:06d}.png")
    outs = {}
    for name, mod, extra in (("jax", jg, []), ("port", tg, ["--device", "cpu"])):
        for judge in ([], ["--clip_weights_dir", clip_snapshot]):
            mod.main(["evaluate", "--manifest", str(tmp_path / "manifest.json"),
                      "--detections", str(tmp_path / "det.json"), "--images_dir",
                      str(img_dir), "--results_jsonl", str(tmp_path / f"{name}.jsonl")]
                     + judge + extra)
            outs[name, bool(judge)] = (json.loads(capsys.readouterr().out),
                                       (tmp_path / f"{name}.jsonl").read_text())
    assert outs["port", False] == outs["jax", False]
    assert outs["port", True] == outs["jax", True]
    assert outs["port", True][0]["color_judge"] == "clip_zero_shot"
    (tmp_path / "short.json").write_text(json.dumps(dets[:2]))
    with pytest.raises(ValueError, match="6 manifest rows but 2"):
        tg.main(["evaluate", "--manifest", str(tmp_path / "manifest.json"),
                 "--detections", str(tmp_path / "short.json")])
