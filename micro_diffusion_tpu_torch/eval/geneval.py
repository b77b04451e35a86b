"""GenEval harness: prompt manifests, detection judging and score aggregation, the
port's own copy of micro_diffusion_tpu/eval/geneval.py.

GenEval (Ghosh et al. 2023) scores compositional generation: single object, two
objects, counting, colors, position, attribute binding. The reference reports GenEval
0.46/0.52 for its released checkpoints (README.md:56-61).

This harness provides:
  * the standard 6-category prompt schema + metadata manifest
    (build_prompt_manifest) and the vendored official 553-prompt manifest
    (geneval_prompts.jsonl beside this file, byte-identical to the JAX package's)
  * generation driving (eval/generate_eval_images.generate_images)
  * detection judging (evaluate_detections) with the CLIP zero-shot colour judge
    (make_clip_color_fn, on ``device``: the card unless the caller asks for the CPU)
    or the hue heuristic, and score aggregation (aggregate_scores)

The object-detection stage itself (Mask2Former via mmdet in upstream geneval) needs
its own weights + deps and runs offline on the generated images; its JSON output
format is what evaluate_detections consumes.
"""

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

CATEGORIES = (
    "single_object",
    "two_object",
    "counting",
    "colors",
    "position",
    "color_attr",
)

# The COCO-80 object vocabulary the official GenEval benchmark prompts over.
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)

# Official GenEval color vocabulary (the 10 colors its color/color_attr tasks
# draw from and its CLIP zero-shot color judge classifies over).
GENEVAL_COLORS = ("red", "orange", "yellow", "green", "blue", "purple", "pink",
                  "brown", "black", "white")

# Official benchmark size per task category (553 prompts total).
OFFICIAL_COUNTS = {
    "single_object": 80,
    "two_object": 99,
    "counting": 80,
    "colors": 94,
    "position": 100,
    "color_attr": 100,
}

OFFICIAL_MANIFEST = os.path.join(os.path.dirname(__file__),
                                 "geneval_prompts.jsonl")


def load_official_manifest(path: Optional[str] = None) -> List[Dict]:
    """The vendored 553-prompt manifest (geneval_prompts.jsonl)."""
    with open(path or OFFICIAL_MANIFEST) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_official_manifest(seed: int = 43) -> List[Dict]:
    """Official-structure GenEval manifest: 553 prompts over the COCO-80
    vocabulary with the benchmark's templates and per-category sizes
    (single_object 80, two_object 99, counting 80, colors 94, position 100,
    color_attr 100).

    The generation procedure mirrors upstream GenEval's create_prompts flow
    (seeded sampling + dedup per category); prompt-level identity with the
    upstream-committed jsonl cannot be verified in this zero-egress environment,
    so the frozen output is vendored (geneval_prompts.jsonl) and any scores
    should cite it. Task structure, vocabulary, templates, and scoring rules
    match the official benchmark.
    """
    import random

    rng = random.Random(seed)
    art = lambda w: ("an " if w[0] in "aeiou" else "a ") + w
    num_word = {2: "two", 3: "three", 4: "four"}
    manifest: List[Dict] = []

    def fill(tag, target, gen):
        seen = set()
        while len(seen) < target:
            prompt, include = gen()
            if prompt in seen:
                continue
            seen.add(prompt)
            manifest.append({"tag": tag, "prompt": prompt, "include": include})

    objs = list(COCO_CLASSES)
    for o in objs:  # single_object: one per class, in vocabulary order
        manifest.append({
            "tag": "single_object", "prompt": f"a photo of {art(o)}",
            "include": [{"class": o, "count": 1}],
        })

    def two_object():
        o1, o2 = rng.sample(objs, 2)
        return (f"a photo of {art(o1)} and {art(o2)}",
                [{"class": o1, "count": 1}, {"class": o2, "count": 1}])

    def counting():
        o = rng.choice(objs)
        n = rng.choice((2, 3, 4))
        plural = o if o.endswith("s") else o + "s"
        return (f"a photo of {num_word[n]} {plural}",
                [{"class": o, "count": n}])

    def colors():
        o = rng.choice(objs)
        c = rng.choice(GENEVAL_COLORS)
        return (f"a photo of {art(c + ' ' + o)}",
                [{"class": o, "count": 1, "color": c}])

    def position():
        o1, o2 = rng.sample(objs, 2)
        pos = rng.choice(("left of", "right of", "above", "below"))
        return (f"a photo of {art(o1)} {pos} {art(o2)}",
                [{"class": o1, "count": 1, "position": [pos, o2]},
                 {"class": o2, "count": 1}])

    def color_attr():
        o1, o2 = rng.sample(objs, 2)
        c1, c2 = rng.sample(GENEVAL_COLORS, 2)
        return (f"a photo of {art(c1 + ' ' + o1)} and {art(c2 + ' ' + o2)}",
                [{"class": o1, "count": 1, "color": c1},
                 {"class": o2, "count": 1, "color": c2}])

    fill("two_object", OFFICIAL_COUNTS["two_object"], two_object)
    fill("counting", OFFICIAL_COUNTS["counting"], counting)
    fill("colors", OFFICIAL_COUNTS["colors"], colors)
    fill("position", OFFICIAL_COUNTS["position"], position)
    fill("color_attr", OFFICIAL_COUNTS["color_attr"], color_attr)
    return manifest


def build_prompt_manifest(
    objects: Sequence[str],
    colors: Sequence[str] = ("red", "orange", "yellow", "green", "blue",
                             "purple", "pink", "brown", "black", "white"),
    counts: Sequence[int] = (2, 3, 4),
    positions: Sequence[str] = ("left of", "right of", "above", "below"),
    per_category: int = 100,
    seed: int = 0,
) -> List[Dict]:
    """Generate a GenEval-style prompt manifest: list of {prompt, tag, include}."""
    import random

    rng = random.Random(seed)
    art = lambda w: ("an " if w[0] in "aeiou" else "a ") + w
    manifest: List[Dict] = []

    def add(tag, prompt, include):
        manifest.append({"tag": tag, "prompt": prompt, "include": include})

    for _ in range(per_category):
        o = rng.choice(objects)
        add("single_object", f"a photo of {art(o)}", [{"class": o, "count": 1}])

        o1, o2 = rng.sample(list(objects), 2)
        add(
            "two_object", f"a photo of {art(o1)} and {art(o2)}",
            [{"class": o1, "count": 1}, {"class": o2, "count": 1}],
        )

        o = rng.choice(objects)
        n = rng.choice(list(counts))
        plural = o + "s" if not o.endswith("s") else o
        num_word = {2: "two", 3: "three", 4: "four"}[n]
        add("counting", f"a photo of {num_word} {plural}", [{"class": o, "count": n}])

        o = rng.choice(objects)
        c = rng.choice(list(colors))
        add("colors", f"a photo of {art(c + ' ' + o)}",
            [{"class": o, "count": 1, "color": c}])

        o1, o2 = rng.sample(list(objects), 2)
        pos = rng.choice(list(positions))
        add(
            "position", f"a photo of {art(o1)} {pos} {art(o2)}",
            [{"class": o1, "count": 1, "position": (pos, o2)},
             {"class": o2, "count": 1}],
        )

        o1, o2 = rng.sample(list(objects), 2)
        c1, c2 = rng.sample(list(colors), 2)
        add(
            "color_attr",
            f"a photo of {art(c1 + ' ' + o1)} and {art(c2 + ' ' + o2)}",
            [{"class": o1, "count": 1, "color": c1},
             {"class": o2, "count": 1, "color": c2}],
        )
    return manifest


def bbox_center(bbox: Sequence[float]) -> tuple:
    x0, y0, x1, y1 = bbox
    return ((x0 + x1) / 2.0, (y0 + y1) / 2.0)


def check_position(bbox_a, bbox_b, relation: str) -> bool:
    """Relative-position rule (upstream geneval evaluation semantics): the center
    displacement along the specified axis must point the right way AND dominate the
    orthogonal component ('left of' = a clearly left of b, not merely diagonal)."""
    (ax, ay), (bx, by) = bbox_center(bbox_a), bbox_center(bbox_b)
    dx, dy = ax - bx, ay - by
    if relation == "left of":
        return dx < 0 and abs(dx) > abs(dy)
    if relation == "right of":
        return dx > 0 and abs(dx) > abs(dy)
    if relation == "above":  # image y grows downward
        return dy < 0 and abs(dy) > abs(dx)
    if relation == "below":
        return dy > 0 and abs(dy) > abs(dx)
    raise ValueError(f"unknown relation {relation}")


def make_clip_color_fn(snapshot_dir: str, tokenizer_dir: Optional[str] = None,
                       colors: Sequence[str] = GENEVAL_COLORS, device=None):
    """The OFFICIAL GenEval color judge: CLIP zero-shot over the detection crop
    with prompts "a photo of a <color> <class>" (upstream geneval
    evaluation/evaluate_images.py). ``snapshot_dir``: local HF CLIPModel
    snapshot, run on ``device`` (the card when None); numerics held against the
    JAX module in tests/test_torch_clip_zero_shot.py."""
    import numpy as np

    from ..models.clip_zero_shot import CLIPZeroShot

    zs = CLIPZeroShot(snapshot_dir, tokenizer_dir=tokenizer_dir, device=device)

    def color_fn(image_rgb, bbox, cls=None) -> str:
        img = np.asarray(image_rgb, np.uint8)
        x0, y0, x1, y1 = (int(round(v)) for v in bbox)
        crop = img[max(0, y0):max(0, y1), max(0, x0):max(0, x1)]
        if crop.size == 0:
            return "unknown"
        noun = cls or "object"
        art = "an" if noun[0] in "aeiou" else "a"
        texts = [f"a photo of {art} {c} {noun}" for c in colors]
        return colors[zs.classify([crop], texts)[0]]

    return color_fn


def hue_color_classifier(image_rgb, bbox, cls=None) -> str:
    """Offline color classifier: dominant-hue vote over the detection crop (the
    upstream pipeline uses CLIP zero-shot on the crop - make_clip_color_fn; this
    is the dependency-free fallback when no CLIP weights are on disk)."""
    import numpy as np

    img = np.asarray(image_rgb, np.float32)
    x0, y0, x1, y1 = (int(round(v)) for v in bbox)
    crop = img[max(0, y0):max(0, y1), max(0, x0):max(0, x1)] / 255.0
    if crop.size == 0:
        return "unknown"
    r, g, b = crop[..., 0], crop[..., 1], crop[..., 2]
    mx, mn = crop.max(-1), crop.min(-1)
    v, delta = mx, mx - mn
    s = np.where(mx > 0, delta / np.maximum(mx, 1e-6), 0.0)
    h = np.zeros_like(mx)
    m = delta > 1e-6
    rm = m & (mx == r)
    gm = m & (mx == g) & ~rm
    bm = m & ~rm & ~gm
    h[rm] = (60 * ((g - b) / np.maximum(delta, 1e-6)) % 360)[rm]
    h[gm] = (60 * ((b - r) / np.maximum(delta, 1e-6)) + 120)[gm]
    h[bm] = (60 * ((r - g) / np.maximum(delta, 1e-6)) + 240)[bm]

    names = []
    flat = zip(h.reshape(-1), s.reshape(-1), v.reshape(-1))
    for hh, ss, vv in flat:
        if vv < 0.15:
            names.append("black")
        elif ss < 0.18:
            names.append("white" if vv > 0.75 else "black")
        elif hh < 15 or hh >= 345:
            names.append("red")
        elif hh < 40:
            names.append("brown" if vv < 0.6 else "orange")
        elif hh < 70:
            names.append("yellow")
        elif hh < 165:
            names.append("green")
        elif hh < 260:
            names.append("blue")
        elif hh < 300:
            names.append("purple")
        else:
            names.append("pink")
    from collections import Counter

    return Counter(names).most_common(1)[0][0]


def evaluate_detections(
    entry: Dict,
    detections: Sequence[Dict],
    image=None,
    color_fn=hue_color_classifier,
    conf_threshold: float = 0.3,
) -> bool:
    """Judge one generated image against its manifest ``include`` spec.

    ``detections``: [{'class': str, 'bbox': [x0,y0,x1,y1], 'score': float,
    'color': optional str}] - the output of any object detector (upstream geneval
    runs mmdet Mask2Former; its JSON converts directly to this shape).

    Rules (upstream geneval evaluation):
      * detections below conf_threshold are ignored;
      * 'count' is exact for the counting category, a minimum otherwise;
      * 'color' must match (from the detection record, else color_fn on the crop);
      * 'position' (rel, other_class) must hold vs some detection of other_class.
    """
    dets = [d for d in detections if d.get("score", 1.0) >= conf_threshold]
    by_class: Dict[str, List[Dict]] = defaultdict(list)
    for d in dets:
        by_class[d["class"]].append(d)

    exact = entry.get("tag") == "counting"
    for req in entry["include"]:
        matches = by_class.get(req["class"], [])
        want = int(req.get("count", 1))
        if exact:
            if len(matches) != want:
                return False
        elif len(matches) < want:
            return False

        if "color" in req:
            def det_color(d):
                if "color" in d:
                    return d["color"]
                if image is None or color_fn is None:
                    return None
                return color_fn(image, d["bbox"], req["class"])

            if not any(det_color(d) == req["color"] for d in matches):
                return False

        if "position" in req:
            rel, other = req["position"]
            others = by_class.get(other, [])
            ok = any(
                check_position(a["bbox"], b["bbox"], rel)
                for a in matches
                for b in others
            )
            if not ok:
                return False
    return True


def score_generated_images(
    manifest: Sequence[Dict],
    detections_per_image: Sequence[Sequence[Dict]],
    images: Optional[Sequence] = None,
    color_fn=hue_color_classifier,
    conf_threshold: float = 0.3,
    results_out: Optional[List[Dict]] = None,
) -> Dict[str, float]:
    """Full detection->score bridge: judge every (manifest entry, detections) pair
    and aggregate to the GenEval table. ``detections_per_image[i]`` belongs to
    ``manifest[i]``'s generated image.

    ``results_out``: optional list appended with one per-image record in the
    upstream geneval results.jsonl schema ({filename, tag, prompt, correct}) -
    field-for-field comparable with the official evaluate_images.py output."""
    results = []
    for i, entry in enumerate(manifest):
        correct = evaluate_detections(
            entry,
            detections_per_image[i],
            image=images[i] if images is not None else None,
            color_fn=color_fn,
            conf_threshold=conf_threshold,
        )
        results.append({"tag": entry["tag"], "correct": correct})
        if results_out is not None:
            results_out.append({
                "filename": f"{i:06d}.png",
                "tag": entry["tag"],
                "prompt": entry.get("prompt", ""),
                "correct": bool(correct),
            })
    return aggregate_scores(results)


def aggregate_scores(results: Sequence[Dict]) -> Dict[str, float]:
    """Aggregate per-image detection results into the GenEval score table.

    Each result: {'tag': <category>, 'correct': bool}. Returns per-category accuracy
    and the overall mean (the headline GenEval number)."""
    by_tag = defaultdict(list)
    for r in results:
        by_tag[r["tag"]].append(bool(r["correct"]))
    scores = {
        tag: (sum(v) / len(v) if v else 0.0) for tag, v in sorted(by_tag.items())
    }
    scores["overall"] = sum(scores.values()) / max(len(scores), 1)
    return scores


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    gp = sub.add_parser("prompts", help="write a prompt manifest json")
    gp.add_argument("--objects_file", default=None,
                    help="json list of object class names (default: COCO-80)")
    gp.add_argument("--out", required=True)
    gp.add_argument("--per_category", type=int, default=100)
    fz = sub.add_parser(
        "freeze", help="regenerate the vendored official 553-prompt manifest"
    )
    fz.add_argument("--out", default=OFFICIAL_MANIFEST)
    ap = sub.add_parser("score", help="aggregate {tag, correct} results")
    ap.add_argument("--results", required=True)
    dp = sub.add_parser(
        "evaluate", help="judge raw detections against a prompt manifest"
    )
    dp.add_argument("--manifest", default=OFFICIAL_MANIFEST,
                    help="prompt manifest (.jsonl or .json; default: the "
                         "vendored official 553-prompt manifest)")
    dp.add_argument("--detections", required=True,
                    help="json: list (one per manifest entry) of detection lists "
                         "[{class,bbox,score[,color]}] from any detector "
                         "(upstream geneval uses mmdet Mask2Former)")
    dp.add_argument("--images_dir", default=None,
                    help="generated-image dir ({idx:06d}.png per manifest row); "
                         "enables crop color classification")
    dp.add_argument("--clip_weights_dir", default=None,
                    help="local HF CLIPModel snapshot: official CLIP zero-shot "
                         "color judge (default: hue heuristic fallback)")
    dp.add_argument("--clip_tokenizer_dir", default=None)
    dp.add_argument("--device", default="cuda",
                    help="device of the CLIP judge: cuda (default; raises without a "
                         "card) or cpu")
    dp.add_argument("--conf_threshold", type=float, default=0.3)
    dp.add_argument("--results_jsonl", default=None,
                    help="also write per-image records in the upstream "
                         "geneval results.jsonl schema "
                         "({filename, tag, prompt, correct})")
    args = p.parse_args(argv)

    if args.cmd == "prompts":
        if args.objects_file:
            objects = json.load(open(args.objects_file))
        else:
            objects = list(COCO_CLASSES)
        manifest = build_prompt_manifest(objects, per_category=args.per_category)
        json.dump(manifest, open(args.out, "w"))
        print(f"wrote {len(manifest)} prompts -> {args.out}")
    elif args.cmd == "freeze":
        manifest = build_official_manifest()
        with open(args.out, "w") as f:
            for row in manifest:
                f.write(json.dumps(row) + "\n")
        print(f"wrote {len(manifest)} official prompts -> {args.out}")
    elif args.cmd == "evaluate":
        if args.manifest.endswith(".jsonl"):
            manifest = load_official_manifest(args.manifest)
        else:
            manifest = json.load(open(args.manifest))
        detections = json.load(open(args.detections))
        if len(manifest) != len(detections):
            raise ValueError(f"{len(manifest)} manifest rows but {len(detections)} "
                             "detection lists")
        images = None
        if args.images_dir:
            import numpy as np
            from PIL import Image

            images = [
                np.asarray(
                    Image.open(
                        os.path.join(args.images_dir, f"{i:06d}.png")
                    ).convert("RGB")
                )
                for i in range(len(manifest))
            ]
        color_fn = (
            make_clip_color_fn(args.clip_weights_dir, args.clip_tokenizer_dir,
                               device=args.device)
            if args.clip_weights_dir
            else hue_color_classifier
        )
        per_image: List[Dict] = []
        scores = score_generated_images(
            manifest, detections, images=images, color_fn=color_fn,
            conf_threshold=args.conf_threshold, results_out=per_image,
        )
        scores["color_judge"] = ("clip_zero_shot" if args.clip_weights_dir
                                 else "hue_heuristic")
        if args.results_jsonl:
            with open(args.results_jsonl, "w") as f:
                for row in per_image:
                    f.write(json.dumps(row) + "\n")
        print(json.dumps(scores, indent=2))
    else:
        results = json.load(open(args.results))
        print(json.dumps(aggregate_scores(results), indent=2))


if __name__ == "__main__":
    main()
