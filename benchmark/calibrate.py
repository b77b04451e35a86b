"""The readings that a cell's limits are set from, in one process on the chip:

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <n> ...]

For each of ``--seeds``, one run of the cell's timed path at its own size (the
shortest window: one step or one call) and its check, as ``run.py`` makes it; for
each of ``--control-seeds``, the control: the plain reference in the program's place
with its products on fp8 operands, read against the float32 reference, and the
planted faults: in training cells a step over half its batch, in sampling cells a
wrong Heun weight and a start from another row's noise. A step that returns its
state unchanged reads 1 on ``grad``, ``update`` and ``ema`` by the checks' measure,
without a run. One JSON line per reading, then the lower reading (the
largest over the program's seeds) and the upper (the smallest over the control and
the faults) of each number. The benchmark's runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

import torch  # noqa: E402

from benchmark import checks, harness, inputs  # noqa: E402


def _cell(name, seed, tmp, device):
    wl = harness.workload(name)
    return harness.Cell(name=name, workload=wl, config=harness.config(wl["config"]),
                        traffic=harness.traffic(wl["traffic"]), seed=seed, seconds=0.0,
                        trace=False, device=device, tmpdir=tmp, t0=time.perf_counter(),
                        per_layer=[])


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control_train(cell):
    """{'control': numbers, 'half_batch': numbers} of one seed."""
    from benchmark.reference import follow

    cfg, p = cell.config, cell.params
    m, tr = cfg["model"], cfg["train"]
    caps, lats = inputs.latents(cell.seed, p["samples"], m["latent_res"], m["caption_len"],
                                m["caption_channels"], cell.device)
    wseed = inputs.sub_seed(cell.seed, 2)
    args = (m, tr, caps, lats, cell.seed, wseed, p["followed_steps"], p["ref_rows"],
            cell.device)
    out = {}
    ref = follow.follow(*args)
    ref.pop("w0")
    _free()
    for label, kw in (("control", dict(precision="fp8")), ("half_batch", dict(half_batch=True))):
        got = follow.follow(*args, **kw)
        got.pop("w0")
        out[label] = checks.training_numbers(got, ref)
        _free()
    return out


CONTROL_ROWS = 2  # images of a run's first call that a control seed samples
WRONG_WEIGHT = 0.55  # the Heun fault's share of the second slope (Heun's is 0.5)


def control_sample(cell):
    """{'control': numbers, 'heun_weight': numbers, 'start_row': numbers} of one seed.
    The control: the reference with its DiT's and VAE's products on fp8 operands in
    the program's place (its sampler recorded on the first rows that a run's first
    call checks), judged by the float32 reference as a run is. The faults, planted in
    that control: a Heun step whose second slope weighs ``WRONG_WEIGHT``; a start
    from another row's noise."""
    from benchmark.reference import bpe, edm
    from benchmark.reference.precision import no_tf32

    drv = harness.runner("sample")
    p, dev = cell.params, cell.device
    m = cell.config["model"]
    pool = inputs.captions(os.path.join(harness.BENCH, "traffic", p["captions"]))
    vocab = bpe.write_bpe_vocab(pool, os.path.join(cell.tmpdir, "vocab"),
                                num_merges=p["bpe_merges"])
    prompts = inputs.draw_prompts(cell.seed, 1, pool, p["prompts"])
    seed = inputs.sub_seed(cell.seed, 5, 1)
    rows = drv.check_rows(cell.seed, 1, p["prompts"], p["check_per_call"])[:CONTROL_ROWS]
    runs = {}
    with no_tf32(), torch.no_grad():
        dit, text, vae = drv.reference_models(cell, "fp8")
        ids = bpe.CLIPBPETokenizer(vocab)([prompts[r] for r in rows])["input_ids"]
        y = text(torch.from_numpy(ids).to(dev))
        shape = (p["prompts"], m["in_channels"], m["latent_res"], m["latent_res"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn(shape, generator=gen, device=dev)[rows]
        for label, weight in (("control", 0.5), ("heun_weight", WRONG_WEIGHT)):
            record = []
            final = edm.heun_sample(dit, noise, y, p["steps"], p["guidance"], record, weight)
            runs[label] = (record, vae.decode_images(final).cpu().numpy())
        del dit, text, vae
    _free()

    def items(label, shift=0):
        record, images = runs[label]
        return [{"prompt": prompts[r], "seed": seed, "row": (r + shift) % p["prompts"],
                 "xs": [x[j] for x, _ in record], "ds": [d[j] for _, d in record],
                 "image": images[j]} for j, r in enumerate(rows)]
    nums = drv.reference_check(cell, vocab, items("control"))
    heun = drv.trajectory_numbers(cell, items("heun_weight"))[0]["heun"]
    start = drv.trajectory_numbers(cell, items("control", 1))[0]["start"]
    return {"control": {k: nums[k] for k in ("denoise", "decode")},
            "heun_weight": {"heun": heun}, "start_row": {"start": start}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kind = harness.traffic(harness.workload(args.workload)["traffic"])["kind"]
    lower, upper = {}, {}
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="microdit-calibrate-")
        try:
            cell = _cell(args.workload, seed, tmp, args.device)
            out = harness.runner(kind).run(cell)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        nums = {**{k: c["value"] for k, c in out["checks"].items()}, **out["readings"]}
        print(json.dumps({"seed": seed, "program": nums, "e2e": out["e2e"]}), flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), v)
        del out
        _free()
    for seed in args.control_seeds:
        tmp = tempfile.mkdtemp(prefix="microdit-calibrate-")
        try:
            cell = _cell(args.workload, seed, tmp, args.device)
            got = control_train(cell) if kind == "train" else control_sample(cell)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"seed": seed, **got}), flush=True)
        for label, nums in got.items():
            for k, v in nums.items():
                upper.setdefault(k, {})[label] = min(upper.get(k, {}).get(label, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
